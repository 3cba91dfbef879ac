"""BERT/ERNIE WordPiece tokenization (counterpart of
``paddle_tpu/text/tokenizer.py``; ref: the reference model line's
tokenization.py -- basic tokenize + greedy longest-match wordpiece).

The hot path is native: ``runtime/csrc/ptpu_runtime.cc`` implements the
algorithm in C++ (one call per text, the GIL released by ctypes).  The
pure-Python implementation below is the parity oracle, and runs only when
the caller asks for it with ``use_native=False``: ``use_native=None`` (the
default) and ``True`` take the native path and raise when the library
cannot be built.  The reference's ``None`` takes the Python path quietly
when the library is missing; the port has no such fallback.
"""
from __future__ import annotations

import ctypes

__all__ = ["FullTokenizer", "WordpieceTokenizer", "load_vocab"]


def load_vocab(vocab_file):
    """newline-separated vocab; line index = id (reference format; the
    last of duplicate entries wins)."""
    vocab = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\r\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_punct(ch):
    cp = ord(ch)
    return ((33 <= cp <= 47) or (58 <= cp <= 64)
            or (91 <= cp <= 96) or (123 <= cp <= 126))


def _basic_tokenize(text, do_lower_case):
    """Whitespace split + ASCII punctuation isolation (as the native
    implementation: non-ASCII passes through opaquely)."""
    out = []
    word = []
    for ch in text:
        if ord(ch) < 128:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
                continue
            if _is_punct(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
                continue
            word.append(ch.lower() if do_lower_case else ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class WordpieceTokenizer:
    def __init__(self, vocab, unk_token="[UNK]", cont_prefix="##"):
        self.vocab = vocab
        self.unk_id = vocab.get(unk_token, 0)
        self.cont = cont_prefix

    def tokenize_word(self, word):
        """Greedy longest-match; whole word -> [UNK] if any piece fails."""
        ids = []
        start = 0
        while start < len(word):
            end = len(word)
            found = None
            while end > start:
                sub = word[start:end]
                if start > 0:
                    sub = self.cont + sub
                if sub in self.vocab:
                    found = (self.vocab[sub], end)
                    break
                end -= 1
            if found is None:
                return [self.unk_id]
            ids.append(found[0])
            start = found[1]
        return ids


class FullTokenizer:
    """Basic + wordpiece.  ``use_native``: None or True, the native
    library (built at first use; raises ``RuntimeError`` when it cannot
    be built); False, the Python implementation."""

    def __init__(self, vocab_file, do_lower_case=True, unk_token="[UNK]",
                 use_native=None):
        self.vocab = load_vocab(vocab_file)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self._wp = WordpieceTokenizer(self.vocab, unk_token)
        self._native = None
        if use_native is not False:
            self._native = self._init_native(vocab_file, unk_token)

    def _init_native(self, vocab_file, unk_token):
        from .. import runtime
        lib = runtime._load()
        with open(vocab_file, "rb") as f:
            data = f.read()
        h = lib.ptpu_wp_create(data, len(data), unk_token.encode())
        if h <= 0:
            raise RuntimeError(f"ptpu_wp_create failed (handle {h})")
        return (lib, h)

    def __del__(self):
        if getattr(self, "_native", None):
            lib, h = self._native
            try:
                lib.ptpu_wp_destroy(h)
            except Exception:       # interpreter teardown
                pass

    def encode(self, text):
        """text -> list of wordpiece ids."""
        if self._native is not None:
            lib, h = self._native
            raw = text.encode("utf-8")
            cap = max(64, 2 * len(raw) + 8)
            buf = (ctypes.c_int32 * cap)()
            n = lib.ptpu_wp_encode(h, raw, len(raw),
                                   1 if self.do_lower_case else 0, buf, cap)
            if n < 0:
                raise RuntimeError(f"ptpu_wp_encode failed (rc {n})")
            n = min(n, cap)
            return list(buf[:n])
        ids = []
        for w in _basic_tokenize(text, self.do_lower_case):
            ids.extend(self._wp.tokenize_word(w))
        return ids

    def tokenize(self, text):
        return [self.inv_vocab.get(i, "[UNK]") for i in self.encode(text)]

    def convert_tokens_to_ids(self, tokens):
        unk = self._wp.unk_id
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        return [self.inv_vocab.get(int(i), "[UNK]") for i in ids]
