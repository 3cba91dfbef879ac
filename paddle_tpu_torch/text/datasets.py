# Copied from paddle_tpu/text/datasets.py (numpy-only parsers and synthetic corpora over the port's io.Dataset), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""Text datasets (ref: python/paddle/text/datasets/*).

Real on-disk formats parse when ``data_file`` is given and exists
(UCIHousing: whitespace table; Imdb: aclImdb tar.gz of per-review text
files) — the reference's exact layouts.
Zero-egress environment: absent files fall back to deterministic
synthetic data with the reference-matching schema."""
from __future__ import annotations

import os
import re
import tarfile

import numpy as np

from ..io.dataset import Dataset


def parse_uci_housing(path):
    """Whitespace-separated rows of 14 floats; last column is the price
    (the reference normalizes features to zero-mean/unit-range; we keep
    raw features + per-feature max-min scaling like ref uci_housing)."""
    table = np.loadtxt(path, dtype=np.float32)
    if table.ndim != 2 or table.shape[1] != 14:
        raise ValueError(f"{path}: expected Nx14 housing table, got "
                         f"{table.shape}")
    x, y = table[:, :13], table[:, 13:]
    span = np.maximum(x.max(0) - x.min(0), 1e-6)
    x = (x - x.mean(0)) / span
    return x.astype(np.float32), y.astype(np.float32)


_TOKEN_RE = re.compile(r"[a-z0-9']+")


def parse_imdb_archive(path, mode, cutoff=150):
    """aclImdb tar.gz: members aclImdb/<mode>/{pos,neg}/*.txt; vocabulary
    from the train split with frequency cutoff (ref text/datasets/imdb.py
    build_vocab); returns (samples [(ids, label)], word_idx)."""
    freq = {}
    docs = {"train": [], "test": []}
    with tarfile.open(path, "r:*") as tf:
        for member in tf.getmembers():
            parts = member.name.split("/")
            if len(parts) != 4 or parts[2] not in ("pos", "neg") \
                    or not member.isfile():
                continue
            split, label = parts[1], parts[2]
            if split not in docs:
                continue
            if mode == "train" and split == "test":
                continue    # test reviews are never needed for train
            text = tf.extractfile(member).read().decode("utf-8", "ignore")
            toks = _TOKEN_RE.findall(text.lower())
            docs[split].append((toks, 1 if label == "pos" else 0))
            if split == "train":
                for t in toks:
                    freq[t] = freq.get(t, 0) + 1
    vocab = sorted((w for w, c in freq.items() if c >= cutoff),
                   key=lambda w: (-freq[w], w))
    word_idx = {w: i for i, w in enumerate(vocab)}
    unk = len(word_idx)
    samples = [
        (np.asarray([word_idx.get(t, unk) for t in toks], np.int64),
         np.int64(label))
        for toks, label in docs["train" if mode == "train" else "test"]]
    return samples, word_idx


class _Synthetic(Dataset):
    n = 1024
    seed = 0

    def __init__(self, mode="train", **kwargs):
        self.mode = mode
        self.rng = np.random.RandomState(self.seed + (0 if mode == "train"
                                                      else 1))
        self._build()

    def _build(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]


class UCIHousing(_Synthetic):
    """13 features -> price (ref: text/datasets/uci_housing.py)."""

    def __init__(self, data_file=None, mode="train", **kwargs):
        self._data_file = data_file
        super().__init__(mode, **kwargs)

    def _build(self):
        if self._data_file and os.path.exists(self._data_file):
            x, y = parse_uci_housing(self._data_file)
            split = int(len(x) * 0.8)
            sl = slice(0, split) if self.mode == "train" \
                else slice(split, None)
            self.data = list(zip(x[sl], y[sl]))
            return
        x = self.rng.randn(self.n, 13).astype(np.float32)
        w = self.rng.randn(13).astype(np.float32)
        y = (x @ w + 0.1 * self.rng.randn(self.n)).astype(np.float32)
        self.data = [(x[i], y[i:i + 1]) for i in range(self.n)]


class Imdb(_Synthetic):
    """token ids + binary sentiment label (ref: text/datasets/imdb.py)."""
    vocab_size = 5147

    def __init__(self, data_file=None, mode="train", cutoff=150, **kwargs):
        self._data_file = data_file
        self._cutoff = cutoff
        super().__init__(mode, **kwargs)

    def _build(self):
        if self._data_file and os.path.exists(self._data_file):
            self.data, self.word_idx = parse_imdb_archive(
                self._data_file, self.mode, self._cutoff)
            self.vocab_size = len(self.word_idx) + 1    # + unk id
            return
        self.word_idx = {f"w{i}": i for i in range(self.vocab_size)}
        self.data = []
        for i in range(self.n):
            L = self.rng.randint(10, 120)
            doc = self.rng.randint(0, self.vocab_size, L).astype(np.int64)
            label = np.int64(self.rng.randint(0, 2))
            self.data.append((doc, label))


class Imikolov(_Synthetic):
    """n-gram LM tuples."""

    def __init__(self, mode="train", data_type="NGRAM", window_size=5,
                 **kwargs):
        self.window_size = window_size
        super().__init__(mode)

    def _build(self):
        V = 2000
        self.data = []
        for i in range(self.n):
            ctx = self.rng.randint(0, V, self.window_size).astype(np.int64)
            self.data.append(tuple(ctx))


class Movielens(_Synthetic):
    def _build(self):
        self.data = []
        for i in range(self.n):
            uid = np.int64(self.rng.randint(1, 6041))
            gender = np.int64(self.rng.randint(0, 2))
            age = np.int64(self.rng.randint(0, 7))
            job = np.int64(self.rng.randint(0, 21))
            mid = np.int64(self.rng.randint(1, 3953))
            rating = np.float32(self.rng.randint(1, 6))
            self.data.append((uid, gender, age, job, mid, rating))


class Conll05st(_Synthetic):
    def _build(self):
        V, L = 5000, 30
        self.data = []
        for i in range(self.n):
            words = self.rng.randint(0, V, L).astype(np.int64)
            preds = self.rng.randint(0, V, L).astype(np.int64)
            labels = self.rng.randint(0, 67, L).astype(np.int64)
            self.data.append((words, preds, labels))


class _WMT(_Synthetic):
    src_vocab = 30000
    tgt_vocab = 30000

    def _build(self):
        self.data = []
        for i in range(self.n):
            ls = self.rng.randint(5, 50)
            lt = self.rng.randint(5, 50)
            src = self.rng.randint(0, self.src_vocab, ls).astype(np.int64)
            tgt = self.rng.randint(0, self.tgt_vocab, lt).astype(np.int64)
            self.data.append((src, tgt[:-1], tgt[1:]))


class WMT14(_WMT):
    pass


class WMT16(_WMT):
    pass
