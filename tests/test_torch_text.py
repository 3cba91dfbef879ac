"""The port's ``text`` against the JAX package, on the CPU: the WordPiece
tokenizer (native against Python, goldens, a fuzz run, duplicate
vocabulary entries, control characters, no silent Python path),
``viterbi_decode`` / ``ViterbiDecoder`` (a brute force, and the
reference's paths exactly on random, tied and ragged inputs with
``include_bos_eos_tag`` both ways) and the text datasets (real-file
parsers, and every synthetic corpus sample for sample).
"""
import itertools
import os
import tarfile

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.text.tokenizer import FullTokenizer as RefTokenizer
from paddle_tpu_torch import runtime
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.text.tokenizer import FullTokenizer, _basic_tokenize
from paddle_tpu_torch.text.viterbi import viterbi_decode


@pytest.fixture(autouse=True)
def _cpu():
    prev = core._state.expected_place
    pt.set_device("cpu")
    yield
    core._state.expected_place = prev


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown",
         "fox", "jump", "##s", "##ed", "##ing", "over", "lazy", "dog",
         "un", "##aff", "##able", ",", ".", "!", "a", "b", "c",
         "caf", "##é", "中", "文", "été"]


@pytest.fixture()
def vocab_file(tmp_path):
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(p)


# -- tokenizer ---------------------------------------------------------------

def test_golden_tokenization(vocab_file):
    tok = FullTokenizer(vocab_file, use_native=False)
    assert tok.tokenize("The quick brown fox jumps!") == \
        ["the", "quick", "brown", "fox", "jump", "##s", "!"]
    assert tok.tokenize("unaffable") == ["un", "##aff", "##able"]
    assert tok.tokenize("zzz") == ["[UNK]"]
    assert tok.tokenize("fox,dog.") == ["fox", ",", "dog", "."]
    assert _basic_tokenize("A,b  c", True) == ["a", ",", "b", "c"]


def test_case_handling(vocab_file):
    lower = FullTokenizer(vocab_file, do_lower_case=True, use_native=False)
    keep = FullTokenizer(vocab_file, do_lower_case=False, use_native=False)
    assert lower.encode("THE") == [VOCAB.index("the")]
    assert keep.encode("THE") == [VOCAB.index("[UNK]")]
    nat = FullTokenizer(vocab_file, do_lower_case=False)
    assert nat.encode("THE the") == keep.encode("THE the")


def test_native_matches_python_and_reference(vocab_file):
    """The native path (the default), the Python path and the reference's
    Python path give the same ids."""
    nat = FullTokenizer(vocab_file)
    assert nat._native is not None
    py = FullTokenizer(vocab_file, use_native=False)
    ref = RefTokenizer(vocab_file, use_native=False)
    texts = ["The quick brown fox jumps over the lazy dog!",
             "unaffable, unaffable. jumping jumped", "a b c abc cab", "",
             "  spaced   out  ", "punct!!!...,,", "mixed CASE Words",
             "café été 中文 CAFÉ",
             "naïve\tfox\r\ndog\x00the"]
    for s in texts:
        assert nat.encode(s) == py.encode(s) == ref.encode(s), repr(s)


def test_native_fuzz_parity(vocab_file):
    nat = FullTokenizer(vocab_file, use_native=True)
    py = FullTokenizer(vocab_file, use_native=False)
    ref = RefTokenizer(vocab_file, use_native=False)
    rng = np.random.RandomState(0)
    alphabet = (list("abc theniqus.,!ZQ ")
                + ["\x1c", "\x1d", "\x1f", "\t", "\n", "é", "中",
                   "É", "\x7f", "\x01"])
    for _ in range(200):
        s = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
        assert nat.encode(s) == py.encode(s) == ref.encode(s), repr(s)


def test_duplicate_vocab_last_wins(tmp_path):
    p = tmp_path / "dup.txt"
    p.write_text("[UNK]\na\nb\na\n", encoding="utf-8")
    assert FullTokenizer(str(p), use_native=False).encode("a") == [3]
    assert FullTokenizer(str(p)).encode("a") == [3]
    assert RefTokenizer(str(p), use_native=False).encode("a") == [3]


def test_control_char_whitespace_parity(vocab_file):
    nat = FullTokenizer(vocab_file)
    py = FullTokenizer(vocab_file, use_native=False)
    for s in ("a\x1cb", "fox\x1ddog", "the\x1equick", "a\x1fb", "a\x0bb",
              "a\x0cb"):
        assert nat.encode(s) == py.encode(s), repr(s)


def test_ids_roundtrip(vocab_file):
    tok = FullTokenizer(vocab_file, use_native=False)
    toks = tok.tokenize("the quick fox")
    ids = tok.convert_tokens_to_ids(toks)
    assert tok.convert_ids_to_tokens(ids) == toks
    assert tok.convert_tokens_to_ids(["nope"]) == [VOCAB.index("[UNK]")]


@pytest.mark.parametrize("use_native", [None, True])
def test_native_path_raises_without_the_library(vocab_file, monkeypatch,
                                                use_native):
    """``use_native`` None (the default) and True take the native path and
    raise when the library cannot be built; only False is Python."""
    def broken():
        raise RuntimeError("native runtime unavailable: no compiler")
    monkeypatch.setattr(runtime, "_load", broken)
    with pytest.raises(RuntimeError, match="no compiler"):
        FullTokenizer(vocab_file, use_native=use_native)
    assert FullTokenizer(vocab_file, use_native=False).encode("fox") == [7]


def test_long_text_fills_the_buffer(vocab_file):
    """The reference's buffer sizing: a text of single-character pieces
    (the most ids a byte can give) comes back whole."""
    nat = FullTokenizer(vocab_file)
    s = ",." * 5000
    assert nat.encode(s) == FullTokenizer(
        vocab_file, use_native=False).encode(s)
    assert len(nat.encode(s)) == 10000


# -- viterbi -----------------------------------------------------------------

def _brute(em, tr, L, bos_eos):
    N = em.shape[-1]
    best, path = -1e30, None
    for tags in itertools.product(range(N), repeat=int(L)):
        s = em[0, tags[0]]
        if bos_eos:
            s += tr[N - 2, tags[0]]
        for t in range(1, L):
            s += tr[tags[t - 1], tags[t]] + em[t, tags[t]]
        if bos_eos:
            s += tr[tags[L - 1], N - 1]
        if s > best:
            best, path = s, tags
    return best, list(path)


@pytest.mark.parametrize("bos_eos", [False, True])
def test_viterbi_lengths_and_bos_eos_brute_force(bos_eos):
    rng = np.random.RandomState(0)
    B, T, N = 3, 5, 5
    em = rng.randn(B, T, N).astype(np.float32)
    tr = rng.randn(N, N).astype(np.float32)
    lens = np.asarray([5, 3, 1], np.int32)
    sc, pa = viterbi_decode(pt.to_tensor(em), pt.to_tensor(tr),
                            pt.to_tensor(lens), bos_eos)
    assert pa.dtype == pt.int32
    sc, pa = sc.numpy(), pa.numpy()
    for b in range(B):
        ws, wp = _brute(em[b], tr, lens[b], bos_eos)
        assert abs(sc[b] - ws) < 1e-4
        assert list(pa[b]) == wp + [0] * (T - lens[b])


def _viterbi_inputs(kind, seed, B=6, T=9, N=7):
    rng = np.random.RandomState(seed)
    if kind == "ties":
        # integer emissions and transitions: equal sums are common
        em = rng.randint(-2, 3, (B, T, N)).astype(np.float32)
        tr = rng.randint(-1, 2, (N, N)).astype(np.float32)
    else:
        em = rng.randn(B, T, N).astype(np.float32)
        tr = rng.randn(N, N).astype(np.float32)
    lens = rng.randint(1, T + 1, B).astype(np.int64)
    lens[0], lens[-1] = T, 1
    return em, tr, lens


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("bos_eos", [False, True])
def test_viterbi_matches_reference(kind, bos_eos):
    """Paths exact and scores within 1e-6 of the JAX reference on ragged
    lengths; on tied inputs the first maximal index wins on both."""
    from paddle_tpu.text.viterbi import viterbi_decode as ref_decode
    for seed in range(3):
        em, tr, lens = _viterbi_inputs(kind, seed)
        sc, pa = viterbi_decode(pt.to_tensor(em), pt.to_tensor(tr),
                                pt.to_tensor(lens), bos_eos)
        rs, rp = ref_decode(P.to_tensor(em), P.to_tensor(tr),
                            P.to_tensor(lens), bos_eos)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(rp.numpy()))
        assert pa.numpy().dtype == np.int32
        np.testing.assert_allclose(sc.numpy(), np.asarray(rs.numpy()),
                                   rtol=1e-6, atol=1e-6)
        for b in range(len(lens)):
            assert (pa.numpy()[b, lens[b]:] == 0).all()


def test_viterbi_decoder_default_lengths_and_one_step():
    """``ViterbiDecoder`` with no lengths (every row T long) and T = 1,
    against the reference's."""
    from paddle_tpu.text.viterbi import ViterbiDecoder as RefDecoder
    em, tr, _ = _viterbi_inputs("random", 7)
    for e in (em, em[:, :1]):
        got = pt.text.ViterbiDecoder(pt.to_tensor(tr), False)(
            pt.to_tensor(e))
        want = RefDecoder(P.to_tensor(tr), False)(P.to_tensor(e))
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.asarray(want[1].numpy()))
        np.testing.assert_allclose(got[0].numpy(),
                                   np.asarray(want[0].numpy()), rtol=1e-6)


def test_viterbi_score_gradient_matches_reference():
    """The score is differentiable in the emissions and transitions, as
    the reference's (``lengths`` is not)."""
    from paddle_tpu.text.viterbi import viterbi_decode as ref_decode
    em, tr, lens = _viterbi_inputs("random", 11, B=3, T=5, N=4)
    grads = []
    for lib, dec in ((pt, viterbi_decode), (P, ref_decode)):
        e = lib.to_tensor(em, stop_gradient=False)
        t = lib.to_tensor(tr, stop_gradient=False)
        sc, _ = dec(e, t, lib.to_tensor(lens), True)
        sc.sum().backward()
        grads.append((np.asarray(e.grad.numpy()), np.asarray(t.grad.numpy())))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# -- datasets ----------------------------------------------------------------

def test_uci_housing_parses_real_table(tmp_path):
    rng = np.random.RandomState(0)
    table = rng.rand(50, 14).astype(np.float32) * 10
    path = str(tmp_path / "housing.data")
    np.savetxt(path, table, fmt="%.4f")
    ds = pt.text.datasets.UCIHousing(data_file=path, mode="train")
    ref = P.text.datasets.UCIHousing(data_file=path, mode="train")
    assert len(ds) == len(ref) == 40
    x, y = ds[0]
    assert x.shape == (13,) and y.shape == (1,)
    np.testing.assert_allclose(float(y[0]), table[0, 13], rtol=1e-4)
    for i in range(len(ds)):
        for a, b in zip(ds[i], ref[i]):
            np.testing.assert_array_equal(a, b)
    assert len(pt.text.datasets.UCIHousing(data_file=path,
                                           mode="test")) == 10


def test_imdb_parses_real_archive(tmp_path):
    reviews = {
        ("train", "pos"): ["great great movie", "great fun"],
        ("train", "neg"): ["terrible terrible film", "awful terrible"],
        ("test", "pos"): ["great film"],
        ("test", "neg"): ["awful movie"],
    }
    archive = str(tmp_path / "aclImdb_v1.tar.gz")
    with tarfile.open(archive, "w:gz") as tf:
        for (split, lab), docs in reviews.items():
            for i, text in enumerate(docs):
                p = tmp_path / f"{split}_{lab}_{i}.txt"
                p.write_text(text)
                tf.add(str(p), arcname=f"aclImdb/{split}/{lab}/{i}_7.txt")
    ds = pt.text.datasets.Imdb(data_file=archive, mode="train", cutoff=2)
    assert len(ds) == 4
    assert set(ds.word_idx) == {"great", "terrible"}
    assert sorted(int(lab) for _, lab in [ds[i] for i in range(4)]) == \
        [0, 0, 1, 1]
    test = pt.text.datasets.Imdb(data_file=archive, mode="test", cutoff=2)
    ref = P.text.datasets.Imdb(data_file=archive, mode="test", cutoff=2)
    assert len(test) == 2 and test.word_idx == ref.word_idx
    for i in range(2):
        for a, b in zip(test[i], ref[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["UCIHousing", "Imdb", "Imikolov",
                                  "Movielens", "Conll05st", "WMT14",
                                  "WMT16"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_corpus_equals_reference(name, mode):
    """The synthetic corpora draw from ``np.random.RandomState``: every
    sample equals the reference's, dtype included."""
    got = getattr(pt.text.datasets, name)(mode=mode)
    want = getattr(P.text.datasets, name)(mode=mode)
    assert len(got) == len(want) > 0
    assert isinstance(got, pt.io.Dataset)
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
