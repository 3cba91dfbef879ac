"""The port's copy of the page allocator is the JAX package's code.

``paddle_tpu_torch/inference/kv_pager.py`` is a copy of
``paddle_tpu/inference/kv_pager.py`` (the port imports nothing of the JAX
package), and its header says its code is unchanged.  Both files are
compared as token streams with comments and docstrings stripped: they
must be equal.
"""
import io
import os
import tokenize

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKIP = {tokenize.COMMENT, tokenize.NL, tokenize.ENCODING}


def code_tokens(path):
    """(type, string) of every token but comments, blank lines and
    string statements (docstrings), with the newline ending each."""
    with open(path, "rb") as f:
        toks = [t for t in tokenize.tokenize(io.BytesIO(f.read()).readline)
                if t.type not in SKIP]
    out, i = [], 0
    while i < len(toks):
        t = toks[i]
        prev = out[-1][0] if out else tokenize.NEWLINE
        nxt = toks[i + 1].type if i + 1 < len(toks) else tokenize.ENDMARKER
        if (t.type == tokenize.STRING and nxt == tokenize.NEWLINE
                and prev in (tokenize.NEWLINE, tokenize.INDENT,
                             tokenize.DEDENT)):
            i += 2                  # the string statement and its newline
            continue
        out.append((t.type, t.string))
        i += 1
    return out


def test_port_copy_of_the_pager_is_the_reference_code():
    port = os.path.join(ROOT, "paddle_tpu_torch", "inference", "kv_pager.py")
    ref = os.path.join(ROOT, "paddle_tpu", "inference", "kv_pager.py")
    with open(port) as f:
        assert "code unchanged" in f.readline()
    got, want = code_tokens(port), code_tokens(ref)
    assert len(got) > 1000
    assert got == want


def test_the_comparison_sees_code_and_not_comments(tmp_path):
    a, b, c = (tmp_path / n for n in ("a.py", "b.py", "c.py"))
    a.write_text('"""doc"""\ndef f(x):\n    """one"""\n    return x  # c\n')
    b.write_text('# header\ndef f(x):\n\n    return x\n')
    c.write_text('def f(x):\n    return x + 1\n')
    assert code_tokens(a) == code_tokens(b) != code_tokens(c)


def test_port_copy_of_the_synthetic_mnist_is_the_reference_code():
    """``paddle_tpu_torch/vision/datasets/mnist.py`` (the idx parser and
    the synthetic surrogate) is a copy of the JAX package's, code
    unchanged, as its header says."""
    port = os.path.join(ROOT, "paddle_tpu_torch", "vision", "datasets",
                        "mnist.py")
    ref = os.path.join(ROOT, "paddle_tpu", "vision", "datasets", "mnist.py")
    with open(port) as f:
        assert "code unchanged" in f.readline()
    got, want = code_tokens(port), code_tokens(ref)
    assert len(got) > 300
    assert got == want


def test_port_copy_of_ps_compat_is_the_reference_code():
    """``paddle_tpu_torch/distributed/ps_compat.py`` (the MultiSlot
    generators and datasets, host only) is a copy of the JAX package's,
    code unchanged, as its header says; it imports numpy and the stdlib
    only."""
    port = os.path.join(ROOT, "paddle_tpu_torch", "distributed",
                        "ps_compat.py")
    ref = os.path.join(ROOT, "paddle_tpu", "distributed", "ps_compat.py")
    with open(port) as f:
        assert "code unchanged" in f.readline()
    got, want = code_tokens(port), code_tokens(ref)
    assert len(got) > 1000
    assert got == want
    imported = {s for i, (t, s) in enumerate(got[:-1])
                if got[i - 1][1] == "import" and t == tokenize.NAME}
    assert imported <= {"annotations", "os", "sys", "numpy", "subprocess"}


@pytest.mark.parametrize("rel,size", [
    ("vision/mask_labels.py", 1500),
    ("vision/transforms/functional.py", 900),
    ("vision/transforms/transforms.py", 1200),
    ("vision/datasets/cifar.py", 400),
    ("vision/datasets/flowers.py", 100),
    ("vision/datasets/folder.py", 350),
    ("vision/datasets/voc2012.py", 100)])
def test_port_copy_of_host_vision_module_is_the_reference_code(rel, size):
    """The host-side numpy modules of ``vision/`` (Mask R-CNN's mask
    targets, the transforms, the datasets) are copies of the JAX
    package's, code unchanged, as their headers say; they import neither
    JAX nor the JAX package (their own imports are relative)."""
    port = os.path.join(ROOT, "paddle_tpu_torch", *rel.split("/"))
    ref = os.path.join(ROOT, "paddle_tpu", *rel.split("/"))
    with open(port) as f:
        assert "code unchanged" in f.readline()
    got, want = code_tokens(port), code_tokens(ref)
    assert len(got) > size
    assert got == want
    imported = {s for i, (t, s) in enumerate(got[:-1])
                if got[i - 1][1] in ("import", "from") and t == tokenize.NAME}
    assert not imported & {"jax", "jaxlib", "paddle_tpu"}, imported


@pytest.mark.parametrize("rel,size", [
    ("reader/__init__.py", 900),
    ("hub.py", 200),
    ("compat.py", 350),
    ("version.py", 30),
    ("utils/unique_name.py", 150),
    ("utils/lazy.py", 150),
    ("text/__init__.py", 20),
    ("text/datasets.py", 1000),
    ("dataset/__init__.py", 20),
    ("dataset/mnist.py", 150),
    ("dataset/cifar.py", 100),
    ("dataset/uci_housing.py", 60),
    ("dataset/imdb.py", 100)])
def test_port_copy_of_host_module_is_the_reference_code(rel, size):
    """The host-side modules of the package's rest (the reader decorators,
    ``hub``, ``compat``, ``version``, ``utils.unique_name`` and
    ``utils.lazy``, the text datasets, the ``dataset`` reader creators)
    are copies of the JAX package's, code unchanged, as their headers
    say; their imports are the stdlib, numpy and relative ones."""
    port = os.path.join(ROOT, "paddle_tpu_torch", *rel.split("/"))
    ref = os.path.join(ROOT, "paddle_tpu", *rel.split("/"))
    with open(port) as f:
        assert "code unchanged" in f.readline()
    got, want = code_tokens(port), code_tokens(ref)
    assert len(got) > size
    assert got == want
    imported = {s for i, (t, s) in enumerate(got[:-1])
                if got[i - 1][1] in ("import", "from") and t == tokenize.NAME}
    assert not imported & {"jax", "jaxlib", "paddle_tpu"}, imported
