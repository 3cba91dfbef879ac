# Copied from paddle_tpu/text/__init__.py (the package's exports), code unchanged; the port keeps its own copy so it never imports paddle_tpu.
"""paddle.text (ref: python/paddle/text/): dataset helpers.

The reference ships downloadable corpora (Conll05st, Imdb, Imikolov, Movielens,
UCIHousing, WMT14, WMT16).  Zero-egress environment: each dataset here
generates a deterministic synthetic corpus with the same schema so training
pipelines exercise identically.
"""
from .datasets import (UCIHousing, Imdb, Imikolov, Movielens, Conll05st,
                       WMT14, WMT16)
from .viterbi import viterbi_decode, ViterbiDecoder
from .tokenizer import FullTokenizer, WordpieceTokenizer, load_vocab  # noqa
