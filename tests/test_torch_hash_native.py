"""The hashing embedder's features from the native library
(``native/binding.py::hash_features``) against the JAX package's Python
hashing, and against the port's own Python twin with the library made
unavailable. All comparisons are exact: the ids are the same integers.

The cases cover FiQA-shaped decimal queries, edge punctuation, empty texts,
texts around ``max_len`` features, a bucket count that is not a power of
two, and non-ASCII text: every code point Python's ``str.split()`` splits
on, ``İ`` (which lowercases to two code points), ``ß``, CJK and emoji.
"""

import importlib
import os
import random
import tempfile

import numpy as np
import pytest

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.embed.hash_embed import NgramHashEmbedder as JaxEmbedder  # noqa: E402
from rag_uq_tpu_torch.embed.hash_embed import NgramHashEmbedder  # noqa: E402
from rag_uq_tpu_torch.native import binding  # noqa: E402
from rag_uq_tpu_torch.text import tokenize as torch_tok  # noqa: E402

# rag_uq_tpu.text re-exports the function `tokenize` under the module's name.
jax_tok = importlib.import_module("rag_uq_tpu.text.tokenize")

# Every code point for which str.isspace() holds, which is where str.split() splits.
UNICODE_SPACES = [chr(c) for c in range(0x110000) if chr(c).isspace()]

_rng = random.Random(17)
_ALPHABET = list("abcXYZ0189.,;:!?-'\"()[]$%") + UNICODE_SPACES + [
    "İ", "ß", "ﬁ", "中文", "😀", "é", "​", "́", "\x00", "\x7f"]

CASES = {
    "fiqa_decimal": [
        "what is the 401(k) contribution limit for 2019?",
        "how much tax do i pay on a $1,500.00 bonus",
        "is 3.5% apr on a 30-year mortgage a good rate",
        "can i deduct 0.25 of my home office expenses as a sole proprietor",
        "S&P 500 index fund vs. total market fund -- which is better?",
        "what happens to my roth ira if i earn more than $122,000",
    ],
    "edge_punct": [
        "...remains Guschisshous.",
        "!!! ??? ... --- ,,,",
        "(a) [b] {c} <d> 'e' \"f\"",
        "it's a multi-word test -- (really) ?!",
        "-", "'", "a-", "-a", "--a--b--",
    ],
    "empty": ["", " ", "\t\n\r\x0b\x0c", "　 ", "!!!", "... ,"],
    "around_max_len": [" ".join(f"t{j}" for j in range(n)) for n in range(0, 140)]
    + [" ".join(["same"] * 40), " ".join(f"w{j}." for j in range(300))],
    "unicode_space": [f"alpha{s}beta{s}{s}gamma{s}" for s in UNICODE_SPACES]
    + ["x​y", "a\x1cb\x1dc\x1ed\x1fe", "a\u0085b c　d e f"],
    "unicode_text": [
        "İstanbul STRASSE Straße", "中文 分词 测试。", "emoji 😀 test 😀😀 !😀!",
        "naïve café «quoted» Ünïcödé ÉTÉ", "ﬁne ΣΊΣΥΦΟΣ Ǆemal", "\x00nul\x00 del\x7f",
    ],
    "random": ["".join(_rng.choice(_ALPHABET) for _ in range(_rng.randint(0, 200)))
               for _ in range(200)],
}

# (buckets, max_len): the embedder's default geometry; a prime bucket count
# with max_len 8, where 5 tokens give max_len + 1 features with bigrams; 7
# buckets with max_len 9, where 5 tokens give exactly max_len.
GEOMETRIES = {"pow2": (1 << 18, 128), "prime_8": (10007, 8), "seven_9": (7, 9)}


@pytest.fixture
def no_native(monkeypatch):
    """The library made unavailable: callers take the Python twin."""
    monkeypatch.setattr(binding, "_get_lib", lambda: None)
    assert not binding.is_available()


def _equal(a, b):
    assert a[0].dtype == b[0].dtype == np.int32 and a[1].dtype == b[1].dtype == np.int32
    assert a[0].shape == b[0].shape and a[1].shape == b[1].shape
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


def _embedders(geometry, use_bigrams):
    buckets, max_len = GEOMETRIES[geometry]
    ours = NgramHashEmbedder(dim=1, buckets=buckets, max_len=max_len,
                             use_bigrams=use_bigrams, device="cpu")
    ref = JaxEmbedder(dim=1, buckets=buckets, max_len=max_len, use_bigrams=use_bigrams)
    return ours, ref


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("use_bigrams", [True, False], ids=["bigrams", "unigrams"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_embedder_features_equal_jax(case, use_bigrams, geometry):
    assert binding.is_available()
    ours, ref = _embedders(geometry, use_bigrams)
    _equal(ours._hash_batch(CASES[case]), ref._hash_batch(CASES[case]))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_hash_texts_equals_jax(case, geometry):
    assert binding.is_available()
    buckets, max_len = GEOMETRIES[geometry]
    _equal(torch_tok.hash_texts(CASES[case], buckets, max_len),
           jax_tok.hash_texts(CASES[case], buckets, max_len))


@pytest.mark.parametrize("case", sorted(CASES))
def test_python_twin_equals_native(case, monkeypatch):
    texts = CASES[case]
    for geometry in sorted(GEOMETRIES):
        buckets, max_len = GEOMETRIES[geometry]
        native = {big: binding.hash_features(texts, buckets, max_len, big)
                  for big in (True, False)}
        with monkeypatch.context() as m:
            m.setattr(binding, "_get_lib", lambda: None)
            assert not binding.is_available()
            for big in (True, False):
                ours, _ = _embedders(geometry, big)
                _equal(ours._hash_batch(texts), native[big])
            _equal(torch_tok.hash_texts(texts, buckets, max_len), native[False])


def test_hash_features_raises_without_the_library(no_native):
    with pytest.raises(RuntimeError, match="unavailable"):
        binding.hash_features(["a"], 8, 4, True)


@pytest.mark.parametrize("buckets,max_len", [(0, 4), (-3, 4), ((1 << 31) + 1, 4), (8, -1)])
def test_hash_features_refuses_sizes_out_of_range(buckets, max_len):
    with pytest.raises(ValueError):
        binding.hash_features(["a b"], buckets, max_len, True)


def test_hash_features_of_no_texts_and_of_a_zero_max_len():
    ids, lengths = binding.hash_features([], 64, 8, True)
    assert ids.shape == (0, 8) and lengths.shape == (0,)
    ids, lengths = binding.hash_features(("a b", ""), 64, 0, True)
    assert ids.shape == (2, 0) and lengths.tolist() == [0, 0]
