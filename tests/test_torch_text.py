"""The port's copies of the framework-free host code against the originals:
tokenizer, hashing, vocabulary, native query encoding and the config
defaults. All comparisons are exact."""

import dataclasses
import importlib
import os
import tempfile

import numpy as np
import pytest

os.environ.setdefault(
    "RAG_UQ_TPU_TORCH_BUILD_DIR", os.path.join(tempfile.gettempdir(), "rag_uq_tpu_torch_build")
)

from rag_uq_tpu.core import config as jax_config  # noqa: E402
from rag_uq_tpu.core import types as jax_types  # noqa: E402
from rag_uq_tpu.index.sparse import BM25Index as JaxBM25Index  # noqa: E402
from rag_uq_tpu_torch.core import config as torch_config  # noqa: E402
from rag_uq_tpu_torch.core import types as torch_types  # noqa: E402
from rag_uq_tpu_torch.index.sparse import BM25Index  # noqa: E402
from rag_uq_tpu_torch.text import tokenize as torch_tok  # noqa: E402

from tests.oracles import make_synthetic_corpus  # noqa: E402

# rag_uq_tpu.text re-exports the function `tokenize` under the module's name.
jax_tok = importlib.import_module("rag_uq_tpu.text.tokenize")

TEXTS = [
    "Hello, World! hello",
    "...remains Guschisshous.",
    "it's a multi-word test -- (really) ?!",
    "Ünïcödé ÉTÉ «quoted» naïve",
    "tabs\tand\nnewlines  and\r\nCRLF",
    "",
    "   ",
    "123 4.5 -6 7e8",
]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenize_and_hash_match(text):
    toks = torch_tok.tokenize(text)
    assert toks == jax_tok.tokenize(text)
    assert [torch_tok.fnv1a_64(t) for t in toks] == [jax_tok.fnv1a_64(t) for t in toks]
    np.testing.assert_array_equal(
        torch_tok.hash_tokens(toks, 1 << 18), jax_tok.hash_tokens(toks, 1 << 18)
    )


def test_tokenizer_version_matches():
    assert torch_tok.TOKENIZER_VERSION == jax_tok.TOKENIZER_VERSION


def test_vocab_matches():
    toks = [t for text in TEXTS for t in torch_tok.tokenize(text)]
    a, b = torch_tok.Vocab(), jax_tok.Vocab()
    assert [a.add(t) for t in toks] == [b.add(t) for t in toks]
    assert len(a) == len(b)
    probe = toks + ["unseen"]
    np.testing.assert_array_equal(a.encode(probe), b.encode(probe))


@pytest.mark.parametrize("use_native", ["auto", "never"])
def test_index_ids_and_query_encoding_match(use_native):
    corpus = make_synthetic_corpus(np.random.default_rng(3), 80) + TEXTS
    docs = [torch_types.Document(str(i), t) for i, t in enumerate(corpus)]
    ours = BM25Index(use_native=use_native, device="cpu")
    ours.add_documents(docs)
    ref = JaxBM25Index(use_native=use_native)
    ref.add_documents([jax_types.Document(d.id, d.text) for d in docs])
    if use_native == "auto":
        assert ours.uses_native and ref._native is not None
    n = ref._n_postings
    assert ours._n_postings == n
    assert ours.vocab._terms == ref.vocab._terms
    assert ours.doc_lens == ref.doc_lens
    for name in ("_tid", "_doc", "_tf"):
        np.testing.assert_array_equal(getattr(ours, name)[:n], getattr(ref, name)[:n])
    queries = ["w1 w2 the", "W3, w4! unknownterm", "", "the the the is a of w5"] + TEXTS
    np.testing.assert_array_equal(ours.encode_queries(queries), ref.encode_queries(queries))


CONFIGS = ["RouterConfig", "BM25Config", "DenseIndexConfig", "EmbedderConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_defaults_match(name):
    ours = dataclasses.asdict(getattr(torch_config, name)())
    ref = dataclasses.asdict(getattr(jax_config, name)())
    assert ours == ref


def test_router_recipe_v2_matches():
    assert dataclasses.asdict(torch_config.router_recipe_v2()) == dataclasses.asdict(
        jax_config.router_recipe_v2()
    )


def test_doc_store_matches():
    docs = [("a", "x", "T", {"k": 1}), ("b", "y", None, None)]
    ours, ref = torch_types.DocStore(), jax_types.DocStore()
    for args in docs:
        assert ours.append(torch_types.Document(*args)) == ref.append(jax_types.Document(*args))
    assert ours.get("a").to_dict() == ref.get("a").to_dict()
    assert ours.position("b") == ref.position("b") == 1
    assert "c" not in ours and len(ours) == len(ref) == 2
    assert torch_types.Document.from_dict(ref.get("a").to_dict()) == ours.get("a")
