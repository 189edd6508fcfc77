"""The port's copies of the JAX package's numpy data code, held to the
originals: the synthetic wikipedia world, the JSONL loaders and writers,
the chunker, the synthetic router data and the router's pseudo-labels.
Each copy must give exactly what the original gives."""

import json

import numpy as np
import pytest

from rag_uq_tpu.core.config import ChunkConfig as JaxChunkConfig
from rag_uq_tpu.core.config import TrainConfig as JaxTrainConfig
from rag_uq_tpu.data import chunk as jax_chunk
from rag_uq_tpu.data import loaders as jax_loaders
from rag_uq_tpu.data import synth_wiki as jax_wiki
from rag_uq_tpu.router import labels as jax_labels
from rag_uq_tpu_torch.core.config import ChunkConfig, TrainConfig
from rag_uq_tpu_torch.data import chunk, loaders, synth_wiki
from rag_uq_tpu_torch.router import labels


@pytest.mark.parametrize("seed,kwargs", [
    (0, {}),
    (7, dict(alias_questions_per_entity=1, lookup_questions_per_entity=1,
             inverse_questions_per_entity=1, question_style="v2")),
])
def test_generate_world_is_the_jax_copy(seed, kwargs):
    ours = synth_wiki.generate_world(120, seed=seed, **kwargs)
    ref = jax_wiki.generate_world(120, seed=seed, **kwargs)
    assert ours.corpus_rows() == ref.corpus_rows()
    assert ours.qa_rows() == ref.qa_rows()
    assert [vars(e) for e in ours.entities] == [vars(e) for e in ref.entities]


def test_write_world_and_the_jsonl_loaders(tmp_path):
    world = synth_wiki.generate_world(30, seed=1)
    n = synth_wiki.write_world(world, str(tmp_path / "c.jsonl"), str(tmp_path / "q.jsonl"))
    m = jax_wiki.write_world(jax_wiki.generate_world(30, seed=1), str(tmp_path / "jc.jsonl"),
                             str(tmp_path / "jq.jsonl"))
    assert n == m
    for name in ("c", "q"):
        assert (tmp_path / f"{name}.jsonl").read_bytes() == (tmp_path / f"j{name}.jsonl").read_bytes()
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"question": "a?", "answers": ["b"]}\nnot json\n\n{"id": 1}\n{"question": "c?"}\n')
    assert list(loaders.read_jsonl(str(bad))) == list(jax_loaders.read_jsonl(str(bad)))
    with pytest.raises(json.JSONDecodeError):
        list(loaders.read_jsonl(str(bad), skip_bad=False))
    for limit in (None, 1):
        assert loaders.load_qa_jsonl(str(bad), limit) == jax_loaders.load_qa_jsonl(str(bad), limit)
    rows = [{"id": i, "text": "x" * i} for i in range(3)]
    loaders.write_jsonl(str(tmp_path / "w.jsonl"), rows)
    jax_loaders.write_jsonl(str(tmp_path / "jw.jsonl"), rows)
    assert (tmp_path / "w.jsonl").read_bytes() == (tmp_path / "jw.jsonl").read_bytes()


def test_passages_synthetic_qa_and_chunks(tmp_path):
    words = " ".join(f"w{i}" for i in range(700))
    articles = tmp_path / "a.jsonl"
    articles.write_text("\n".join(json.dumps(a) for a in [
        {"title": "T", "extract": words, "page_id": 5, "url": "u"},
        {"title": "S", "extract": "short text of a few words but over fifty characters long"},
        {"title": "E", "extract": "tiny"}]) + "\n")
    cfg, jcfg = ChunkConfig(chunk_size=120, overlap=20), JaxChunkConfig(chunk_size=120, overlap=20)
    assert loaders.prepare_passages(str(articles), str(tmp_path / "p.jsonl"), cfg) == \
        jax_loaders.prepare_passages(str(articles), str(tmp_path / "jp.jsonl"), jcfg)
    assert (tmp_path / "p.jsonl").read_bytes() == (tmp_path / "jp.jsonl").read_bytes()
    for text in (words, "a  b\n c", "x" * 3000, ""):
        assert chunk.chunk_text(text) == jax_chunk.chunk_text(text)
        assert chunk.chunk_text(text, cfg) == jax_chunk.chunk_text(text, jcfg)
    assert loaders.create_synthetic_nq(str(tmp_path / "s.jsonl"), 40, seed=3) == 40
    jax_loaders.create_synthetic_nq(str(tmp_path / "js.jsonl"), 40, seed=3)
    assert (tmp_path / "s.jsonl").read_bytes() == (tmp_path / "js.jsonl").read_bytes()
    assert vars(ChunkConfig()) == vars(JaxChunkConfig())
    assert vars(TrainConfig()) == vars(JaxTrainConfig())


@pytest.mark.parametrize("n,p,seed", [(500, 20, 42), (37, 5, 0)])
def test_synthetic_router_data_is_the_jax_copy(n, p, seed):
    for a, b in zip(loaders.synthetic_router_data(n, p, seed),
                    jax_loaders.synthetic_router_data(n, p, seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pseudo_labels_are_the_jax_copies():
    passages = ["Paris is the capital of France.", "The capital is Berlin.", "",
                "paris PARIS", "Nothing here", "The capital is Berlin."]
    for answer in ("Paris", "capital of Germany", "", "the Berlin wall"):
        for p in passages:
            assert labels.relevance_of(p, answer) == jax_labels.relevance_of(p, answer)
        assert np.array_equal(labels.aligned_pseudo_labels(passages, answer),
                              jax_labels.aligned_pseudo_labels(passages, answer))
        for k in (3, 8):
            assert np.array_equal(
                labels.create_pseudo_labels(passages[:3], passages[2:], answer, k),
                jax_labels.create_pseudo_labels(passages[:3], passages[2:], answer, k))
