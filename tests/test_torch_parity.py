"""The port's parity CLIs (``cli/parity.py``, ``cli/parity_e2e.py``) and
shims (``compat/shims.py``) against the JAX package's, on the CPU.

- the shims: ``BM25Okapi`` scores, idf and ``get_top_n`` bit for bit (both
  numpy float64), the ``chromadb`` stand-in's ``add``/``query``/``get``
  equal, and ``install_shims`` registering only what is absent, with
  ``rank_bm25`` and ``chromadb`` taken out of ``sys.modules`` between the two
  packages' calls so that one package's shims never answer for the other's;
- the span-echo generator, ``_extract_context`` and ``_prompt_of`` byte for
  byte on 200 seeded prompts; ``ConformalRAG``'s calibration scores exactly
  and its threshold within 1e-6 (float32 quantiles), ``_coverage`` exactly;
- ``_run_our_retrieval`` with ``Sha256Embedder(dim=384)`` on a 60-article
  world and at the harness's own 4,000 articles and 800 questions: the JAX
  function's ranked ids, equal list for list (stricter than the tie rule);
- ``run_parity``'s report: the JAX keys and dataset, ``_hit_at_1`` exact,
  the router's losses within 1e-5 relative of JAX's (the router at
  ``dropout = 0`` with the JAX initial parameters carried across through
  ``convert.load_router``, by patching the router's construction in this
  test), and ``run_reference_arm`` equal to JAX's on a stand-in router;
- ``run_e2e_parity`` end to end through both packages against a stand-in
  reference checkout that this file writes into a temporary directory (a
  few dozen lines on the shims: test scaffolding, no copy of upstream code;
  its numbers say nothing about the upstream), at 60 articles and
  ``n_cal = n_test = 40``: the two reports agree in every field that is not
  a time, floats within 1e-12 relative and the conformal thresholds within
  1e-6. The trained-encoder arm is off (``encoder_checkpoint=None``): the
  encoder's bf16 forward differs between the packages by up to about 5e-3
  in score, which reorders neighbours (``tests/test_torch_demo_retrieval.py``
  holds that arm's retrieval in float32).
"""

import json
import sys
import textwrap
import types

import jax
import numpy as np
import pytest

from rag_uq_tpu.cli import parity as jax_parity
from rag_uq_tpu.cli import parity_e2e as jax_e2e
from rag_uq_tpu.compat import install_shims as jax_install_shims
from rag_uq_tpu.compat import shims as jax_shims
from rag_uq_tpu.core.config import RouterConfig as JaxRouterConfig
from rag_uq_tpu.core.config import TrainConfig as JaxTrainConfig
from rag_uq_tpu.data.loaders import synthetic_router_data
from rag_uq_tpu.data.synth_wiki import generate_world
from rag_uq_tpu.embed.hash_embed import Sha256Embedder as JaxSha256
from rag_uq_tpu.router import model as jax_router_model
from rag_uq_tpu.uq.conformal import ConformalRAG as JaxConformal
from rag_uq_tpu_torch.cli import parity, parity_e2e
from rag_uq_tpu_torch.cli.train_encoder import split_by_entity
from rag_uq_tpu_torch.compat import install_shims
from rag_uq_tpu_torch.compat import shims
from rag_uq_tpu_torch.convert import load_router
from rag_uq_tpu_torch.core.config import RouterConfig
from rag_uq_tpu_torch.embed.hash_embed import Sha256Embedder
from rag_uq_tpu_torch.router import model as router_model
from rag_uq_tpu_torch.uq.conformal import ConformalRAG

SHIMMED = ("rank_bm25", "chromadb", "chromadb.config")
LOADED = SHIMMED + ("reference_streaming_index", "reference_confidence", "reference_router")
JaxRouter = jax_router_model.RetrievalRouter
RetrievalRouter = router_model.RetrievalRouter


@pytest.fixture(autouse=True)
def isolated_modules():
    """Set up before (and torn down after) ``monkeypatch``: whatever the
    test registered in ``sys.modules`` under these names goes, and what was
    there before comes back."""
    saved = {n: sys.modules.pop(n) for n in LOADED if n in sys.modules}
    yield
    for n in LOADED:
        sys.modules.pop(n, None)
    sys.modules.update(saved)


def forget_shims(monkeypatch):
    for name in SHIMMED:
        monkeypatch.delitem(sys.modules, name, raising=False)


@pytest.fixture(scope="module")
def world():
    w = generate_world(60, seed=0)
    train_qa, held_qa = split_by_entity(w.qa_rows(), 0.1)
    return w.corpus_rows(), train_qa, held_qa


def token_corpus(seed=0, n_docs=40, vocab=60):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    docs = [[f"t{t}" for t in rng.choice(vocab, size=int(rng.integers(3, 25)), p=p)]
            for _ in range(n_docs)]
    docs.append(["t0"] * 4)
    queries = [[f"t{t}" for t in rng.choice(vocab, size=int(rng.integers(1, 6)))]
               for _ in range(20)]
    return docs, queries + [["unseen"], ["t0", "t0", "t1"], []]


@pytest.mark.parametrize("params", [{}, {"k1": 1.2, "b": 0.5, "epsilon": 0.5}])
def test_bm25_okapi_bit_for_bit(params):
    docs, queries = token_corpus()
    ours, theirs = shims.BM25Okapi(docs, **params), jax_shims.BM25Okapi(docs, **params)
    assert ours.idf == theirs.idf and min(theirs.idf.values()) > 0  # the floor applied
    assert np.array_equal(ours.doc_len, theirs.doc_len) and ours.avgdl == theirs.avgdl
    names = [f"doc{i}" for i in range(len(docs))]
    for q in queries:
        assert np.array_equal(ours.get_scores(q), theirs.get_scores(q))
        assert ours.get_top_n(q, names, n=7) == theirs.get_top_n(q, names, n=7)


def test_chromadb_stand_in_equals_jax():
    results = []
    for make in (shims._make_chromadb_module, jax_shims._make_chromadb_module):
        rng = np.random.default_rng(4)
        client = make().PersistentClient(path="unused")
        col = client.get_or_create_collection("docs", metadata={"hnsw:space": "cosine"})
        empty = col.query(query_embeddings=[[1.0, 0.0, 0.0]], n_results=3)
        emb = rng.normal(size=(30, 8))
        ids = [f"d{i}" for i in range(30)]
        col.add(ids=ids, embeddings=emb.tolist(), documents=[f"text {i}" for i in ids],
                metadatas=[{"i": i} for i in range(30)])
        col.add(ids=["d3"], embeddings=[emb[7].tolist()], documents=["upserted"])
        q = rng.normal(size=(5, 8)).tolist()
        results.append((empty, col.query(query_embeddings=q, n_results=6), col.count(),
                        col.get(ids=["d1", "nope"]), col.get()["ids"]))
    assert results[0] == results[1]


def test_install_shims_registers_only_when_absent(monkeypatch):
    assert install_shims() == ["rank_bm25", "chromadb"]
    assert sys.modules["rank_bm25"].BM25Okapi is shims.BM25Okapi
    assert install_shims() == []  # present: left alone
    forget_shims(monkeypatch)
    assert jax_install_shims() == ["rank_bm25", "chromadb"]
    assert sys.modules["rank_bm25"].BM25Okapi is jax_shims.BM25Okapi
    assert install_shims() == []  # the JAX package's shims stay
    assert sys.modules["rank_bm25"].BM25Okapi is jax_shims.BM25Okapi
    assert install_shims(force=True) == ["rank_bm25", "chromadb"]
    assert sys.modules["rank_bm25"].BM25Okapi is shims.BM25Okapi
    real = types.ModuleType("chromadb")  # a package that is present is kept
    monkeypatch.setitem(sys.modules, "chromadb", real)
    monkeypatch.delitem(sys.modules, "rank_bm25")
    assert install_shims() == ["rank_bm25"] and sys.modules["chromadb"] is real


def test_span_echo_and_prompts_byte_identical(world):
    _, train_qa, _ = world
    rng = np.random.default_rng(11)
    samples = list(train_qa[:100])
    for i in range(100):
        words = [f"w{int(x)}" for x in rng.integers(0, 500, size=int(rng.integers(0, 60)))]
        samples.append({"question": f"question {i}?", "context": " ".join(words),
                        "answers": [words[0] if words else ""]})
    prompts = [parity_e2e._prompt_of(s) for s in samples]
    assert len(prompts) == 200
    assert prompts == [jax_e2e._prompt_of(s) for s in samples]
    prompts += ["no context marker at all", "Context: \n\nQuestion: q\n\nAnswer:", ""]
    for p in prompts:
        assert parity_e2e._extract_context(p) == jax_e2e._extract_context(p)
        assert parity_e2e.span_echo_answer(p) == jax_e2e.span_echo_answer(p)
    assert parity_e2e.GeneratorStyleEcho().generate_batch(prompts, [0.1], [0.9]) == \
        jax_e2e.GeneratorStyleEcho().generate_batch(prompts, [0.1], [0.9])
    assert parity_e2e.OllamaStyleEcho().generate(prompt=prompts[0]) == \
        jax_e2e.OllamaStyleEcho().generate(prompt=prompts[0])


def test_conformal_threshold_and_coverage_match_jax(tmp_path):
    w = generate_world(200, seed=1)
    train_qa, _ = split_by_entity(w.qa_rows(), 0.1)
    pool = [q for q in train_qa if q["answers"][0]]
    cal, test = pool[:150], pool[150:300]
    args = ([s["question"] for s in cal], [s["context"] for s in cal],
            [s["answers"][0] for s in cal])
    ours = ConformalRAG(parity_e2e.GeneratorStyleEcho(), str(tmp_path / "ours.db"), alpha=0.1,
                        device="cpu")
    theirs = JaxConformal(jax_e2e.GeneratorStyleEcho(), str(tmp_path / "jax.db"), alpha=0.1)
    ours.calibrate(*args)
    theirs.calibrate(*args)
    assert ours.calibration_scores == theirs.calibration_scores
    assert len(set(ours.calibration_scores)) >= 20  # spread out, not the demo's atom at 0
    t_ours, t_jax = ours.get_conformal_threshold(), theirs.get_conformal_threshold()
    assert 0.0 < t_jax < 1.0 and abs(t_ours - t_jax) <= 1e-6
    cov = parity_e2e._coverage(ours, ours.rouge_l, t_ours, test)
    ref = jax_e2e._coverage(theirs, theirs.rouge_l, t_jax, test)
    assert cov["coverage"] == ref["coverage"] and cov["n_test"] == ref["n_test"] == len(test)


@pytest.mark.parametrize("n_articles", [60, 4000])
def test_our_retrieval_sha256_matches_jax(world, n_articles):
    """At 60 articles and at parity_e2e's own 4,000 (its first 800 held-out
    questions)."""
    if n_articles == 60:
        rows, _, held_qa = world
    else:
        w = generate_world(n_articles, seed=0)
        rows, held_qa = w.corpus_rows(), split_by_entity(w.qa_rows(), 0.1)[1][:800]
    questions = [q["question"] for q in held_qa]
    ours = parity_e2e._run_our_retrieval(rows, questions, 10, Sha256Embedder(dim=384),
                                         device="cpu")
    theirs = jax_e2e._run_our_retrieval(rows, questions, 10, JaxSha256(dim=384))
    assert set(ours) == set(theirs)
    for arm in ("hybrid", "bm25_only", "dense_only"):
        assert ours[arm] == theirs[arm] and all(ours[arm])


def test_hit_at_1_exact():
    rng = np.random.default_rng(2)
    rel = rng.random((37, 20))
    top1 = rng.integers(0, 20, size=37)
    assert parity._hit_at_1(rel, top1) == jax_parity._hit_at_1(rel, top1)


def test_run_parity_matches_jax(tmp_path, monkeypatch):
    def jax_router(config=None, seed=0):
        return JaxRouter(JaxRouterConfig(dropout=0.0), seed=seed)

    def port_router(config=None, seed=0, device="cuda"):
        init = jax_router(seed=seed)
        router = RetrievalRouter(RouterConfig(dropout=0.0), seed=seed, device=device)
        return load_router(router, jax.tree.map(np.asarray, init.params),
                           jax.tree.map(np.asarray, init.stats))

    monkeypatch.setattr(jax_router_model, "RetrievalRouter", jax_router)
    monkeypatch.setattr(router_model, "RetrievalRouter", port_router)
    # The JAX arm's checkpoints into this test's directory.
    monkeypatch.setattr(jax_parity, "TrainConfig", lambda **kw: JaxTrainConfig(
        **{**kw, "checkpoint_dir": str(tmp_path / "jax_ckpt")}))
    ours = parity.run_parity(skip_reference=True, device="cpu", n_queries=60, epochs=2,
                             output_path=str(tmp_path / "ours.json"))
    theirs = jax_parity.run_parity(skip_reference=True, n_queries=60, epochs=2,
                                   output_path=str(tmp_path / "theirs.json"))
    assert json.loads((tmp_path / "ours.json").read_text()) == ours
    assert set(ours) == set(theirs) == {"dataset", "ours"}
    assert ours["dataset"] == theirs["dataset"]
    assert set(ours["ours"]) == set(theirs["ours"])
    assert ours["ours"]["impl"] == "rag_uq_tpu_torch (cpu)"
    for key in ("final_train_loss", "final_val_loss"):
        assert abs(ours["ours"][key] - theirs["ours"][key]) <= 1e-5 * abs(theirs["ours"][key])
    assert ours["ours"]["val_hit_at_1"] == theirs["ours"]["val_hit_at_1"]


def test_parity_entry_points_default_to_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.run_parity(n_queries=20, epochs=1, output_path=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity_e2e.main(["--reference", str(tmp_path), "--articles", "5"])


REFERENCE_FILES = {
    "rag_uq/__init__.py": "",
    "rag_uq/router.py": '''
        """Test stand-in for a reference router (not upstream code)."""
        from dataclasses import dataclass

        import torch


        @dataclass
        class RouterConfig:
            hidden_dim: int = 16


        class RetrievalRouter(torch.nn.Module):
            def __init__(self, config):
                super().__init__()
                self.net = torch.nn.Sequential(
                    torch.nn.Linear(2, config.hidden_dim), torch.nn.ReLU(),
                    torch.nn.Linear(config.hidden_dim, 1))

            def forward(self, bm25, dense):
                x = torch.stack([bm25, dense], dim=-1).float()
                return torch.sigmoid(self.net(x)).squeeze(-1)

            def hybrid_rerank(self, bm25, dense, top_k=10):
                w = self(bm25, dense)
                return torch.topk(w * dense + (1 - w) * bm25, top_k, dim=-1)


        class RouterTrainer:
            def __init__(self, router, checkpoint_dir):
                self.router = router
                self.opt = torch.optim.Adam(router.parameters(), lr=1e-2)

            def _loss(self, b, d, r):
                w = self.router(b, d)
                return -(torch.softmax(w * d + (1 - w) * b, -1) * r.float()).sum(-1).mean()

            def fit(self, train, val, num_epochs, batch_size, early_stopping_patience):
                history = {"train_losses": [], "val_losses": []}
                for _ in range(num_epochs):
                    losses = []
                    for i in range(0, len(train[0]), batch_size):
                        self.opt.zero_grad()
                        loss = self._loss(*(t[i : i + batch_size] for t in train))
                        loss.backward()
                        self.opt.step()
                        losses.append(loss.item())
                    history["train_losses"].append(sum(losses) / len(losses))
                    with torch.no_grad():
                        history["val_losses"].append(self._loss(*val).item())
                return history
    ''',
    "rag_uq/streaming_index.py": '''
        """Test stand-in for a reference streaming index (not upstream code),
        on the shims: BM25Okapi over lowercased words, a chromadb collection
        of SHA-256 vectors, and an equal-weight fusion of the two."""
        import hashlib
        from dataclasses import dataclass
        from typing import Optional

        import chromadb
        import numpy as np
        from rank_bm25 import BM25Okapi


        @dataclass
        class Document:
            id: str
            text: str
            title: Optional[str] = None


        @dataclass
        class Result:
            doc_id: str
            score: float


        def embed(text, dim=64):
            raw = b"".join(hashlib.sha256(f"{text}|{i}".encode()).digest()
                           for i in range(dim // 32))
            return (np.frombuffer(raw, dtype=np.uint8) / 255.0).tolist()


        class BM25Index:
            def __init__(self):
                self.ids, self.tokens, self.bm25 = [], [], None

            def __len__(self):
                return len(self.ids)

            def add_documents(self, docs):
                for d in docs:
                    self.ids.append(d.id)
                    self.tokens.append(d.text.lower().split())
                self.bm25 = BM25Okapi(self.tokens)

            def search(self, query, top_k):
                scores = self.bm25.get_scores(query.lower().split())
                order = np.argsort(-scores, kind="stable")[:top_k]
                return [(self.ids[i], float(scores[i])) for i in order]


        class DenseIndex:
            def __init__(self, path):
                client = chromadb.PersistentClient(path=path)
                self.collection = client.get_or_create_collection("docs")

            def __len__(self):
                return self.collection.count()

            def add_documents(self, docs):
                self.collection.add(ids=[d.id for d in docs],
                                    embeddings=[embed(d.text) for d in docs],
                                    documents=[d.text for d in docs])

            def search(self, query, top_k=10):
                res = self.collection.query(query_embeddings=[embed(query)], n_results=top_k)
                return [(i, 1.0 - dist, doc) for i, dist, doc in
                        zip(res["ids"][0], res["distances"][0], res["documents"][0])]


        class HybridRetriever:
            def __init__(self, bm25_persist_path=None, chroma_persist_path=None):
                self.documents = {}
                self.bm25_index = BM25Index()
                self.dense_index = DenseIndex(chroma_persist_path)

            def bm25_search(self, query, top_k=10):
                return self.bm25_index.search(query, top_k)

            def hybrid_search(self, query, top_k=10):
                fused = {}
                for doc_id, score in self.bm25_search(query, 2 * top_k):
                    fused[doc_id] = fused.get(doc_id, 0.0) + 0.5 * score
                for doc_id, score, _ in self.dense_index.search(query, 2 * top_k):
                    fused[doc_id] = fused.get(doc_id, 0.0) + 0.5 * score
                ranked = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
                return [Result(d, s) for d, s in ranked]
    ''',
    "rag_uq/confidence.py": '''
        """Test stand-in for a reference conformal predictor (not upstream
        code): 1 - ROUGE-L F over lowercased words, the finite-sample
        (1 - alpha) quantile."""
        import numpy as np


        class ConformalRAG:
            def __init__(self, client, calibration_db_path, alpha=0.1):
                self.client, self.alpha, self.scores = client, alpha, []

            @staticmethod
            def rouge_l(prediction, reference):
                a, b = prediction.lower().split(), reference.lower().split()
                if not a or not b:
                    return 0.0
                row = [0] * (len(b) + 1)
                for x in a:
                    prev = 0
                    for j, y in enumerate(b, 1):
                        prev, row[j] = row[j], prev + 1 if x == y else max(row[j], row[j - 1])
                lcs = row[-1]
                if lcs == 0:
                    return 0.0
                p, r = lcs / len(a), lcs / len(b)
                return 2 * p * r / (p + r)

            def calibrate(self, questions, contexts, answers):
                for q, c, a in zip(questions, contexts, answers):
                    prompt = ("Answer the following question based on the provided context.\\n"
                              "Be concise and precise.\\n\\n"
                              f"Context: {c}\\n\\nQuestion: {q}\\n\\nAnswer:")
                    pred = self.client.generate(model="stand-in", prompt=prompt)["response"]
                    self.scores.append(1.0 - self.rouge_l(pred.strip(), a))

            def get_conformal_threshold(self):
                n = len(self.scores)
                level = min(1.0, np.ceil((n + 1) * (1 - self.alpha)) / n)
                return float(np.quantile(self.scores, level, method="higher"))
    ''',
}


@pytest.fixture(scope="module")
def reference_checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    for rel, text in REFERENCE_FILES.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(textwrap.dedent(text))
    return root


def test_reference_arm_runs_as_jax_runs_it(reference_checkout):
    bm25, dense, rel = synthetic_router_data(80, 20, seed=42)
    train, val = (bm25[:64], dense[:64], rel[:64]), (bm25[64:], dense[64:], rel[64:])
    ours = parity.run_reference_arm(str(reference_checkout), train, val, 3, 16)
    theirs = jax_parity.run_reference_arm(str(reference_checkout), train, val, 3, 16)
    ours.pop("wall_clock_s"), theirs.pop("wall_clock_s")
    assert ours == theirs and np.isfinite(ours["final_val_loss"])


def strip_times(report):
    out = json.loads(json.dumps(report))
    out.pop("retrieval_timings_s")
    for arm in out["conformal"].values():
        if isinstance(arm, dict):
            arm.pop("calibrate_s")
    return out


def assert_same(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for key in theirs:
            assert_same(ours[key], theirs[key], f"{path}.{key}")
    elif isinstance(theirs, float):
        tol = 1e-6 if path.endswith(".threshold") else 1e-12 * abs(theirs)
        assert abs(ours - theirs) <= tol, (path, ours, theirs)
    else:
        assert ours == theirs, path


def test_run_e2e_parity_through_both_packages(reference_checkout, tmp_path, monkeypatch):
    kw = dict(n_articles=60, n_cal=40, n_test=40, encoder_checkpoint=None)
    ours = parity_e2e.run_e2e_parity(str(reference_checkout), device="cpu",
                                     output_path=str(tmp_path / "ours.json"), **kw)
    assert sys.modules["rank_bm25"].BM25Okapi is shims.BM25Okapi
    assert sys.modules["reference_streaming_index"].BM25Okapi is shims.BM25Okapi
    forget_shims(monkeypatch)
    theirs = jax_e2e.run_e2e_parity(str(reference_checkout),
                                    output_path=str(tmp_path / "theirs.json"), **kw)
    assert sys.modules["reference_streaming_index"].BM25Okapi is jax_shims.BM25Okapi
    assert json.loads((tmp_path / "ours.json").read_text()) == ours
    assert set(ours["retrieval_timings_s"]) == set(theirs["retrieval_timings_s"])
    assert_same(strip_times(ours), strip_times(theirs))
    ret, conf = ours["retrieval"], ours["conformal"]
    assert set(ret) == {"hybrid", "bm25_only", "dense_only"}
    assert all(set(arms) == {"reference", "ours_sha256"} for arms in ret.values())
    assert ret["bm25_only"]["ours_sha256"]["recall@10"] > 0.5
    assert 0.0 < conf["ours"]["threshold"] < 1.0 and conf["ours"]["n_test"] == 40
