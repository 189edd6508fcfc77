"""Whole runs of a small cell on the CPU: sound runs pass and send queries to
both towers, the control and planted faults fail (a fault in either pool
alone among them), a new cell and metric come from files alone, and the
harness loads neither JAX nor the JAX package."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import run

ROOT = Path(__file__).resolve().parent.parent


def _small_root(tmp: Path) -> Path:
    """A checkout's benchmark with a small cell beside the real ones."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/fiqa-hybrid-d768.json").read_text())
    cfg["corpus"].update(passages=400, vocab=600)
    cfg["corpus"]["length"].update(mean=40, min=5, max=120)
    cfg["dense"].update(dim=64, buckets=2048, max_len=32)
    cfg["router"]["warm_queries"] = 256
    (tmp / "benchmark/configs/small-hybrid.json").write_text(json.dumps(cfg))
    (tmp / "benchmark/traffic/small_batch.json").write_text(json.dumps(
        {"mode": "batch", "batch": 64, "batches": 3, "compare_calls": 3, "profile_calls": 2}))
    spec["configs"].append({"name": "small-hybrid", "source": "x",
                            "file": "benchmark/configs/small-hybrid.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "small.batch", "config": "small-hybrid",
                              "traffic": "small_batch", "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "fiqa.batch" in m.get("workloads", []):
            m["workloads"].append("small.batch")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _small_root(tmp_path_factory.mktemp("checkout"))


SEEDS = (2**31 + 7, 11, 2**33 + 5)


def _run(root, cell, trace=False, control=False, seconds=1.5, seed=SEEDS[0]):
    return run.run_cell(cell, seed, seconds, trace, device="cpu", root=root,
                        control=control, t_origin=time.perf_counter())


def test_sound_batch_run_is_correct_and_the_control_is_not(small):
    out = _run(small, "small.batch", control=True)
    assert out["correct"], out["checks"]
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    control = {k[len("control."):]: v for k, v in out["_extra"].items()
               if k.startswith("control.")}
    assert any(control[k] > limits[k] for k in control if k in limits), control
    assert set(out["metrics"]) == {"batch_qps", "setup_s"}


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_send_queries_to_both_towers(small, seed):
    out = _run(small, "small.batch", seed=seed)
    assert out["correct"], out["checks"]
    assert 0.2 <= out["_extra"]["dense_share"] <= 0.8
    assert out["checks"]["one_arm_share"]["limit"] == 0.8


def test_traced_batch_run_reports_the_host_spans(small):
    out = _run(small, "small.batch", trace=True)
    assert out["correct"], out["checks"]
    # Without a card there are no CUDA events and no device trace.
    assert set(out["metrics"]) == {"host_encode_ms.batch", "search_mfu.batch"}
    assert list(out)[-2:] == ["checks", "_extra"]


def _rolled(real):
    """``real``'s (values, positions) with each position moved one place
    along the pool: every score paired with another document."""
    def pool(*args, **kwargs):
        vals, pos = real(*args, **kwargs)
        return vals, torch.roll(pos, 1, dims=1)
    return pool


def _noisy(real):
    """``real``'s (values, positions) with each value off by up to about 10%:
    the documents right, their scores and order within the pool wrong."""
    def pool(*args, **kwargs):
        vals, pos = real(*args, **kwargs)
        g = torch.Generator(device=vals.device).manual_seed(3)
        noise = torch.randn(vals.shape, generator=g, device=vals.device, dtype=vals.dtype)
        return vals * (1.0 + 0.1 * noise), pos
    return pool


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", [_rolled, _noisy])
@pytest.mark.parametrize("tower", ["dense", "bm25"])
def test_a_fault_in_one_pool_alone_fails(small, monkeypatch, tower, fault, seed):
    from rag_uq_tpu_torch.ops import bm25 as bm25_ops
    from rag_uq_tpu_torch.retrieval import fused

    owner, attr = (fused, "dense_pool") if tower == "dense" else (bm25_ops, "topk_lowscatter")
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    assert not _run(small, "small.batch", seed=seed)["correct"]


def test_a_returned_document_altered_where_it_is_produced_fails(small, monkeypatch):
    from rag_uq_tpu_torch.retrieval import fused

    real = fused.fuse_pools_select

    def altered(*args, **kwargs):
        vals, pos = real(*args, **kwargs)
        pos = pos.clone()
        pos[:, 0] = torch.where(pos[:, 0] >= 0, (pos[:, 0] + 1) % 400, pos[:, 0])
        return vals, pos

    monkeypatch.setattr(fused, "fuse_pools_select", altered)
    assert not _run(small, "small.batch")["correct"]


def test_half_the_batch_left_out_fails(small, monkeypatch):
    from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever

    real = HybridRetriever.hybrid_search_batch

    def half(self, queries, *args, **kwargs):
        n = len(queries)
        vals, pos = real(self, list(queries[: max(n // 2, 1)]), *args, **kwargs)
        idx = [i % vals.shape[0] for i in range(n)]
        return vals[idx], pos[idx]

    monkeypatch.setattr(HybridRetriever, "hybrid_search_batch", half)
    assert not _run(small, "small.batch")["correct"]


def test_a_cell_a_mix_and_a_metric_from_new_files_alone(tmp_path):
    root = _small_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    (root / "benchmark/traffic/dummy_mix.json").write_text(json.dumps(
        {"mode": "batch", "batch": 64, "batches": 2, "compare_calls": 2}))
    (root / "benchmark/metrics/dummy_calls.py").write_text(
        '"""Calls made in the window (a test metric)."""\n\n\n'
        "def read(ctx):\n    return float(ctx['calls']) if ctx else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy.batch", "config": "small-hybrid",
                              "traffic": "dummy_mix", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("dummy.batch")
    spec["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "Whole step",
                              "moves": "batch_qps", "workloads": ["dummy.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = _run(root, "dummy.batch", trace=True, seconds=1.0)
    assert out["metrics"]["dummy_calls"]["value"] >= 1 and out["correct"]
    assert all(p.read_bytes() == data for p, data in before.items())


def test_a_forbidden_module_loaded_after_the_window_stops_the_result(monkeypatch, capsys):
    import types

    def judged_then_loaded(*args, **kwargs):
        # A module named like JAX's, loaded as the judge or a reader would.
        monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
                "checks": {}, "_extra": {}}

    monkeypatch.setattr(run, "run_cell", judged_then_loaded)
    assert run.main(["--workload", "fiqa.batch", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# A name ending in ``.*`` stands for every module of that folder, found when
# the test runs: kinds, modes and references that later files add are held
# to the same rules.
HARNESS = ("benchmark.run", "benchmark.control", "benchmark.deploy", "benchmark.generate",
           "benchmark.traffic_modes", "benchmark.check", "benchmark.trace", "benchmark.stats",
           "benchmark.metrics._common", "benchmark.metrics._roofline", "benchmark.kinds.*",
           "benchmark.modes.*")
REFERENCE = ("benchmark.reference.*",)


def _expand(modules):
    out = []
    for m in modules:
        if not m.endswith(".*"):
            out.append(m)
            continue
        folder = ROOT.joinpath(*m[:-2].split("."))
        out += [f"{m[:-2]}.{p.stem}" for p in sorted(folder.glob("*.py"))
                if p.stem != "__init__"]
    return tuple(out)


@pytest.mark.parametrize("modules, banned", [
    (HARNESS + REFERENCE, ("jax", "jaxlib", "flax", "rag_uq_tpu")),
    (REFERENCE, ("jax", "jaxlib", "flax", "rag_uq_tpu", "rag_uq_tpu_torch")),
])
def test_import_graph_holds_no_jax(modules, banned):
    reference_only = modules is REFERENCE
    modules = _expand(modules)
    assert modules
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"for m in {tuple(r.name for r in (ROOT / 'benchmark/metrics').glob('*.py'))!r}:\n"
            "    import runpy\n"
            f"    runpy.run_path({str(ROOT / 'benchmark/metrics')!r} + '/' + m)\n"
            if not reference_only else
            "import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n")
    code += ("tops = {m.split('.')[0] for m in sys.modules}\n"
             f"print(sorted(tops & set({banned!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.chip
def test_fiqa_batch_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell("fiqa.batch", 91, 5.0, False, control=True,
                       t_origin=time.perf_counter())
    assert out["correct"], out["checks"]
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    assert any(v > limits[k[8:]] for k, v in out["_extra"].items()
               if k.startswith("control.") and k[8:] in limits)
