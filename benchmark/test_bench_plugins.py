"""A cell of a new configuration kind and a new traffic mode, with readers of the
port's own spans, from new files alone; kinds and modes found by name, with an
error that names the file looked for; ``fiqa.batch`` bound to the harness's
own functions; and the port's tracer off unless a mix asks for it."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import run
from benchmark.test_bench_cells import _small_root

TOY_KIND = '''"""A toy kind: a two-layer MLP drawn from the seed, run in float32 on the
given device and judged against float64."""

import torch

from rag_uq_tpu_torch.utils import profiling


def make_inputs(cfg, seed, device):
    g = torch.Generator().manual_seed(seed % 2**63)
    d, h = cfg["dim"], cfg["hidden"]
    return {"w1": torch.randn(d, h, generator=g, dtype=torch.float64) / d**0.5,
            "w2": torch.randn(h, d, generator=g, dtype=torch.float64) / h**0.5}


def build(cfg, inputs, seed, device):
    w1, w2 = (inputs[k].float().to(device) for k in ("w1", "w2"))

    def forward(x):
        with profiling.span("toy.forward", n=len(x)):
            return torch.relu(x @ w1) @ w2

    return forward


def judge(cfg, inputs, judged, device, control):
    x = judged["x"].double()
    ref = torch.relu(x @ inputs["w1"]) @ inputs["w2"]
    err = float((judged["y"].double() - ref).abs().max() / ref.abs().max())
    return ({"max_rel_err": {"value": err, "limit": cfg["check"]["limits"]["max_rel_err"]}},
            {"judged_rows": len(x)})
'''

TOY_MODE = '''"""A toy mode: the model on seeded batches in turn until the window closes;
the first ``compare_calls`` calls are judged."""

import time

import torch


class Mode:
    def __init__(self, dep, cfg, traffic, seed, device):
        g = torch.Generator().manual_seed(seed % 2**63 + 1)
        self.model, self.traffic = dep, traffic
        self.batches = [torch.randn(traffic["batch"], cfg["dim"], generator=g).to(device)
                        for _ in range(traffic["batches"])]
        self.calls, self.kept = 0, []

    def instrument(self, rec, trace):
        pass

    def warm(self):
        self.model(self.batches[0])

    def window(self, seconds, rec, trace):
        t0 = time.perf_counter()
        while not self.calls or time.perf_counter() - t0 < seconds:
            i = self.calls % len(self.batches)
            y = self.model(self.batches[i])
            if len(self.kept) < self.traffic["compare_calls"]:
                self.kept.append((i, y))
            self.calls += 1
        elapsed = time.perf_counter() - t0
        queries = self.calls * self.traffic["batch"]
        return {"e2e": {"batch_qps": queries / elapsed}, "attempted": queries, "failed": 0}

    def layer_context(self, rec, window):
        return {"calls": self.calls}

    def release(self):
        x = torch.cat([self.batches[i] for i, _ in self.kept]).cpu()
        y = torch.cat([y for _, y in self.kept]).cpu()
        self.kept = []
        return {"x": x, "y": y}
'''


def _spans(record_of):
    return f'''"""Test metric: the toy's ``toy.forward`` spans in the port's record of
{record_of}."""


def read(ctx):
    if not ctx.get("program"):
        return None
    return sum(s.name == "toy.forward" for s in ctx["program"]["{record_of}"]["spans"])
'''


TOY_FORWARD_MS = '''"""Test metric: the toy's forward, mean host ms of the port's own
``toy.forward`` spans in the window."""


def read(ctx):
    if not ctx.get("program"):
        return None
    ms = [s.host_ms for s in ctx["program"]["window"]["spans"] if s.name == "toy.forward"]
    return sum(ms) / len(ms) if ms else None
'''

TOY_METRICS = {"toy_forward_ms": TOY_FORWARD_MS, "toy_spans.setup": _spans("setup"),
               "toy_spans.window": _spans("window")}


def _benchmark_files(root):
    return {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A checkout with a toy cell added from new files alone, and the bytes of
    every benchmark file that was there before."""
    root = _small_root(tmp_path_factory.mktemp("checkout"))
    before = _benchmark_files(root)
    bench = root / "benchmark"
    (bench / "kinds/toy_mlp.py").write_text(TOY_KIND)
    (bench / "modes/toy_batches.py").write_text(TOY_MODE)
    (bench / "configs/toy-mlp.json").write_text(json.dumps(
        {"name": "toy-mlp", "kind": "toy_mlp", "dim": 64, "hidden": 128,
         "check": {"limits": {"max_rel_err": 1e-4}}}))
    (bench / "traffic/toy_mix.json").write_text(json.dumps(
        {"mode": "toy_batches", "batch": 256, "batches": 3, "compare_calls": 4,
         "program_trace": True}))
    for name, source in TOY_METRICS.items():
        (bench / f"metrics/{name}.py").write_text(source)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-mlp", "source": "x",
                            "file": "benchmark/configs/toy-mlp.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "toy.batch", "config": "toy-mlp", "traffic": "toy_mix",
                              "chips": 1, "why": "x"})
    next(m for m in spec["end_to_end"] if m["name"] == "batch_qps")["workloads"].append(
        "toy.batch")
    spec["per_layer"] += [{"name": name, "unit": "ms" if name.endswith("ms") else "spans",
                           "better": "lower", "source": "program_span", "layer": "Toy",
                           "moves": "batch_qps", "workloads": ["toy.batch"]}
                          for name in TOY_METRICS]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, before


def _run(root, cell, trace=False, seconds=0.5, seed=2**31 + 29):
    return run.run_cell(cell, seed, seconds, trace, device="cpu", root=root,
                        t_origin=time.perf_counter())


def test_a_kind_a_mode_and_program_span_readers_from_new_files_alone(toy):
    from rag_uq_tpu_torch.utils import profiling

    root, before = toy
    out = _run(root, "toy.batch", trace=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_rel_err"]["value"] < 1e-5
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(TOY_METRICS)
    # The warm-up's call in set-up; every call of the window in the window.
    assert m["toy_spans.setup"] == 1
    assert m["toy_spans.window"] == out["attempted"] / 256 and m["toy_forward_ms"] > 0
    assert not profiling._on
    out = _run(root, "toy.batch")
    assert out["correct"] and set(out["metrics"]) == {"batch_qps", "setup_s"}
    assert out["metrics"]["batch_qps"]["value"] > 0
    assert all(p.read_bytes() == data for p, data in before.items())


def test_a_fault_in_the_toys_output_fails_its_judge(toy, monkeypatch):
    real = run.load_kind

    def faulty(bench, name):
        kind = real(bench, name)
        build = kind.build

        def altered_build(*args):
            forward = build(*args)

            def altered(x):
                y = forward(x).clone()
                y[0, 0] += 0.05
                return y

            return altered

        monkeypatch.setattr(kind, "build", altered_build)
        return kind

    monkeypatch.setattr(run, "load_kind", faulty)
    out = _run(toy[0], "toy.batch")
    assert not out["correct"] and out["checks"]["max_rel_err"]["value"] > 1e-3


@pytest.mark.parametrize("part, name", [("kind", "no_such_kind"), ("kind", "../deploy"),
                                        ("mode", "no_such_mode"), ("mode", "batch.x")])
def test_a_kind_or_mode_without_a_file_stops_the_run(tmp_path, part, name):
    root = _small_root(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs/small-hybrid.json").read_text())
    mix = json.loads((bench / "traffic/small_batch.json").read_text())
    if part == "kind":
        cfg["kind"] = name
    else:
        mix["mode"] = name
    (bench / "configs/small-hybrid.json").write_text(json.dumps(cfg))
    (bench / "traffic/small_batch.json").write_text(json.dumps(mix))
    with pytest.raises(run.RunError) as err:
        _run(root, "small.batch")
    assert str(bench / f"{part}s" / f"{name}.py") in str(err.value)


def test_fiqa_batch_resolves_to_the_harness_functions_themselves():
    from benchmark import check, deploy, traffic_modes

    s = run.load_spec(run.ROOT, "fiqa.batch")
    kind = run.load_kind(s["bench"], s["cfg"]["kind"])
    assert kind.make_inputs is deploy.make_inputs and kind.build is deploy.build
    assert kind.judge is check.run
    assert run.load_mode(s["bench"], s["traffic"]["mode"]) is traffic_modes.Batch
    assert "program_trace" not in s["traffic"]


def test_a_traced_run_of_a_mix_without_program_trace_leaves_the_tracer_off(tmp_path,
                                                                            monkeypatch):
    from rag_uq_tpu_torch.retrieval.hybrid import HybridRetriever
    from rag_uq_tpu_torch.utils import profiling

    root = _small_root(tmp_path)
    seen = []
    real = HybridRetriever.hybrid_search_batch

    def search(self, *args, **kwargs):
        seen.append(profiling._on)
        return real(self, *args, **kwargs)

    def enable():
        raise AssertionError("the port's tracer was turned on")

    monkeypatch.setattr(HybridRetriever, "hybrid_search_batch", search)
    monkeypatch.setattr(profiling, "enable", enable)
    out = _run(root, "small.batch", trace=True, seconds=1.0)
    assert out["correct"], out["checks"]
    assert seen and not any(seen) and not profiling._on
