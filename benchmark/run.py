"""Run one cell of the port's benchmark once, and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything that belongs to one cell is found by
name, so that a cell of a new kind comes from new files alone:

- the cell in ``BENCHMARK.json``, and its configuration in the file the
  entry names;
- the configuration's kind in ``benchmark/kinds/<kind>.py``, which exports
  ``make_inputs(cfg, seed, device)`` (what both sides are handed),
  ``build(cfg, inputs, seed, device)`` (the port's system under test) and
  ``judge(cfg, inputs, judged, device, control)``, which returns (the
  compared numbers, each with its limit; the other numbers to print);
- the mix in ``benchmark/traffic/<traffic>.json``, and its mode in
  ``benchmark/modes/<mode>.py``, whose ``Mode(dep, cfg, traffic, seed,
  device)`` has ``instrument``, ``warm``, ``window``, ``layer_context`` and
  ``release``, as ``traffic_modes.Batch`` has them;
- each per-layer metric's reader in ``benchmark/metrics/<metric>.py``.

Set-up (imports, the deployment, the kernels' builds, the warm-up of the
cell's shapes) is timed as ``setup_s``; then the window runs the traffic for
``--seconds``. With ``--trace 1`` the mode wraps calls into the port with
spans and CUDA events and may profile a sub-window, and the per-layer
metrics are printed instead of the end-to-end ones. A mix that sets
``"program_trace": true`` also has the port's own tracer
(``rag_uq_tpu_torch/utils/profiling.py``) on in its traced runs, from the
build to the window's end: its records of set-up and of the window reach
the readers as ``ctx["program"]["setup"]`` and ``ctx["program"]["window"]``.
Untraced runs never turn it on.

Afterwards the program's state is freed and the kind's judge, with the plain
reference (``benchmark/reference``), judges a sample of the window's answers
drawn from the seed. Each compared number is printed beside its limit, as
the last lines on standard error and under ``checks`` at the end of the
result line, the last line on standard output. The run fails with no result line
without a CUDA card, when the port cannot be imported, or when JAX or the
JAX package was loaded: looked for once the window has closed, and again
once the judge and the readers have run, just before the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rag_uq_tpu")
PART_NAME = re.compile(r"[A-Za-z0-9_]+")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the specification ----------------------------------------------------------------

def load_spec(root: Path, workload: str) -> Dict:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    bench = root / spec["paths"][0]
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {"cell": cell, "cfg": cfg, "traffic": traffic, "e2e": e2e, "per_layer": layer,
            "bench": bench}


def load_file(path: Path, module_name: str):
    """The module in ``path``, executed anew under ``module_name``."""
    mod_spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(mod_spec)
    # Registered while it runs, as an import would: a dataclass or a
    # pickled object of the module looks itself up there.
    sys.modules[module_name] = module
    mod_spec.loader.exec_module(module)
    return module


def load_reader(bench: Path, name: str):
    return load_file(bench / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read


def load_part(bench: Path, folder: str, name: str):
    """The module ``benchmark/<folder>/<name>.py``: a kind or a mode."""
    path = bench / folder / f"{name}.py"
    if not (PART_NAME.fullmatch(str(name)) and path.is_file()):
        raise RunError(f"no {folder[:-1]} {name!r}: looked for {path}")
    return load_file(path, f"benchmark_{folder}_{name}")


def load_kind(bench: Path, name: str):
    return load_part(bench, "kinds", name)


def load_mode(bench: Path, name: str):
    return load_part(bench, "modes", name).Mode


@contextmanager
def program_tracer(on: bool):
    """The port's tracer, on inside the block where ``on``; yields a
    ``take`` that gives its records since the last one (None where off)."""
    if not on:
        yield lambda: None
        return
    from rag_uq_tpu_torch.utils import profiling

    profiling.take()  # what an earlier run in this process left
    profiling.enable()
    try:
        yield profiling.take
    finally:
        profiling.disable()


def forbidden_modules() -> None:
    """Raise if JAX or the JAX package is loaded, by whole top-level names."""
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise RunError(f"modules loaded in the run's process: {found}")


# -- one run ---------------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, control: bool = False, t_origin: float = T_START) -> Dict:
    """One run of ``workload``: its result line as a dict, with the extra
    lines for standard error under ``_extra``. ``t_origin`` is where set-up
    starts (the process's start); ``control`` adds the control's numbers."""
    import torch

    s = load_spec(root, workload)
    cfg, traffic, cell = s["cfg"], s["traffic"], s["cell"]
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"the cell needs {cell['chips']} CUDA card(s); "
                           f"{torch.cuda.device_count()} available")
    torch.set_num_threads(1)
    try:
        import rag_uq_tpu_torch  # noqa: F401
    except ImportError as e:
        raise RunError(f"the port cannot be imported: {e}") from e
    from benchmark import trace as tr

    kind = load_kind(s["bench"], cfg["kind"])
    mode_class = load_mode(s["bench"], traffic["mode"])
    program_trace = trace and traffic.get("program_trace") is True
    t_inputs = time.perf_counter()
    inputs = kind.make_inputs(cfg, seed, device)
    log(f"inputs {time.perf_counter() - t_inputs:.3f} s")
    with program_tracer(program_trace) as take:
        dep = kind.build(cfg, inputs, seed, device)
        mode = mode_class(dep, cfg, traffic, seed, device)
        rec = tr.Recorder()
        mode.instrument(rec, trace)
        mode.warm()
        if trace and device == "cuda":
            tr.warm_profiler()
        if device == "cuda":
            torch.cuda.synchronize()
        # What set-up built stays: collections in the window skip it.
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_origin
        log(f"set-up {setup_s:.3f} s")
        program = {"setup": take()}
        rec.on = trace
        window = mode.window(seconds, rec, trace)
        rec.on = False
        program["window"] = take()
    memory = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    forbidden_modules()
    e2e = dict(window["e2e"], setup_s=setup_s)
    layer_ctx = mode.layer_context(rec, window)
    if program_trace:
        layer_ctx["program"] = program
    rec.restore()
    # The program's state goes before the reference runs.
    judged = mode.release()
    del dep, mode
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, extra = kind.judge(cfg, inputs, judged, device, control)
    metrics = {}
    if trace:
        for m in s["per_layer"]:
            value = load_reader(s["bench"], m["name"])(layer_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in s["e2e"]:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    forbidden_modules()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": int(window["attempted"]),
           "failed": int(window["failed"]), "metrics": metrics,
           "device": device_info(device, cell["chips"], memory, layer_ctx if trace else None)}
    if trace and layer_ctx.get("profile"):
        p = layer_ctx["profile"]
        out["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    out["checks"] = checks
    out["_extra"] = {**window.get("extra", {}), **extra}
    return out


def device_info(device: str, chips: int, memory: int, layer_ctx: Optional[Dict]) -> Dict:
    import torch

    if device != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(memory)}
    if layer_ctx is not None and layer_ctx.get("profile"):
        info["busy_s"] = layer_ctx["profile"]["busy_s"]
        info["window_s"] = layer_ctx["profile"]["window_s"]
    return info


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["RAG_UQ_TPU_TORCH_BUILD_DIR"] = str(ROOT / "build" / "rag_uq_tpu_torch")
    os.environ["USE_FLAX"] = "0"
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except RunError as e:
        log(f"error: {e}")
        return 2
    extra = out.pop("_extra")
    peaks = json.loads((ROOT / "benchmark" / "peaks.json").read_text())
    log(f"card: {power_limit()}; peaks: bf16 {peaks['bf16_flops']:.4g} FLOP/s, "
        f"HBM {peaks['hbm_bytes_per_s']:.4g} B/s at {peaks['power_limit_w']} W")
    for key, value in extra.items():
        log(f"{key}: {value}")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    try:
        forbidden_modules()
    except RunError as e:
        log(f"error: {e}")
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
