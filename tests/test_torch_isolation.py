"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter installs a meta-path finder that refuses ``jax``,
``flax``, ``optax``, ``msgpack`` and ``rag_uq_tpu`` (and their submodules),
and ``rouge_score``, ``nltk`` and ``matplotlib``, which the card's machine
does not have (the port computes ROUGE-L itself, and its plots import
matplotlib inside the function that draws), then imports every module of
``rag_uq_tpu_torch``, ``chip_smoke.py`` and ``tests/test_torch_spawn.py``
(the programs the multi-rank tests spawn; imports only: nothing runs).
The test fails on any attempt to import a refused name, caught or not, and
on any refused module found loaded.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "msgpack", "rag_uq_tpu", "rouge_score", "nltk",
           "matplotlib")

PROGRAM = r"""
import importlib, importlib.abc, importlib.util, json, pkgutil, sys
BLOCKED = %r
attempts = []

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            attempts.append(name)
            raise ModuleNotFoundError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import rag_uq_tpu_torch
modules = ["rag_uq_tpu_torch"]
for info in pkgutil.walk_packages(rag_uq_tpu_torch.__path__, "rag_uq_tpu_torch."):
    importlib.import_module(info.name)
    modules.append(info.name)
for name, path in (("chip_smoke", "chip_smoke.py"), ("rank_programs", "tests/test_torch_spawn.py")):
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"modules": modules, "attempts": attempts, "loaded": loaded}))
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROGRAM % (BLOCKED,)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["attempts"] == [] and out["loaded"] == [], out
    for name in ("rag_uq_tpu_torch.router.train", "rag_uq_tpu_torch.embed.train",
                 "rag_uq_tpu_torch.llm.train", "rag_uq_tpu_torch.cli.train_lm",
                 "rag_uq_tpu_torch.data.synth_wiki", "rag_uq_tpu_torch.utils.optim",
                 "rag_uq_tpu_torch.uq.scaling", "rag_uq_tpu_torch.eval.metrics",
                 "rag_uq_tpu_torch.eval.plots", "rag_uq_tpu_torch.eval.evaluator",
                 "rag_uq_tpu_torch.utils.profiling", "rag_uq_tpu_torch.cli.evaluate",
                 "rag_uq_tpu_torch.cli.calibrate", "rag_uq_tpu_torch.cli.run_pipeline",
                 "rag_uq_tpu_torch.data.verify", "rag_uq_tpu_torch.data.wikipedia",
                 "rag_uq_tpu_torch.cli.doctor", "rag_uq_tpu_torch.cli.warmup",
                 "rag_uq_tpu_torch.cli.profile_fused", "rag_uq_tpu_torch.models",
                 "rag_uq_tpu_torch.text.porter", "rag_uq_tpu_torch.examples.quickstart",
                 "rag_uq_tpu_torch.core.mesh", "rag_uq_tpu_torch.parallel.sharding",
                 "rag_uq_tpu_torch.parallel.sharded_index", "rag_uq_tpu_torch.cli.bench_sharded",
                 "rag_uq_tpu_torch.compat", "rag_uq_tpu_torch.compat.shims",
                 "rag_uq_tpu_torch.cli.bench_serving", "rag_uq_tpu_torch.cli.parity",
                 "rag_uq_tpu_torch.cli.parity_e2e"):
        assert name in out["modules"]
