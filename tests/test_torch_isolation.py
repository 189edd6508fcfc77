"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter installs a meta-path finder that refuses ``jax``,
``flax``, ``optax``, ``msgpack`` and ``rag_uq_tpu`` (and their submodules),
then imports every module of ``rag_uq_tpu_torch`` and ``chip_smoke.py``
(imports only: nothing runs). The test fails on any attempt to import a
refused name, caught or not, and on any refused module found loaded.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "msgpack", "rag_uq_tpu")

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
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
importlib.util.module_from_spec(spec)
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
                 "rag_uq_tpu_torch.data.synth_wiki", "rag_uq_tpu_torch.utils.optim"):
        assert name in out["modules"]
