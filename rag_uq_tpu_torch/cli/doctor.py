"""Environment doctor: the counterpart of ``rag_uq_tpu/cli/doctor.py``.

Reports what the port needs: torch and the CUDA version it was built
with, the card's name and power limit (``nvidia-smi``), ``nvcc`` (the two
kernel libraries are built with it at first use), CUTLASS's headers, g++
and the native tokenizer it builds, and the optional ``matplotlib``
(plots); and creates the standard data/model directories, as the JAX doctor
does. With ``--device cuda`` (the default) it raises when no card is
present; ``--device cpu`` reports without one.

Run: ``python3 -m rag_uq_tpu_torch.cli.doctor [--create-dirs] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.ops.cosine_topk import nvcc_path

logger = logging.getLogger(__name__)

REQUIRED = ["torch", "numpy"]
OPTIONAL = ["matplotlib"]
CUTLASS_INCLUDE = "/usr/local/cutlass/include"


def _tool_version(path: str) -> str:
    """The last line of ``path --version``, or why it could not run."""
    try:
        out = subprocess.run([path, "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"missing ({e})"
    return out.splitlines()[-1] if out else "ok"


def diagnose(create_dirs: bool = False, workdir: str = ".",
             device: DeviceLike = "cuda") -> dict:
    dev = resolve_device(device)
    report: dict = {"required": {}, "optional": {}, "devices": [], "ok": True}

    for mod in REQUIRED:
        try:
            m = importlib.import_module(mod)
            report["required"][mod] = getattr(m, "__version__", "ok")
        except ImportError as e:
            report["required"][mod] = f"MISSING ({e})"
            report["ok"] = False
    for mod in OPTIONAL:
        try:
            m = importlib.import_module(mod)
            report["optional"][mod] = getattr(m, "__version__", "ok")
        except ImportError:
            report["optional"][mod] = "missing (feature degraded)"

    report["torch_cuda"] = torch.version.cuda
    report["device"] = str(dev)
    if torch.cuda.is_available():
        report["devices"] = [torch.cuda.get_device_name(i)
                             for i in range(torch.cuda.device_count())]
        try:
            report["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True,
            ).stdout.strip().splitlines()
        except (OSError, subprocess.SubprocessError) as e:
            report["nvidia_smi"] = f"unavailable ({e})"
    nvcc = nvcc_path()
    report["nvcc"] = {"path": nvcc, "version": _tool_version(nvcc)}
    report["cutlass_headers"] = (CUTLASS_INCLUDE if os.path.isdir(CUTLASS_INCLUDE)
                                 else "missing")
    report["cxx_compiler"] = shutil.which("g++") or "missing"
    from rag_uq_tpu_torch.native import is_available

    report["native_runtime"] = "ok" if is_available() else "unavailable"
    if dev.type == "cuda" and not os.path.exists(nvcc):
        report["ok"] = False  # the kernels cannot be built on this card

    if create_dirs:
        for d in ("data/raw", "data/preprocessed", "models/router", "results"):
            Path(workdir, d).mkdir(parents=True, exist_ok=True)
        report["dirs_created"] = True
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Check the environment")
    parser.add_argument("--create-dirs", action="store_true")
    parser.add_argument("--workdir", default=".")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    report = diagnose(create_dirs=args.create_dirs, workdir=args.workdir,
                      device=args.device)
    print(json.dumps(report, indent=2))
    raise SystemExit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
