"""Build the port's native libraries at first use.

Libraries go to ``build/rag_uq_tpu_torch/`` at the root of the checkout (git
ignores ``build/``), or to the directory named by the environment variable
``RAG_UQ_TPU_TORCH_BUILD_DIR``. A library's file name carries a hash of its
sources, of every header they include by a quoted ``#include`` (found beside
the including file, transitively), and of its compiler command, so a stale
library is never loaded. The
compiler writes to a temporary name that ``os.replace`` moves into place:
there is no lock file, so nothing ever waits on one left by a cut-off build.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

BUILD_DIR_ENV = "RAG_UQ_TPU_TORCH_BUILD_DIR"
_REPO_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rag_uq_tpu_torch"


class BuildError(RuntimeError):
    """The compiler failed; the message carries its output."""


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float  # compile time; 0.0 when the library was already built
    log: str  # the compiler's output from the build that made the library


def build_dir() -> Path:
    return Path(os.environ.get(BUILD_DIR_ENV) or _REPO_BUILD_DIR)


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(sources: Sequence[Path]) -> List[Path]:
    """The headers that ``sources`` include with quotes, transitively, each
    resolved beside the file that includes it, in first-seen order."""
    seen: List[Path] = []
    todo = [Path(s) for s in sources]
    while todo:
        src = todo.pop(0)
        for name in _LOCAL_INCLUDE.findall(src.read_bytes()):
            header = (src.parent / name.decode()).resolve()
            if header.exists() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(name: str, sources: Sequence[Path], command: Sequence[str]) -> Path:
    """Where the library of these sources, their headers and this command goes."""
    digest = hashlib.sha256(" ".join(command).encode())
    for src in [*map(Path, sources), *local_headers(sources)]:
        digest.update(src.read_bytes())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_shared_library(
    name: str, sources: Sequence[Path], command: Sequence[str], timeout_s: float
) -> Built:
    """Compile ``sources`` with ``command + [-o out] + sources`` unless built.

    ``command`` is the compiler and its flags. The compiler's output is kept
    beside the library (``.log``) so a later caller can still read it.
    """
    out = library_path(name, sources, command)
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Built(out, 0.0, log)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [*command, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True, timeout=timeout_s,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"building {name} failed: {e}") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"building {name} failed ({proc.returncode}):\n{log}")
    log_tmp = log_path.with_name(tmp.name + ".log")
    log_tmp.write_text(log)
    os.replace(log_tmp, log_path)
    os.replace(tmp, out)
    return Built(out, seconds, log)
