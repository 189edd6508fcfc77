"""Read the control beside the program, on a CUDA card, for the limits of ``correct``.

    python3 -m benchmark.control --workload <cell> --seconds <s> --seeds n1 n2 ...

For each seed, one run of the cell as the benchmark runs it (a shorter
window is enough: the judged sample is the same size), then the control on
the same queries: the reference in the precision below the configuration's
(float8 e4m3 for its bfloat16 storage and models), put in the port's place.
Prints one JSON line a seed with the program's compared numbers and the
control's. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    from benchmark.run import ROOT, run_cell

    os.environ.setdefault("RAG_UQ_TPU_TORCH_BUILD_DIR", str(ROOT / "build" / "rag_uq_tpu_torch"))
    for seed in args.seeds:
        out = run_cell(args.workload, seed, args.seconds, False, control=True,
                       t_origin=time.perf_counter())
        row = {"seed": seed, "correct": out["correct"],
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": {k[len("control."):]: v for k, v in out["_extra"].items()
                           if k.startswith("control.")},
               "extra": {k: v for k, v in out["_extra"].items()
                         if not k.startswith("control.")},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
