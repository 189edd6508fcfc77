"""Where the dense pool kernel's time goes, phase by phase, on one card.

Usage, from the root of a checkout:  python3 -m rag_uq_tpu_torch.cli.profile_cosine_topk

Builds the kernel with ``-DCOSINE_TOPK_PROFILE`` (clock64 counters in each
consumer warp; the normal build has none) and launches it at the main
path's shape (B = 2048, 100000 live rows of a 131072-row index, D = 768,
bf16) for each k given. Prints, per consumer warp, the mean cycles spent in
the products with their waits on the TMA ring, the first tile's upkeep,
the other tiles' upkeep, and the final sort and write, with each phase's
share. The counters add a few instructions a tile, so the normal build's
time (``chip_smoke.py``) is the kernel's time; this gives the split.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from rag_uq_tpu_torch.ops import cosine_topk as ck

PHASES = ("products+ring", "first-tile upkeep", "other upkeep", "final sort+write")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[50])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on the card")
    lib, _ = ck.load_library("rag_cosine_topk_profile", (*ck.NVCC_FLAGS, "-DCOSINE_TOPK_PROFILE"))
    lib.rag_cosine_topk_profile.argtypes = [ctypes.c_void_p]
    lib.rag_cosine_topk_profile.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    emb = torch.randn((131_072, 768), generator=gen, device="cuda")
    q = torch.randn((2048, 768), generator=gen, device="cuda")
    emb = (emb / emb.norm(dim=1, keepdim=True)).bfloat16()
    q = q / q.norm(dim=1, keepdim=True)
    counters = (ctypes.c_ulonglong * 5)()
    saved = ck._lib
    ck._lib = lib  # launch through the wrapper, with the profiling build
    try:
        print(f"device {torch.cuda.get_device_name(0)}", flush=True)
        for k in args.k:
            ck.cuda_cosine_topk(emb, q, 100_000, k)
            torch.cuda.synchronize()
            lib.rag_cosine_topk_profile(ctypes.addressof(counters))  # zero them
            ck.cuda_cosine_topk(emb, q, 100_000, k)
            torch.cuda.synchronize()
            if lib.rag_cosine_topk_profile(ctypes.addressof(counters)) != 0:
                raise RuntimeError("reading the profile counters failed")
            warps = counters[4]
            total = sum(counters[:4])
            parts = ", ".join(
                f"{name} {counters[i] / warps:.0f} ({counters[i] / total:.1%})"
                for i, name in enumerate(PHASES)
            )
            print(f"k={k}: {warps} consumer warps; cycles a warp: {parts}", flush=True)
    finally:
        ck._lib = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
