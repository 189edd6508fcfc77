"""Where the dense pool kernel's time goes, phase by phase, on one card.

Usage, from the root of a checkout:
    python3 -m rag_uq_tpu_torch.cli.profile_cosine_topk [--k 50 128] [--batch 2048]
        [--live 100000] [--dim 768]

Builds the kernel with ``-DCOSINE_TOPK_PROFILE`` (clock64 counters in each
consumer warp; the normal build has none) and launches it on ``--batch``
queries over ``--live`` rows of a bf16 index of D = ``--dim`` (capacity the
next power of two, as ``DenseIndex`` grows; by default the main path's
shape, B = 2048 over 100000 of 131072 rows, D = 768) for each k given.
Prints the plan, then, per consumer warp that holds a live query, the mean
cycles spent in the products with their waits on the TMA ring, the first
tile's upkeep, the other tiles' upkeep, and the write of its lists, with
each phase's share. The counters add a few instructions a tile, so the
normal build gives the times: CUDA events over 20 launches (the whole
launch; the merge pass alone on the chunks' lists, the plain twin over each
chunk; ``torch.matmul`` + ``torch.topk``), and ``torch.profiler`` over 20
launches for each kernel's device time and the host's time a launch.
"""

from __future__ import annotations

import argparse
import ctypes
import time

import torch

from rag_uq_tpu_torch.ops import cosine_topk as ck

PHASES = ("products+ring", "first-tile upkeep", "other upkeep", "write")
REPS = 20


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_split(fn, reps: int = REPS) -> tuple:
    """fn() reps times under torch.profiler: (host ms a call, {kernel name:
    device ms a call}); the names are cut at their template arguments."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0]
            name = name.split("::")[-1].replace("void ", "")
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return host / reps * 1e3, by_name


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[50])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--live", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on the card")
    ck.build()
    lib, _ = ck.load_library("rag_cosine_topk_profile", (*ck.NVCC_FLAGS, "-DCOSINE_TOPK_PROFILE"))
    lib.rag_cosine_topk_profile.argtypes = [ctypes.c_void_p]
    lib.rag_cosine_topk_profile.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cap = 1 << max(args.live - 1, 0).bit_length()
    emb = torch.randn((cap, args.dim), generator=gen, device="cuda")
    q = torch.randn((args.batch, args.dim), generator=gen, device="cuda")
    emb = (emb / emb.norm(dim=1, keepdim=True)).bfloat16()
    q = q / q.norm(dim=1, keepdim=True)
    live = args.live
    n_sm = ck.sm_count(emb.device.index)
    counters = (ctypes.c_ulonglong * 5)()
    normal = ck._lib
    print(f"device {torch.cuda.get_device_name(0)}; B = {args.batch}, {live} live of {cap} "
          f"rows, D = {args.dim}, bf16", flush=True)
    for k in args.k:
        p = ck.plan(emb.dtype, k, args.batch, live, n_sm)
        print(f"k={k}: plan query tile {p.config.query_tile}, {p.config.stages} stages, "
              f"{p.n_chunks} chunks of {p.chunk_rows} rows", flush=True)
        ck._lib = lib  # launch through the wrapper, with the profiling build
        try:
            ck.cuda_cosine_topk(emb, q, live, k)
            torch.cuda.synchronize()
            lib.rag_cosine_topk_profile(ctypes.addressof(counters))  # zero them
            ck.cuda_cosine_topk(emb, q, live, k)
            torch.cuda.synchronize()
            if lib.rag_cosine_topk_profile(ctypes.addressof(counters)) != 0:
                raise RuntimeError("reading the profile counters failed")
        finally:
            ck._lib = normal
        warps = max(counters[4], 1)
        total = max(sum(counters[:4]), 1)
        parts = ", ".join(
            f"{name} {counters[i] / warps:.0f} ({counters[i] / total:.1%})"
            for i, name in enumerate(PHASES)
        )
        print(f"  {counters[4]} live consumer warps; cycles a warp: {parts}", flush=True)
        part_v, part_i = ck.chunk_lists_plain(emb, q, live, k, p.chunk_rows)
        kernel_ms = cuda_ms(lambda: ck.cuda_cosine_topk(emb, q, live, k))
        merge_ms = cuda_ms(lambda: ck.merge_pass(part_v, part_i, k))
        live_e, q16 = emb[:live], q.bfloat16()
        library_ms = cuda_ms(lambda: torch.topk(torch.matmul(q16, live_e.T), k))
        print(f"  CUDA events, a launch: kernel {kernel_ms:.4f} ms; the merge pass alone on "
              f"the chunks' lists {merge_ms:.4f} ms; torch.matmul + torch.topk "
              f"{library_ms:.4f} ms", flush=True)
        host_ms, device = device_split(lambda: ck.cuda_cosine_topk(emb, q, live, k))
        split = ", ".join(f"{n} {t:.4f} ms" for n, t in device.items()) or "not measured"
        print(f"  torch.profiler, a launch: host {host_ms:.4f} ms; device {split}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
