"""The latent-attention decode kernel's time on one card, beside its bound and
its plain twin; and, with ``--step``, the host's and the card's time a
decode step of the published generator.

Usage, from the root of a checkout:
    python3 -m rag_uq_tpu_torch.cli.profile_mla_decode [--prompts 32] [--group 10]
        [--heads 16] [--t 0 49 98] [--phases] [--step] [--out runs/profile_torch/mla_decode.json]

At each step t, over ``--prompts`` prompts of seeded lengths 1,100-1,400
(the generator's shape in the ``dsv2lite.mc_answer`` cell by default) with
``--group`` slots each: the kernel's CUDA-event time over 50 launches (the
item pass and the merge pass), its kernels' device time under
``torch.profiler``, the host's time to launch it (the wrapper's call, 50
calls back to back), the plain twin's time over 10 calls, the least time
the card could take (the larger of the bytes at 3.35 TB/s, each prompt's
latents read once, each slot's own, q and the output, and the products at
989 TFLOP/s), and the kernel's and the twin's error against float64. Prints
one JSON line a step, with the card's name and power limit, and the
compiler's register report.

``--step`` draws DeepSeek-V2-Lite at its published widths and runs calls of
``generate_batch_scored`` at the cell's shape (the prompts, group and 100
tokens above; temperature U(0.5, 1.2), top-p U(0.8, 0.95)): one to warm up,
one as it is (its seconds), one with the card idle before each decode step
(the host's ms to launch the step, and the ms until the card has run it),
one as the generator runs (the host's ms a step, its launches queued behind
the card's work); each with the host's ms of each layer's ``_attn_decode``
and expert layer, medians over the steps, and its seconds. Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from rag_uq_tpu_torch.cli.profile_cosine_topk import cuda_ms, device_split
from rag_uq_tpu_torch.llm.deepseek_v2 import DeepseekV2Config, DeepseekV2LM, softmax_scale
from rag_uq_tpu_torch.ops import mla_decode as mla
from rag_uq_tpu_torch.ops.cosine_topk import NVCC_FLAGS, nvcc_path
from rag_uq_tpu_torch.utils.build import build_shared_library

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return torch.cuda.get_device_name(0)


def bound_ms(lens, group: int, heads: int, t: int) -> float:
    slots = len(lens) * group
    positions = group * sum(lens) + slots * (t + 1)  # a row's keys, summed over slots
    nbytes = 2 * (mla.LATENT * (sum(lens) + slots * (t + 1))
                  + slots * heads * (mla.LATENT + mla.RANK))
    ops = 2.0 * heads * positions * (mla.LATENT + mla.RANK)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)


def cell_lens(prompts: int, seed: int) -> list:
    """Seeded prompt lengths in [1100, 1400], as the cell's retrieved contexts."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1100, 1401, (prompts,), generator=g).tolist()


def inputs(lens, group: int, heads: int, max_tokens: int, seed: int, device) -> tuple:
    """Seeded bf16 q [S, heads, 576], prompt [P, Lp, 576] (zero past each
    length, as the prefill leaves it), lens [P] and gen [S, max_tokens, 576]."""
    g = torch.Generator().manual_seed(seed)
    p, lp, s = len(lens), max(lens), len(lens) * group
    prompt = torch.randn((p, lp, mla.LATENT), generator=g)
    for i, n in enumerate(lens):
        prompt[i, n:] = 0
    prompt = prompt.to(device, torch.bfloat16)
    gen = torch.randn((s, max_tokens, mla.LATENT), generator=g).to(device, torch.bfloat16)
    q = (torch.randn((s, heads, mla.LATENT), generator=g) * 0.5).to(device, torch.bfloat16)
    return q, prompt, torch.tensor(lens, dtype=torch.long, device=device), gen


def errors(args_t) -> dict:
    """The kernel's and the plain twin's error against float64 (``row_err``)."""
    got = mla.cuda_mla_decode(*args_t)
    plain = mla.mla_decode_plain(*args_t)
    ref = mla.mla_decode_f64(*args_t)
    if not torch.isfinite(got.float()).all():
        raise AssertionError("the kernel wrote a value that is not finite")
    return {"kernel_err": mla.row_err(got, ref), "plain_err": mla.row_err(plain, ref)}


def measure(args_t, lens) -> dict:
    """One step t's row: times, bound, plan and errors (see the module's note)."""
    q, prompt, _, _, t, group, _, _ = args_t
    p, heads = len(lens), q.shape[1]
    kernel = cuda_ms(lambda: mla.cuda_mla_decode(*args_t), reps=50)
    plain = cuda_ms(lambda: mla.mla_decode_plain(*args_t), reps=10)
    host, split = device_split(lambda: mla.cuda_mla_decode(*args_t))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        mla.cuda_mla_decode(*args_t)
    enqueue = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    pl = mla.plan(p, group, heads, prompt.shape[1], t, mla.sm_count(q.device.index))
    row = {"t": t, "prompts": p, "group": group, "heads": heads, "Lp": prompt.shape[1],
           "kernel_ms": kernel, "bound_ms": bound_ms(lens, group, heads, t),
           "plain_ms": plain, "device_ms": split, "host_ms_a_launch": enqueue,
           "host_ms_a_launch_profiled": host, "plan": pl.__dict__,
           "items": pl.items(p, p * group), **errors(args_t), "card": card()}
    row["roofline_pct"] = 100.0 * row["bound_ms"] / kernel
    return row


PHASES = ("issue", "wait", "scores", "softmax", "values", "item")


def phases(args_t) -> dict:
    """Mean cycles a tile of each phase over 20 launches of a profiling
    build (thread 0 of each block; ``item`` is a block's whole item)."""
    built = build_shared_library("rag_mla_decode_profile", [mla.SOURCE],
                                 [nvcc_path(), *NVCC_FLAGS, "-DMLA_DECODE_PROFILE"],
                                 timeout_s=600)
    lib = ctypes.CDLL(str(built.path))
    lib.rag_mla_decode.argtypes = mla.ARGTYPES
    lib.rag_mla_decode_profile.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    counts = (ctypes.c_ulonglong * 8)()
    kept = mla._lib
    try:
        mla._lib = lib
        mla.cuda_mla_decode(*args_t)
        torch.cuda.synchronize()
        lib.rag_mla_decode_profile(counts)
        for _ in range(20):
            mla.cuda_mla_decode(*args_t)
        torch.cuda.synchronize()
        lib.rag_mla_decode_profile(counts)
    finally:
        mla._lib = kept
    tiles, blocks = max(counts[6], 1), max(counts[7], 1)
    out = {name: counts[i] / tiles for i, name in enumerate(PHASES[:5])}
    out["item"] = counts[5] / blocks
    out["tiles_a_block"] = tiles / blocks
    return out


def cell_call(lens, group: int, seed: int) -> tuple:
    """(prompts, temperatures, top-ps) of one call at the cell's shape: each
    prompt ``lens[i]`` seeded decimal words (one token each), ``group`` rows."""
    rng = np.random.default_rng(seed)
    texts = [" ".join(map(str, rng.integers(0, 100_000, n))) for n in lens]
    prompts = [text for text in texts for _ in range(group)]
    return (prompts, rng.uniform(0.5, 1.2, len(prompts)).tolist(),
            rng.uniform(0.8, 0.95, len(prompts)).tolist())


def _ms_median(xs) -> float:
    return 1e3 * statistics.median(xs) if xs else float("nan")


def step_probe(lm: DeepseekV2LM, call: tuple, max_tokens: int, seed: int) -> dict:
    """Three calls of ``lm.generate_batch_scored(*call)``: ``plain_call_s``,
    the seconds of one call as it is; ``synced`` (the card idle before each
    decode step: ``launch_ms`` to launch it, ``done_ms`` until the card has
    run it) and ``unsynced`` (as the generator runs: ``launch_ms``); each
    with ``attn_ms`` and ``moe_ms``, the host's ms of a layer's
    ``_attn_decode`` and expert layer, medians over its ``steps``, and the
    call's seconds, ``call_s``."""
    model = lm.model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm.generate_batch_scored(*call, max_tokens=max_tokens, seed=seed)
    torch.cuda.synchronize()
    out = {"plain_call_s": time.perf_counter() - t0}
    for synced in (True, False):
        launch, done, attn, moe = [], [], [], []
        step, attend, experts = model.decode_step, model._attn_decode, model._moe
        in_step = [False]

        def timed_step(*a):
            if synced:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            in_step[0] = True
            r = step(*a)
            in_step[0] = False
            launch.append(time.perf_counter() - t0)
            if synced:
                torch.cuda.synchronize()
                done.append(time.perf_counter() - t0)
            return r

        def timed_attn(*a):
            t0 = time.perf_counter()
            r = attend(*a)
            attn.append(time.perf_counter() - t0)
            return r

        def timed_moe(*a):
            t0 = time.perf_counter()
            r = experts(*a)
            if in_step[0]:
                moe.append(time.perf_counter() - t0)
            return r

        model.decode_step, model._attn_decode, model._moe = timed_step, timed_attn, timed_moe
        t0 = time.perf_counter()
        try:
            lm.generate_batch_scored(*call, max_tokens=max_tokens, seed=seed)
            torch.cuda.synchronize()
        finally:
            del model.decode_step, model._attn_decode, model._moe
        row = {"call_s": time.perf_counter() - t0, "steps": len(launch),
               "launch_ms": _ms_median(launch),
               "attn_ms": _ms_median(attn), "moe_ms": _ms_median(moe)}
        if synced:
            row["done_ms"] = _ms_median(done)
        out["synced" if synced else "unsynced"] = row
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompts", type=int, default=32)
    ap.add_argument("--group", type=int, default=10)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--t", type=int, nargs="+", default=[0, 49, 98])
    ap.add_argument("--max-tokens", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--phases", action="store_true",
                    help="also build with -DMLA_DECODE_PROFILE and print the cycles of "
                         "thread 0 of a block in each phase, a tile")
    ap.add_argument("--step", action="store_true",
                    help="also time the published generator's decode steps (host and card)")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    built = mla.build()
    print("\n".join(line for line in built.log.splitlines()
                    if "registers" in line or "spill" in line))
    lens = cell_lens(args.prompts, args.seed)
    q, prompt, lens_t, gen = inputs(lens, args.group, args.heads, args.max_tokens, args.seed,
                                    dev)
    scale = softmax_scale(DeepseekV2Config())
    rows = []
    for t in args.t:
        args_t = (q, prompt, lens_t, gen, t, args.group, scale, mla.RANK)
        row = measure(args_t, lens)
        if args.phases:
            row["phases"] = phases(args_t)
        rows.append(row)
        print(json.dumps(row))
    out = {"kernel": rows}
    if args.step:
        del q, prompt, gen
        lm = DeepseekV2LM(DeepseekV2Config(), seed=args.seed, device=dev)
        call = cell_call(lens, args.group, args.seed)
        lm.generate_batch_scored(*call, max_tokens=args.max_tokens, seed=args.seed)  # warm
        out["step"] = {**step_probe(lm, call, args.max_tokens, args.seed), "card": card()}
        print(json.dumps(out["step"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
