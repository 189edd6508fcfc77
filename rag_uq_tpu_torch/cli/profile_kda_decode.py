"""The KDA decode kernel's time on one card, beside its bound and its plain
twin; and, with ``--call``, one call of the published Kimi Linear generator
at the ``kimilinear.mc_answer`` cell's shape.

Usage, from the root of a checkout:
    python3 -m rag_uq_tpu_torch.cli.profile_kda_decode [--rows 320] [--heads 32] [--call]
        [--out runs/profile_torch/kda_decode.json]

At ``--rows`` slots of ``--heads`` heads of 128 channels (the generator's
decode step by default: 32 prompts x 10 slots, 32 heads): the kernel's
CUDA-event time over 50 launches, the plain twin's over 10, the least time
the card could take (``bound_ms``: each state read and written once, the
projections, the conv tails, the output, at 3.35 TB/s), and the kernel's
and the twin's errors against float64 (``errors``). Prints one JSON line
with the card's name and power limit and the compiler's register report.

``--call`` draws the published model on the card, with the expert share of
``benchmark/configs/kimi-linear-48b-a3b.json`` (64 of 256 experts), and runs
``generate_batch_scored`` at the cell's shape twice: its seconds, decode
steps, the kernel's launches a call and the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from rag_uq_tpu_torch.cli.profile_cosine_topk import cuda_ms
from rag_uq_tpu_torch.cli.profile_mla_decode import card, cell_call, cell_lens
from rag_uq_tpu_torch.ops import kda
from rag_uq_tpu_torch.ops.mla_decode import row_err

HBM_BYTES_PER_S = 3.35e12
EPS = 1e-5  # the published rms_norm_eps
# The cell's deployment: four chips share each expert layer, this is rank 0.
EXPERT_SHARE = {"num_experts": 64, "expert_parallel": {"experts": 256, "ranks": 4, "rank": 0}}


def bound_ms(rows: int, heads: int, kd: int = kda.HEAD) -> float:
    """The step's least time: bytes at the HBM peak (it does no work to speak of)."""
    hk = heads * kd
    nbytes = (8 * rows * heads * kd * kd            # the state, read and written, f32
              + 2 * rows * (3 * hk                  # x
                            + 2 * (kda.TAPS - 1) * 3 * hk  # the tail, read and written
                            + 3 * hk + heads)        # f, gate, out; beta
              + 2 * 3 * hk * kda.TAPS + 4 * (hk + heads) + 2 * kd)  # conv_w, dt_bias, A_log, norm_w
    return 1e3 * nbytes / HBM_BYTES_PER_S


def inputs(rows: int, heads: int, seed: int, device, kd: int = kda.HEAD) -> tuple:
    """Seeded arguments of ``kda_decode`` as the generator passes them: x, f,
    beta and gate as column slices of one projection row (f and gate from
    their own products), bf16; A_log, dt_bias and the state float32."""
    g = torch.Generator().manual_seed(seed)
    hk = heads * kd
    bf = lambda t: t.to(device, torch.bfloat16)
    proj = bf(torch.randn((rows, 3 * hk + 2 * kd + heads), generator=g))
    x, _, _, beta = proj.split([3 * hk, kd, kd, heads], dim=-1)
    tail = bf(torch.randn((rows, kda.TAPS - 1, 3 * hk), generator=g))
    conv_w = bf(torch.rand((3 * hk, kda.TAPS), generator=g) - 0.5)
    f = bf(torch.randn((rows, hk), generator=g) * 0.3)
    gate = bf(torch.randn((rows, hk), generator=g))
    a_log = torch.log(torch.rand(heads, generator=g) * 15 + 1).to(device)
    dt = torch.exp(torch.rand(hk, generator=g) * 4.6 - 6.9)
    dt_bias = (dt + torch.log(-torch.expm1(-dt))).to(device)
    norm_w = bf(1 + 0.1 * torch.randn(kd, generator=g))
    state = (torch.randn((rows, heads, kd, kd), generator=g) * 0.1).to(device)
    return x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state, EPS


def errors(args_t) -> dict:
    """The kernel's and the plain twin's errors against float64 from the
    same inputs: of the output (``row_err``) and of the new state (its widest
    |difference| over its RMS); and whether both moved the conv tail alike."""
    x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state, eps = args_t
    ref_out, ref_state = kda.kda_decode_f64(*args_t)
    k_tail, k_state = tail.clone(), state.clone()
    got = kda.cuda_kda_decode(x, k_tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w,
                              k_state, eps)
    p_tail, p_state = tail.clone(), state.clone()
    plain = kda.kda_decode_plain(x, p_tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w,
                                 p_state, eps)
    torch.cuda.synchronize()
    if not (torch.isfinite(got.float()).all() and torch.isfinite(k_state).all()):
        raise AssertionError("the kernel wrote a value that is not finite")
    rms = float(ref_state.pow(2).mean().sqrt())
    return {"kernel_err": row_err(got, ref_out), "plain_err": row_err(plain, ref_out),
            "kernel_state_err": float((k_state.double() - ref_state).abs().max()) / rms,
            "plain_state_err": float((p_state.double() - ref_state).abs().max()) / rms,
            "tail_equal": bool(torch.equal(k_tail, p_tail))}


def measure(args_t) -> dict:
    rows, heads = args_t[0].shape[0], args_t[4].shape[0]
    tail, state = args_t[1].clone(), args_t[9].clone()
    run = (args_t[0], tail, *args_t[2:9], state, args_t[10])
    kernel = cuda_ms(lambda: kda.cuda_kda_decode(*run), reps=50)
    plain = cuda_ms(lambda: kda.kda_decode_plain(*run), reps=10)
    row = {"rows": rows, "heads": heads, "kernel_ms": kernel,
           "bound_ms": bound_ms(rows, heads), "plain_ms": plain, **errors(args_t),
           "card": card()}
    row["roofline_pct"] = 100.0 * row["bound_ms"] / kernel
    return row


def generator_call(seed: int, max_tokens: int = 100) -> dict:
    """The published generator with the cell's expert share: two calls at
    the cell's shape."""
    from rag_uq_tpu_torch.llm.kimi_linear import KimiLinearConfig, KimiLinearLM
    from rag_uq_tpu_torch.utils import profiling

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = KimiLinearLM(KimiLinearConfig(**EXPERT_SHARE), seed=seed, device="cuda")
    torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t0, "params": lm.model.num_params(),
           "weights_bytes": torch.cuda.memory_allocated()}
    call = cell_call(cell_lens(32, seed), 10, seed)
    lm.generate_batch_scored(*call, max_tokens=max_tokens, seed=seed)
    torch.cuda.synchronize()
    kda.cuda_kda_decode.launches = 0
    profiling.take()
    profiling.enable()
    try:
        t0 = time.perf_counter()
        lm.generate_batch_scored(*call, max_tokens=max_tokens, seed=seed)
        torch.cuda.synchronize()
        out["call_s"] = time.perf_counter() - t0
        counters = profiling.take()["counters"]
    finally:
        profiling.disable()
    out.update(stats=lm.last_stats, counters=counters, launches=kda.cuda_kda_decode.launches,
               peak_bytes=torch.cuda.max_memory_allocated())
    out["stats"].pop("prompt_lens")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=320)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--call", action="store_true")
    ap.add_argument("--out", default="runs/profile_torch/kda_decode.json")
    args = ap.parse_args(argv)
    built = kda.build()
    row = {"ptxas": [ln.strip() for ln in built.log.splitlines()
                     if "Used" in ln or "spill" in ln],
           **measure(inputs(args.rows, args.heads, args.seed, "cuda"))}
    if args.call:
        row["call"] = generator_call(args.seed)
    print(json.dumps(row), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(row, indent=1))


if __name__ == "__main__":
    main()
