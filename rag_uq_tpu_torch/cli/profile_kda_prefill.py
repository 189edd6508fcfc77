"""The KDA prefill kernel's time on one card, beside its bound and the plain
chunked form, and the errors of both against the recurrence in float64.

Usage, from the root of a checkout:
    python3 -m rag_uq_tpu_torch.cli.profile_kda_prefill [--prompts 32] [--heads 32]
        [--seed 0] [--out runs/profile_torch/kda_prefill.json]

At ``--prompts`` prompts of seeded lengths in [1100, 1400] (the
``kimilinear.mc_answer`` cell's contexts), padded to the longest as the
prefill pads them, times ``--heads`` heads of 128 channels (by default the
cell's 1,024 sequences): the kernel's CUDA-event time over 10 launches
(``kernel_ms``), the plain chunked form's over 2 (``plain_ms``), and the
least time the card could take (``bound_ms``), the larger of

- the bytes: q, k, v and g read once (4 T K floats a sequence), beta read
  once, o written once and the end state (K V floats) written once, at
  3.35 TB/s;
- the operations: the recurrence's 7 K V float32 operations a token and
  sequence (the decay, S^T k, the rank-one update, S^T q), at the card's
  67 TFLOP/s of float32 outside the tensor cores;

and the errors of the kernel and of the plain form against
``kda_recurrent`` in float64 (``errors``). Prints one JSON line with the
card's name and power limit and the compiler's register report.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch
import torch.nn.functional as F

from rag_uq_tpu_torch.cli.profile_cosine_topk import cuda_ms
from rag_uq_tpu_torch.cli.profile_mla_decode import card, cell_lens
from rag_uq_tpu_torch.ops import kda

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# The checked shapes: (name, prompt lengths or None for the cell's, heads,
# largest log decay a position or None for the gate's initialisers).
CASES = (("cell", None, 32, None), ("one_sequence", [77], 1, 8.0),
         ("two_heads", [45, 333, 1000], 2, 8.0))


def bound_ms(seqs: int, tokens: int, kd: int = kda.HEAD) -> float:
    """The launch's least time: the larger of its bytes and its operations."""
    nbytes = 4 * seqs * tokens * (5 * kd + 1) + 4 * seqs * kd * kd
    ops = 7 * seqs * tokens * kd * kd
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)


def inputs(lens, heads: int, seed: int, device, max_decay=None) -> tuple:
    """Seeded float32 q, k, v, g [P H, T, 128] and beta [P H, T], prompt by
    prompt and head by head as the prefill passes them (T the longest of
    ``lens``): q and k L2-normalised, q scaled by 128 ** -0.5, v of unit
    scale, beta = sigmoid of a normal; g the gate's log decays from fla's
    initialisers (A_log = log U(1, 16), dt log-uniform in [1e-3, 0.1]) or,
    with ``max_decay``, uniform in [-max_decay, 0]. Positions past a
    prompt's length hold g = 0 and beta = 0 beside random q, k, v."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p, t, kd = len(lens), max(lens), kda.HEAD
    r = lambda *shape: torch.randn(shape, generator=gen, device=device)
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)
    q = kda.l2norm(r(p * heads, t, kd)) * kd ** -0.5
    k = kda.l2norm(r(p * heads, t, kd))
    v = r(p * heads, t, kd)
    if max_decay is None:
        a_log = torch.log(u(heads) * 15 + 1)
        dt = torch.exp(u(heads, 1, kd) * 4.6 - 6.9)
        dt_bias = dt + torch.log(-torch.expm1(-dt))
        g = -a_log.exp()[:, None, None] * F.softplus(0.3 * r(p, heads, t, kd) + dt_bias)
    else:
        g = -max_decay * u(p, heads, t, kd)
    beta = torch.sigmoid(r(p, heads, t))
    live = (torch.arange(t, device=device) < torch.tensor(lens, device=device)[:, None])
    g = (g * live[:, None, :, None]).reshape(p * heads, t, kd)
    beta = (beta * live[:, None, :]).reshape(p * heads, t)
    return q, k, v, g, beta


def case_inputs(name: str, seed: int, device) -> tuple:
    """``inputs`` of the case ``name`` of ``CASES``."""
    _, lens, heads, decay = next(c for c in CASES if c[0] == name)
    return inputs(lens or cell_lens(32, seed), heads, seed, device, max_decay=decay)


def _err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest |x - ref| over the RMS of all of ref."""
    ref = ref.double()
    return float((x.double() - ref).abs().max() / ref.pow(2).mean().sqrt())


def errors(args_t) -> dict:
    """The kernel's and the plain chunked form's output and end state
    against ``kda_recurrent`` in float64 from the same inputs, and the
    kernel's against the plain form's (each over the RMS of the second)."""
    ref_o, ref_s = kda.kda_recurrent(*(x.double() for x in args_t))
    got_o, got_s = kda.cuda_kda_prefill(*args_t)
    torch.cuda.synchronize()
    if not (torch.isfinite(got_o).all() and torch.isfinite(got_s).all()):
        raise AssertionError("the kernel wrote a value that is not finite")
    plain_o, plain_s = kda.kda_chunked_plain(*args_t)
    return {"kernel_err": _err(got_o, ref_o), "kernel_state_err": _err(got_s, ref_s),
            "plain_err": _err(plain_o, ref_o), "plain_state_err": _err(plain_s, ref_s),
            "vs_plain_err": _err(got_o, plain_o), "vs_plain_state_err": _err(got_s, plain_s)}


def padded_tail_equal(args_t, pad: int = 37) -> bool:
    """The kernel over the inputs and over the same with ``pad`` positions
    of g = 0, beta = 0 (random q, k, v) after them: the same outputs on the
    real positions and the same end states, bit for bit."""
    q, k, v, g, beta = args_t
    o, s = kda.cuda_kda_prefill(*args_t)
    more = lambda x, fill: torch.cat([x, fill(x[:, :pad])], 1).contiguous()
    po, ps = kda.cuda_kda_prefill(more(q, torch.randn_like), more(k, torch.randn_like),
                                  more(v, torch.randn_like), more(g, torch.zeros_like),
                                  more(beta, torch.zeros_like))
    return bool(torch.equal(ps, s) and torch.equal(po[:, : q.shape[1]], o))


def measure(args_t) -> dict:
    seqs, tokens = args_t[0].shape[:2]
    kernel = cuda_ms(lambda: kda.cuda_kda_prefill(*args_t), reps=10)
    plain = cuda_ms(lambda: kda.kda_chunked_plain(*args_t), reps=2)
    row = {"seqs": seqs, "tokens": tokens, "kernel_ms": kernel,
           "bound_ms": bound_ms(seqs, tokens), "plain_ms": plain, "card": card()}
    row["roofline_pct"] = 100.0 * row["bound_ms"] / kernel
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompts", type=int, default=32)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/profile_torch/kda_prefill.json")
    args = ap.parse_args(argv)
    built = kda.build()
    args_t = inputs(cell_lens(args.prompts, args.seed), args.heads, args.seed, "cuda")
    row = {"ptxas": [ln.strip() for ln in built.log.splitlines()
                     if "Used" in ln or "spill" in ln or "entry function" in ln],
           **measure(args_t), **errors(args_t), "padded_tail_equal": padded_tail_equal(args_t)}
    print(json.dumps(row), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(row, indent=1))


if __name__ == "__main__":
    main()
