"""Kimi Delta Attention (KDA): the gated delta rule with a per-channel decay,
its chunked prefill, and the decode step as the CUDA kernel
``csrc/kda_decode.cu`` beside its plain twin.

The recurrence (Kimi Linear, arXiv:2510.26692, §3; fla's
``naive_recurrent_kda``), per head, with the state S [K, V] in float32 and
S_0 = 0::

    S_t = Diag(exp g_t) S_{t-1}
    S_t = S_t + beta_t k_t (v_t - S_t^T k_t)^T
    o_t = S_t^T q_t

q and k are L2-normalised over the head's K channels (``l2norm``: fla's
``x / sqrt(sum x^2 + 1e-6)``) and q is scaled by K ** -0.5; g_t [K] <= 0 is
the log decay (``kda_gate``) and beta_t in (0, 1).

- ``kda_recurrent``: token by token, the definition (the tests' yardstick).
- ``kda_chunked_plain``: the prefill's chunked form of the same recurrence.
  Within a chunk of C tokens with cumulative log decays b_t (a running sum
  of g inside the chunk), the pseudo-values W = (I + A)^-1 (beta V - beta
  (K * exp b) S_0) with A_ts = beta_t sum_c k_tc k_sc exp(b_tc - b_sc) for
  s < t, the outputs (Q * exp b) S_0 + M W with M_ts = sum_c q_tc k_sc
  exp(b_tc - b_sc) for s <= t, and the chunk's end state exp(b_C) S_0 +
  (K * exp(b_C - b))^T W. The pairwise [C, C, K] decays are formed from
  differences b_t - b_s with s <= t only, so every exponent is <= 0.
- ``cuda_kda_prefill``: the prefill as the CUDA kernel
  ``csrc/kda_prefill.cu`` (``kda_prefill_kernel``): ``kda_recurrent``'s
  order token by token, each sequence's float32 state in registers from
  its first token to its last, every input read once, each output row and
  end state written once. ``kda_chunked`` takes the chunked form for a
  tensor on the CPU and the kernel for a CUDA tensor, with no fallback.
- ``kda_decode_plain`` / ``cuda_kda_decode``: one decode step of a layer's
  slots from the projections on: the short convolution over each slot's
  conv tail and the new input, SiLU, the L2 norms, the gate, beta, the
  decay, the delta update and the readout, and the output's gated RMSNorm
  (``rms_norm(o) * w * sigmoid(gate)``, over a head's V channels). The
  state and the conv tail are updated in place. ``kda_decode`` takes the
  twin for a tensor on the CPU and the kernel for a CUDA tensor; the kernel
  never falls back. It reads and writes each state once.

The decode kernel's sums run in another order than the twin's; otherwise
both compute in float32 from the same bf16 inputs and round the output
once. The prefill takes float32 inputs and computes in float32 on both
paths, in another order of sums.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rag_uq_tpu_torch.ops.cosine_topk import NVCC_FLAGS, nvcc_path
from rag_uq_tpu_torch.utils import profiling
from rag_uq_tpu_torch.utils.build import Built, build_shared_library

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "kda_decode.cu", CSRC / "kda_prefill.cu")  # one library
HEAD = 128  # the kernel's key and value width of a head
TAPS = 4  # the short convolution's width
CHUNK = 32  # tokens a chunk of the chunked prefill
L2_EPS = 1e-6  # fla's l2norm
# The prefill kernel's widest error against the recurrence in float64 and
# against the chunked form in float32, over the RMS of all the values
# compared: float32 roundings of a state carried over up to 1,400
# positions, in another order of sums. At the cell's prefill the kernel
# reads 1.5e-5 (outputs) and 2.7e-5 (end states) against float64, the
# chunked form up to 1.2e-5 at the edges; a wrong recurrence reads O(1).
PREFILL_TOL = 1e-4

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# rag_kda_decode's arguments: x, x_ld, tail, conv_w, f, f_ld, a_log, dt_bias,
# beta, beta_ld, gate, gate_ld, norm_w, state, out; rows, heads; eps; stream.
ARGTYPES = [_P, _L, _P, _P, _P, _L, _P, _P, _P, _L, _P, _L, _P, _P, _P, _I, _I,
            ctypes.c_float, _P]
# rag_kda_prefill's: q, k, v, g, beta, out, state; sequences, tokens; stream.
PREFILL_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_built: Optional[Built] = None


# -- the arithmetic -------------------------------------------------------------------

def l2norm(x: torch.Tensor) -> torch.Tensor:
    """x over its last dimension's L2 norm, in float32."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def kda_gate(f: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """The log decay ``-exp(A_log[h]) * softplus(f + dt_bias)`` [..., H, K]
    f32, from the low-rank projection f [..., H, K], A_log [H] and dt_bias
    [H, K]."""
    return -a_log.float().exp()[:, None] * F.softplus(f.float() + dt_bias.float())


def short_conv(window: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution: window [..., TAPS, C] (the
    inputs at t - 3 .. t), weight [C, TAPS] -> [..., C] f32."""
    return F.silu((window.float() * weight.t().float()).sum(-2))


def conv_prefill(xpad: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``short_conv`` at every position of padded sequences: xpad [P, TAPS
    - 1 + L, C] (zeros before each sequence), weight [C, TAPS] -> [P, L, C]
    f32, one tap at a time."""
    lp = xpad.shape[1] - (TAPS - 1)
    w = weight.float()
    acc = xpad[:, :lp].float() * w[:, 0]
    for i in range(1, TAPS):
        acc.addcmul_(xpad[:, i : i + lp].float(), w[:, i])
    return F.silu(acc, inplace=True)


def kda_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  beta: torch.Tensor, state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence token by token: q, k, g [B, T, K], v [B, T, V], beta
    [B, T] (q and k normalised, q scaled), state [B, K, V] (zeros if None)
    -> (o [B, T, V], the end state), in float32, or in float64 for float64 q."""
    b, t, kd = q.shape
    dt = torch.promote_types(q.dtype, torch.float32)
    s = q.new_zeros((b, kd, v.shape[-1]), dtype=dt) if state is None \
        else state.to(dt, copy=True)
    out = []
    for i in range(t):
        s = s * g[:, i].to(dt).exp()[..., None]
        ki = k[:, i].to(dt)
        w = beta[:, i, None].to(dt) * (v[:, i].to(dt) - torch.einsum("bk,bkv->bv", ki, s))
        s = s + ki[..., None] * w[:, None, :]
        out.append(torch.einsum("bk,bkv->bv", q[:, i].to(dt), s))
    return torch.stack(out, 1), s


def kda_chunked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                      beta: torch.Tensor, chunk: int = CHUNK
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kda_recurrent`` from S_0 = 0 in chunks of ``chunk`` tokens (float32
    inputs): (o [B, T, V], the end state [B, K, V]). A position with g = 0
    and beta = 0 leaves the state as it is, so padding at the end of a
    sequence does not move its end state."""
    b, t, kd = q.shape
    vd = v.shape[-1]
    state = q.new_zeros((b, kd, vd))
    out = q.new_empty((b, t, vd))
    for lo in range(0, t, chunk):
        hi = min(lo + chunk, t)
        c = hi - lo
        qc, kc, vc, bc = q[:, lo:hi], k[:, lo:hi], v[:, lo:hi], beta[:, lo:hi]
        cum = g[:, lo:hi].cumsum(1)                                  # [B, C, K]
        lower = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
        # exp(b_t - b_s) for s <= t, 0 above the diagonal: exponents <= 0.
        decay = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill_(
            ~lower[None, :, :, None], float("-inf")).exp_()          # [B, t, s, K]
        decay.mul_(kc[:, None, :, :])                                # k_s exp(b_t - b_s)
        a = torch.matmul(decay, kc[..., None]).squeeze(-1)           # [B, t, s]
        a = (a * bc[:, :, None]).tril_(-1)
        m = torch.matmul(decay, qc[..., None]).squeeze(-1)           # [B, t, s], s <= t
        del decay
        eb = cum.exp()
        rhs = bc[..., None] * (vc - torch.matmul(kc * eb, state))
        eye = torch.eye(c, dtype=q.dtype, device=q.device)
        w = torch.linalg.solve_triangular(a + eye, rhs, upper=False, unitriangular=True)
        out[:, lo:hi] = torch.matmul(qc * eb, state) + torch.matmul(m, w)
        last = cum[:, -1]
        state = last.exp()[..., None] * state + torch.matmul(
            (kc * (last[:, None, :] - cum).exp()).transpose(1, 2), w)
    return out, state


def gated_norm(o: torch.Tensor, norm_w: torch.Tensor, gate: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The output's ``rms_norm(o) * norm_w * sigmoid(gate)`` over each head's
    channels: o, gate [..., H, V] -> [..., H, V] f32."""
    return F.rms_norm(o.float(), (o.shape[-1],), norm_w.float(), eps) * torch.sigmoid(
        gate.float())


def _check_decode(x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state):
    s, width = x.shape
    h = a_log.shape[0]
    kd = width // (3 * h)
    if width != 3 * h * kd or state.shape != (s, h, kd, kd) or tail.shape != (s, TAPS - 1,
                                                                            width):
        raise ValueError(f"shapes x {tuple(x.shape)}, tail {tuple(tail.shape)}, state "
                         f"{tuple(state.shape)}, {h} heads")
    if conv_w.shape != (width, TAPS) or f.shape != (s, h * kd) or gate.shape != (s, h * kd) \
            or beta.shape != (s, h) or dt_bias.shape != (h * kd,) or norm_w.shape != (kd,):
        raise ValueError(f"shapes conv_w {tuple(conv_w.shape)}, f {tuple(f.shape)}, gate "
                         f"{tuple(gate.shape)}, beta {tuple(beta.shape)}, dt_bias "
                         f"{tuple(dt_bias.shape)}, norm_w {tuple(norm_w.shape)}")
    return s, h, kd


def kda_decode_plain(x: torch.Tensor, tail: torch.Tensor, conv_w: torch.Tensor,
                     f: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
                     beta: torch.Tensor, gate: torch.Tensor, norm_w: torch.Tensor,
                     state: torch.Tensor, eps: float) -> torch.Tensor:
    """One decode step of S slots: x [S, 3 H K] (the q, k, v projections
    before the convolution), tail [S, TAPS - 1, 3 H K] (each slot's last
    inputs, updated), conv_w [3 H K, TAPS], f [S, H K] (the decay's low-rank
    projection), A_log [H], dt_bias [H K], beta [S, H] (logits), gate [S, H
    K] (the output gate's logits), norm_w [K], state [S, H, K, V] f32
    (updated) -> the gated, normed output [S, H V] in x's dtype."""
    s, h, kd = _check_decode(x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state)
    window = torch.cat([tail, x[:, None]], dim=1)
    c = short_conv(window, conv_w).view(s, 3, h, kd)
    tail.copy_(window[:, 1:])
    q, k, v = l2norm(c[:, 0]) * kd ** -0.5, l2norm(c[:, 1]), c[:, 2]
    st = state * kda_gate(f.view(s, h, kd), a_log, dt_bias.view(h, kd)).exp()[..., None]
    w = torch.sigmoid(beta.float())[..., None] * (v - torch.einsum("shk,shkv->shv", k, st))
    st = st + k[..., None] * w[..., None, :]
    state.copy_(st)
    o = torch.einsum("shk,shkv->shv", q, st)
    return gated_norm(o, norm_w, gate.view(s, h, kd), eps).reshape(s, h * kd).to(x.dtype)


def kda_decode_f64(x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state,
                   eps) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step in float64 from the same inputs, left untouched: (the output
    before its rounding [S, H V], the new state)."""
    s, h, kd = _check_decode(x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state)
    d = lambda t: t.double()
    window = torch.cat([d(tail), d(x)[:, None]], dim=1)
    c = F.silu((window * d(conv_w).t()).sum(-2)).view(s, 3, h, kd)
    norm = lambda t: t * torch.rsqrt(t.pow(2).sum(-1, keepdim=True) + L2_EPS)
    q, k, v = norm(c[:, 0]) * kd ** -0.5, norm(c[:, 1]), c[:, 2]
    g = -d(a_log).exp()[:, None] * F.softplus(d(f).view(s, h, kd) + d(dt_bias).view(h, kd))
    st = d(state) * g.exp()[..., None]
    w = torch.sigmoid(d(beta))[..., None] * (v - torch.einsum("shk,shkv->shv", k, st))
    st = st + k[..., None] * w[..., None, :]
    o = torch.einsum("shk,shkv->shv", q, st)
    o = o * torch.rsqrt(o.pow(2).mean(-1, keepdim=True) + eps) * d(norm_w)
    return (o * torch.sigmoid(d(gate).view(s, h, kd))).reshape(s, h * kd), st


# -- the kernel -----------------------------------------------------------------------

def build() -> Built:
    """Compile both kernels into one library (once per process; cached on
    disk by source hash)."""
    global _lib, _built
    with _lock:
        if _lib is None:
            built = build_shared_library("rag_kda", SOURCES, [nvcc_path(), *NVCC_FLAGS],
                                         timeout_s=600)
            lib = ctypes.CDLL(str(built.path))
            lib.rag_kda_decode.argtypes = ARGTYPES
            lib.rag_kda_prefill.argtypes = PREFILL_ARGTYPES
            for fn in (lib.rag_kda_decode, lib.rag_kda_prefill):
                fn.restype = ctypes.c_int
            _lib, _built = lib, built
        return _built


def _row_major(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name} needs unit stride in its last dimension, got {t.stride()}")


def cuda_kda_decode(x: torch.Tensor, tail: torch.Tensor, conv_w: torch.Tensor,
                    f: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
                    beta: torch.Tensor, gate: torch.Tensor, norm_w: torch.Tensor,
                    state: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel: ``kda_decode_plain``'s function on a CUDA device. x, f,
    beta and gate may be column slices of wider rows (unit stride, any row
    stride)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the KDA decode kernel runs on a CUDA device, got {dev}")
    args = {"tail": tail, "conv_w": conv_w, "f": f, "a_log": a_log, "dt_bias": dt_bias,
            "beta": beta, "gate": gate, "norm_w": norm_w, "state": state}
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    s, h, kd = _check_decode(x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state)
    if kd != HEAD:
        raise ValueError(f"the kernel takes heads {HEAD} wide, got {kd}")
    bf16 = [x, tail, conv_w, f, beta, gate, norm_w]
    if any(t.dtype != torch.bfloat16 for t in bf16) or any(
            t.dtype != torch.float32 for t in (a_log, dt_bias, state)):
        raise TypeError("the kernel takes bf16 activations and weights, float32 A_log, "
                        f"dt_bias and state; got {[t.dtype for t in bf16]}, "
                        f"{a_log.dtype}, {dt_bias.dtype}, {state.dtype}")
    for name, t in (("x", x), ("f", f), ("beta", beta), ("gate", gate)):
        _row_major(name, t)
    for name, t in (("tail", tail), ("conv_w", conv_w), ("a_log", a_log), ("dt_bias", dt_bias),
                    ("norm_w", norm_w), ("state", state)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((s, h * kd), dtype=torch.bfloat16, device=dev)
    if _lib is None:
        build()
    rc = _lib.rag_kda_decode(
        x.data_ptr(), x.stride(0), tail.data_ptr(), conv_w.data_ptr(), f.data_ptr(),
        f.stride(0), a_log.data_ptr(), dt_bias.data_ptr(), beta.data_ptr(), beta.stride(0),
        gate.data_ptr(), gate.stride(0), norm_w.data_ptr(), state.data_ptr(), out.data_ptr(),
        s, h, float(eps), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"KDA decode kernel launch failed: CUDA error {rc}")
    cuda_kda_decode.launches += 1
    profiling.count("kda.decode_kernel")
    return out


cuda_kda_decode.launches = 0


def kda_decode(x: torch.Tensor, tail: torch.Tensor, conv_w: torch.Tensor, f: torch.Tensor,
               a_log: torch.Tensor, dt_bias: torch.Tensor, beta: torch.Tensor,
               gate: torch.Tensor, norm_w: torch.Tensor, state: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The plain twin for a tensor on the CPU, the kernel for a CUDA tensor;
    counts the state's bytes read and written (``kda.state_bytes``)."""
    profiling.count("kda.state_bytes", 2 * state.numel() * state.element_size())
    fn = kda_decode_plain if x.device.type == "cpu" else cuda_kda_decode
    return fn(x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state, eps)


def cuda_kda_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                     beta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: ``kda_chunked_plain``'s function on a CUDA device, in
    float32 throughout: (o [B, T, V], the end state [B, K, V]). It takes q,
    k, v, g [B, T, 128] and beta [B, T], float32 and contiguous, and raises
    before any launch on anything else."""
    if q.dim() != 3 or any(t.shape != q.shape for t in (k, v, g)) \
            or beta.shape != q.shape[:2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"g {tuple(g.shape)}, beta {tuple(beta.shape)}")
    if q.shape[-1] != HEAD:
        raise ValueError(f"the kernel takes heads {HEAD} wide, got {q.shape[-1]}")
    args = {"q": q, "k": k, "v": v, "g": g, "beta": beta}
    if any(t.dtype != torch.float32 for t in args.values()):
        raise TypeError(f"the kernel takes float32 inputs, got "
                        f"{ {n: str(t.dtype) for n, t in args.items()} }")
    for name, t in args.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"the KDA prefill kernel runs on a CUDA device, got {q.device}")
    for name, t in args.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    b, t = q.shape[:2]
    out = torch.empty_like(v)
    state = torch.empty((b, HEAD, HEAD), dtype=torch.float32, device=q.device)
    if _lib is None:
        build()
    rc = _lib.rag_kda_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                              beta.data_ptr(), out.data_ptr(), state.data_ptr(), b, t,
                              torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"KDA prefill kernel launch failed: CUDA error {rc}")
    cuda_kda_prefill.launches += 1
    profiling.count("kda.prefill_kernel")
    return out, state


cuda_kda_prefill.launches = 0


def kda_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                beta: torch.Tensor, chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefill's recurrence from S_0 = 0 (float32 inputs): the chunked
    form in chunks of ``chunk`` tokens for a tensor on the CPU, the kernel
    for a CUDA tensor, which never falls back: (o [B, T, V], the end state
    [B, K, V])."""
    if q.device.type == "cpu":
        return kda_chunked_plain(q, k, v, g, beta, chunk)
    return cuda_kda_prefill(q, k, v, g, beta)
