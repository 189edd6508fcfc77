"""Absorbed latent-attention decode over a shared-prefix latent cache: the
CUDA kernel ``csrc/mla_decode.cu`` and its plain twin.

The function (``llm/deepseek_v2.py::DeepseekV2Model._attn_decode``'s core,
from the absorbed query up to, not including, the ``W_UV`` product): slot s
of ``S = P * group`` and head h attends with ``q[s, h]`` over its prompt's
latents ``prompt[s // group, :lens[p]]`` and its own generated latents
``gen[s, :t + 1]`` under one softmax; the values are the latents' first
``rank`` columns. The output is ``[S, heads, rank]`` in q's dtype.

``mla_decode`` dispatches by device: the plain chain for a tensor on the
CPU, the kernel for a CUDA tensor. ``cuda_mla_decode`` launches the kernel
or raises; it never falls back. It takes the published widths only (rank
512, latent 576, bf16), and needs the prompt latents past each length to
be finite, as the prefill leaves them (zeros): a masked position enters the
value product with probability 0. The kernel keeps the scores in float32 where the
plain chain rounds them to bf16 before the softmax; otherwise both round
the probabilities to bf16 for the value product and sum in float32.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from rag_uq_tpu_torch.ops.cosine_topk import NVCC_FLAGS, nvcc_path, sm_count
from rag_uq_tpu_torch.utils import profiling
from rag_uq_tpu_torch.utils.build import Built, build_shared_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mla_decode.cu"
RANK = 512  # kv_lora_rank: the kernel's value columns
LATENT = 576  # kv_lora_rank + qk_rope_head_dim
_TILE = 64  # query rows a row tile; latent positions a tile
_MIN_SPLIT_TILES = 4  # a prompt split holds at least this many tiles
_SPLIT_SLACK = 1.5  # a prompt is split past this many SM shares of the launch's work

_P, _I = ctypes.c_void_p, ctypes.c_int
# rag_mla_decode's arguments: q, prompt, lens, gen; P, group, heads, Lp,
# max_tokens, t; scale; the plan; part_acc, part_ml, out, stream.
ARGTYPES = [_P, _P, _P, _P, *[_I] * 6, ctypes.c_float, *[_I] * 5, _P, _P, _P, _P]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_built: Optional[Built] = None


def mla_decode_plain(q: torch.Tensor, prompt: torch.Tensor, lens: torch.Tensor,
                     gen: torch.Tensor, t: int, group: int, scale: float,
                     rank: int) -> torch.Tensor:
    """The plain chain: q [S, heads, latent], prompt [P, Lp, latent], lens
    [P], gen [S, max_tokens, latent] -> [S, heads, rank] in q's dtype."""
    s, nh, d = q.shape
    p, lp, _ = prompt.shape
    g = group
    gen = gen[:, : t + 1]
    pos = torch.arange(lp, device=lens.device)
    mask = torch.zeros((p, 1, lp), dtype=torch.float32, device=lens.device)
    mask.masked_fill_(pos[None, None, :] >= lens[:, None, None], float("-inf"))
    mask = mask.repeat_interleave(group, dim=0)
    s_p = torch.bmm(q.view(p, g * nh, d), prompt.transpose(1, 2)).view(s, nh, lp)
    s_g = torch.bmm(q, gen.transpose(1, 2))                      # [S, nh, t + 1]
    scores = torch.cat([s_p.float() * scale + mask, s_g.float() * scale], dim=-1)
    a = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.bmm(a[..., :lp].reshape(p, g * nh, lp), prompt[..., :rank]).view(s, nh, rank)
    return o + torch.bmm(a[..., lp:], gen[..., :rank])



# The kernel's error against ``mla_decode_f64`` may exceed the plain twin's
# by this factor (the tests and ``chip_smoke.py`` hold it to that): both
# round the probabilities and the output to bf16, in other places (the
# kernel rounds exp(s - running max), the twin the normalised softmax), and
# the rows' widest errors are single bf16 roundings.
ERR_MARGIN = 1.25


def mla_decode_f64(q: torch.Tensor, prompt: torch.Tensor, lens: torch.Tensor,
                   gen: torch.Tensor, t: int, group: int, scale: float,
                   rank: int) -> torch.Tensor:
    """The function in float64 from the same inputs, [S, heads, rank]: what
    the kernel and the plain twin are both judged against."""
    q, prompt, gen = q.double(), prompt.double(), gen[:, : t + 1].double()
    s, nh, d = q.shape
    p, lp, _ = prompt.shape
    pos = torch.arange(lp, device=lens.device)
    mask = torch.zeros((p, 1, lp), dtype=torch.float64, device=lens.device)
    mask.masked_fill_(pos[None, None, :] >= lens[:, None, None], float("-inf"))
    s_p = torch.bmm(q.view(p, group * nh, d), prompt.transpose(1, 2)).view(s, nh, lp)
    s_g = torch.bmm(q, gen.transpose(1, 2))
    a = torch.softmax(torch.cat([s_p * scale + mask.repeat_interleave(group, dim=0),
                                 s_g * scale], dim=-1), dim=-1)
    o = torch.bmm(a[..., :lp].reshape(p, group * nh, lp), prompt[..., :rank]).view(s, nh, rank)
    return o + torch.bmm(a[..., lp:], gen[..., :rank])


def row_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest |x - ref| of a row over the row's RMS, the widest over rows."""
    x, ref = x.double(), ref.double()
    return float(((x - ref).abs().amax(-1) / ref.pow(2).mean(-1).sqrt()).max())

@dataclass(frozen=True)
class Plan:
    """The kernel's work items (see the note in ``csrc/mla_decode.cu``)."""

    row_tiles: int  # 64-row tiles of a prompt's group x heads rows
    splits: int  # position splits of a prompt
    chunk: int  # positions a split (a multiple of 64)
    head_tiles: int  # 64-row tiles of a slot's heads (own positions)
    own_splits: int  # splits of a slot's t + 1 own positions

    def items(self, prompts: int, slots: int) -> int:
        return prompts * self.splits * self.row_tiles + slots * self.own_splits * self.head_tiles


@functools.lru_cache(maxsize=4096)
def plan(prompts: int, group: int, heads: int, prompt_len: int, t: int, n_sm: int) -> Plan:
    """The work items for one launch, from the shape. The launch's work in
    tiles (each item's tiles plus about one for its query tile and set-up,
    the own items' included) over the SMs is one SM's share; a prompt is
    split only where its tiles are more than ``_SPLIT_SLACK`` shares (and
    a split holds at least ``_MIN_SPLIT_TILES`` tiles): every split adds a
    float32 partial a row to write and merge, which at the generator's shape
    costs more than the imbalance it removes (``PERF.md``). Each slot's
    ``t + 1`` own positions take as many splits of the same size as they
    need."""
    row_tiles, head_tiles = -(-group * heads // _TILE), -(-heads // _TILE)
    tiles, own_tiles = -(-prompt_len // _TILE), -(-(t + 1) // _TILE)
    work = prompts * row_tiles * (tiles + 1) + prompts * group * head_tiles * (own_tiles + 1)
    per_sm = max(_SPLIT_SLACK * work / n_sm, _MIN_SPLIT_TILES)
    chunk_tiles = -(-tiles // max(1, math.ceil(tiles / per_sm)))
    return Plan(row_tiles, -(-tiles // chunk_tiles), chunk_tiles * _TILE, head_tiles,
                -(-own_tiles // chunk_tiles))


def build() -> Built:
    """Compile the kernel (once per process; cached on disk by source hash)."""
    global _lib, _built
    with _lock:
        if _lib is None:
            built = build_shared_library("rag_mla_decode", [SOURCE], [nvcc_path(), *NVCC_FLAGS],
                                         timeout_s=600)
            lib = ctypes.CDLL(str(built.path))
            lib.rag_mla_decode.argtypes = ARGTYPES
            lib.rag_mla_decode.restype = ctypes.c_int
            _lib, _built = lib, built
        return _built


def cuda_mla_decode(q: torch.Tensor, prompt: torch.Tensor, lens: torch.Tensor,
                    gen: torch.Tensor, t: int, group: int, scale: float,
                    rank: int) -> torch.Tensor:
    """The kernel: ``mla_decode_plain``'s function on a CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"the latent-attention kernel runs on a CUDA device, got {q.device}")
    for name, x in (("prompt", prompt), ("lens", lens), ("gen", gen)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if rank != RANK or q.shape[-1] != LATENT or prompt.shape[-1] != LATENT \
            or gen.shape[-1] != LATENT:
        raise ValueError(f"the kernel takes rank {RANK} and latent {LATENT}; got rank {rank}, "
                         f"q {tuple(q.shape)}, prompt {tuple(prompt.shape)}, "
                         f"gen {tuple(gen.shape)}")
    if not (q.dtype == prompt.dtype == gen.dtype == torch.bfloat16):
        raise TypeError(f"the kernel takes bf16, got {q.dtype}, {prompt.dtype}, {gen.dtype}")
    s, nh, _ = q.shape
    p, lp, _ = prompt.shape
    max_tokens = gen.shape[1]
    if s != p * group or gen.shape[0] != s or lens.shape != (p,) or not 0 <= t < max_tokens:
        raise ValueError(f"shapes q {tuple(q.shape)}, prompt {tuple(prompt.shape)}, gen "
                         f"{tuple(gen.shape)}, lens {tuple(lens.shape)}, group {group}, t {t}")
    q, prompt, gen = q.contiguous(), prompt.contiguous(), gen.contiguous()
    lens = lens.to(torch.int64).contiguous()
    pl = plan(p, group, nh, lp, t, sm_count(q.device.index))
    # One float32 scratch: the [parts, rows, 512] partial values, then the
    # [parts, rows, 2] row maxima and sums (16-byte aligned: 512 floats a row).
    n_acc = (pl.splits + pl.own_splits) * s * nh * RANK
    part = torch.empty(n_acc + n_acc // RANK * 2, dtype=torch.float32, device=q.device)
    out = torch.empty((s, nh, RANK), dtype=torch.bfloat16, device=q.device)
    if _lib is None:
        build()
    rc = _lib.rag_mla_decode(
        q.data_ptr(), prompt.data_ptr(), lens.data_ptr(), gen.data_ptr(), p, group, nh, lp,
        max_tokens, t, scale, pl.row_tiles, pl.splits, pl.chunk, pl.head_tiles, pl.own_splits,
        part.data_ptr(), part.data_ptr() + 4 * n_acc, out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"latent-attention decode kernel launch failed: CUDA error {rc}")
    cuda_mla_decode.launches += 1
    profiling.count("mla.decode_kernel")
    return out


cuda_mla_decode.launches = 0


def mla_decode(q: torch.Tensor, prompt: torch.Tensor, lens: torch.Tensor, gen: torch.Tensor,
               t: int, group: int, scale: float, rank: int) -> torch.Tensor:
    """The plain chain for a tensor on the CPU, the kernel for a CUDA tensor."""
    if q.device.type == "cpu":
        return mla_decode_plain(q, prompt, lens, gen, t, group, scale, rank)
    return cuda_mla_decode(q, prompt, lens, gen, t, group, scale, rank)
