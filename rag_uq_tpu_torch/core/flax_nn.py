"""PyTorch layers with ``flax.linen``'s numerics, for the encoder and TinyLM.

The JAX package's transformers are flax modules run at ``dtype="bfloat16"``
with float32 parameters. flax casts each parameter to the compute dtype at
every use, so these layers hold that cast once: the values are the same.
What flax does, and these layers repeat (flax 0.12.3):

- ``Dense``: input and kernel in the compute dtype, the product rounded to
  it, then the bias added in it. flax stores the kernel ``[in, out]``; the
  ``nn.Linear`` here holds its transpose.
- ``LayerNorm`` (epsilon 1e-6): mean and ``E[x^2] - E[x]^2`` in float32
  (``use_fast_variance``), the normalization, scale and bias in float32,
  then a cast back to the compute dtype.
- ``gelu``: the tanh approximation, one rounded operation at a time with
  the constants rounded to the compute dtype, as ``jax.nn.gelu`` runs on a
  bf16 array.
- Attention: the query divided by ``sqrt(head_dim)`` (rounded to the
  compute dtype) before ``q k^T``; masked logits set to the dtype's most
  negative finite value, not -inf, so a row with every key masked stays
  finite; the softmax in the compute dtype with its sum taken in float32
  (``jax.nn.softmax`` of a bf16 array).

Random initialization draws from a ``torch.Generator`` at flax's scales
(normal kernels with std 1/sqrt(fan_in), zero biases, unit LayerNorm
scales); JAX's ``PRNGKey`` stream cannot be reproduced, so the values
differ from a JAX init with the same seed.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from rag_uq_tpu_torch.utils.checkpoint import to_numpy_f32 as _f32

LN_EPS = 1e-6


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32", ...) as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _round_to(value: float, dtype: torch.dtype) -> float:
    """A Python float rounded to ``dtype``, as JAX casts weak-typed constants."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.tensor(_f32(src))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"parameter shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src.to(dst.dtype))


class Dense(nn.Module):
    """``flax.linen.Dense`` at ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        w = torch.randn((d_out, d_in), generator=gen) / math.sqrt(d_in)
        self.weight = _param(w.to(dtype))
        self.bias = _param(torch.zeros((d_out,), dtype=dtype))

    def load(self, tree) -> None:
        """From a flax ``{"kernel": [in, out], "bias": [out]}`` tree."""
        _copy(self.weight, _f32(tree["kernel"]).T)
        _copy(self.bias, tree["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.weight.t())
        return y + self.bias


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` (epsilon 1e-6) at ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = _param(torch.ones((dim,), dtype=torch.float32))
        self.bias = _param(torch.zeros((dim,), dtype=torch.float32))

    def load(self, tree) -> None:
        _copy(self.scale, tree["scale"])
        _copy(self.bias, tree["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = xf - mean
        y = y * (torch.rsqrt(var + LN_EPS) * self.scale)
        y = y + self.bias
        return y.to(self.dtype)


class Embed(nn.Module):
    """``flax.linen.Embed`` at ``dtype`` (the table cast to it)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = _param((torch.randn((num, dim), generator=gen) / math.sqrt(dim)).to(dtype))

    def load(self, tree) -> None:
        _copy(self.embedding, tree["embedding"])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) one rounded op at a time."""
    dt = x.dtype
    c = _round_to(math.sqrt(2.0 / math.pi), dt)
    a = _round_to(0.044715, dt)
    inner = x + a * (x * x * x)
    cdf = 0.5 * (1.0 + torch.tanh(c * inner))
    return x * cdf


def softmax(w: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in ``w``'s dtype (sum in f32)."""
    e = torch.exp(w - w.amax(dim=-1, keepdim=True))
    return e / e.float().sum(dim=-1, keepdim=True).to(w.dtype)


class MultiHeadAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` (deterministic) at ``dtype``.

    The query, key and value kernels ``[D, H, Dh]`` and the out kernel
    ``[H, Dh, D]`` act as ``[D, H*Dh]`` and ``[H*Dh, D]`` products.
    """

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads {num_heads}")
        self.num_heads, self.head_dim, self.dtype = num_heads, dim // num_heads, dtype
        self.query = Dense(dim, dim, dtype, gen)
        self.key = Dense(dim, dim, dtype, gen)
        self.value = Dense(dim, dim, dtype, gen)
        self.out = Dense(dim, dim, dtype, gen)
        self.q_scale = _round_to(math.sqrt(self.head_dim), dtype)

    def load(self, tree) -> None:
        for name in ("query", "key", "value"):
            kernel = _f32(tree[name]["kernel"])
            getattr(self, name).load({"kernel": kernel.reshape(kernel.shape[0], -1),
                                      "bias": _f32(tree[name]["bias"]).reshape(-1)})
        kernel = _f32(tree["out"]["kernel"])
        self.out.load({"kernel": kernel.reshape(-1, kernel.shape[-1]), "bias": tree["out"]["bias"]})

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """[..., L, D] -> [..., L, H, Dh]."""
        return x.reshape(*x.shape[:-1], self.num_heads, self.head_dim)

    def qkv(self, x: torch.Tensor):
        return self.heads(self.query(x)), self.heads(self.key(x)), self.heads(self.value(x))

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q [B, Lq, H, Dh], k and v [B, Lk, H, Dh], mask broadcastable to
        [B, H, Lq, Lk] (True = attend) -> [B, Lq, D] after the out product."""
        q = q / self.q_scale
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        p = softmax(w)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.out(o.reshape(*o.shape[:2], -1))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        q, k, v = self.qkv(x)
        return self.attend(q, k, v, mask)
