"""PyTorch layers with ``flax.linen``'s numerics, for the encoder and TinyLM.

The JAX package's transformers are flax modules run at ``dtype="bfloat16"``
with float32 parameters, which flax casts to the compute dtype at every
use; gradients and optimizer updates land on the float32 values. These
layers hold float32 parameters too. Under autograd they cast at every use,
as flax does. Without autograd (serving, ``torch.no_grad``) they read a
compute-dtype copy of each parameter, made once and made again only when
the parameter changes (its version counter or storage moves: a load, an
optimizer step, ``.to(device)``), so a decode step launches no casts.
What flax does, and these layers repeat (flax 0.12.3):

- ``Dense``: input and kernel in the compute dtype, the product rounded to
  it, then the bias added in it. flax stores the kernel ``[in, out]``; the
  ``nn.Linear`` here holds its transpose.
- ``LayerNorm`` (epsilon 1e-6): mean and ``E[x^2] - E[x]^2`` in float32
  (``use_fast_variance``), the normalization, scale and bias in float32,
  then a cast back to the compute dtype.
- ``Embed``: the table cast to the compute dtype, then the rows taken.
- ``gelu``: the tanh approximation, one rounded operation at a time with
  the constants rounded to the compute dtype, as ``jax.nn.gelu`` runs on a
  bf16 array.
- Attention: the query divided by ``sqrt(head_dim)`` (rounded to the
  compute dtype) before ``q k^T``; masked logits set to the dtype's most
  negative finite value, not -inf, so a row with every key masked stays
  finite; the softmax in the compute dtype with its sum taken in float32
  (``jax.nn.softmax`` of a bf16 array), its max held out of the gradient
  (``lax.stop_gradient``).

Each layer lists its parameters as flax leaves (``flax_params``: the path
in the flax tree, the parameter, the flax shape, and whether the flax leaf
is the transpose), so one pair of functions, ``flax_tree`` and
``load_flax_tree``, carries parameters, or optimizer moments of the same
shapes, to and from flax trees.

Random initialization draws from a ``torch.Generator`` at flax's scales
(normal kernels with std 1/sqrt(fan_in), zero biases, unit LayerNorm
scales); JAX's ``PRNGKey`` stream cannot be reproduced, so the values
differ from a JAX init with the same seed.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rag_uq_tpu_torch.utils.checkpoint import to_numpy_f32 as _f32

LN_EPS = 1e-6

# (path in the flax tree, parameter, flax shape, flax leaf is the transpose)
FlaxLeaf = Tuple[Tuple[str, ...], nn.Parameter, Tuple[int, ...], bool]


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
    return nn.Parameter(t.float())


def flax_leaves(module: nn.Module, prefix: Tuple[str, ...] = ()) -> List[FlaxLeaf]:
    """``module.flax_params()`` with ``prefix`` put before every path."""
    return [(prefix + path, p, shape, t) for path, p, shape, t in module.flax_params()]


def flax_tree(leaves: Sequence[FlaxLeaf],
              value: Callable[[nn.Parameter], torch.Tensor] = lambda p: p) -> Dict[str, Any]:
    """A nested dict of float32 numpy leaves in flax's layout, from
    ``value(param)`` (the parameter itself, or an optimizer moment of its
    shape) for every leaf."""
    tree: Dict[str, Any] = {}
    for path, p, shape, transpose in leaves:
        t = value(p).detach().float().cpu()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray((t.T if transpose else t).reshape(shape).numpy())
    return tree


def load_flax_tree(leaves: Sequence[FlaxLeaf], tree: Dict[str, Any],
                   target: Callable[[nn.Parameter], torch.Tensor] = lambda p: p) -> None:
    """Copy a flax tree's leaves into ``target(param)`` for every leaf (the
    parameter itself by default); raises on a missing leaf or a shape that
    is not flax's."""
    with torch.no_grad():
        for path, p, shape, transpose in leaves:
            node = tree
            for key in path:
                node = node[key]
            src = _f32(node)
            if tuple(src.shape) != tuple(shape):
                raise ValueError(f"{'/'.join(path)}: shape {tuple(src.shape)} != flax's {shape}")
            src = torch.tensor(src)
            src = src.reshape(tuple(p.shape)[::-1]).T if transpose else src.reshape(p.shape)
            dst = target(p)
            dst.copy_(src.to(dst.dtype))


class _CastAtUse(nn.Module):
    """Float32 parameters read at ``self.dtype``: a cast under autograd, a
    cached copy otherwise (see the module docstring)."""

    dtype: torch.dtype

    def _at_dtype(self, name: str) -> torch.Tensor:
        p = getattr(self, name)
        if p.dtype == self.dtype or (torch.is_grad_enabled() and p.requires_grad):
            return p.to(self.dtype)
        casts = self.__dict__.setdefault("_casts", {})
        key = (p._version, p.data_ptr(), p.device)
        hit = casts.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, p.detach().to(self.dtype))
            casts[name] = hit
        return hit[1]


class Dense(_CastAtUse):
    """``flax.linen.Dense`` at ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(torch.randn((d_out, d_in), generator=gen) / math.sqrt(d_in))
        self.bias = _param(torch.zeros((d_out,)))

    def flax_params(self) -> List[FlaxLeaf]:
        d_out, d_in = self.weight.shape
        return [(("kernel",), self.weight, (d_in, d_out), True),
                (("bias",), self.bias, (d_out,), False)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self._at_dtype("weight").t())
        return y + self._at_dtype("bias")


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` (epsilon 1e-6) at ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = _param(torch.ones((dim,)))
        self.bias = _param(torch.zeros((dim,)))

    def flax_params(self) -> List[FlaxLeaf]:
        dim = self.scale.shape[0]
        return [(("scale",), self.scale, (dim,), False), (("bias",), self.bias, (dim,), False)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = xf - mean
        y = y * (torch.rsqrt(var + LN_EPS) * self.scale)
        y = y + self.bias
        return y.to(self.dtype)


class Embed(_CastAtUse):
    """``flax.linen.Embed`` at ``dtype`` (the table cast to it)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param(torch.randn((num, dim), generator=gen) / math.sqrt(dim))

    def flax_params(self) -> List[FlaxLeaf]:
        return [(("embedding",), self.embedding, tuple(self.embedding.shape), False)]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self._at_dtype("embedding")[ids.long()]


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
    e = torch.exp(w - w.amax(dim=-1, keepdim=True).detach())
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

    def flax_params(self) -> List[FlaxLeaf]:
        h, dh = self.num_heads, self.head_dim
        dim = h * dh
        leaves = []
        for name in ("query", "key", "value"):
            dense = getattr(self, name)
            leaves += [((name, "kernel"), dense.weight, (dim, h, dh), True),
                       ((name, "bias"), dense.bias, (h, dh), False)]
        return leaves + [(("out", "kernel"), self.out.weight, (h, dh, dim), True),
                         (("out", "bias"), self.out.bias, (dim,), False)]

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
