"""A plain reference of DeepSeek-V2's decoder, for checking the port's generator.

Plain ``torch`` in float32 with TF32 off; it imports nothing of the port and
nothing of JAX, so it runs on a card's machine as it runs in the tests. It is
the full forward pass over whole sequences: no cache, no batching of rows, no
absorption of the latent projections. It follows DeepSeek-V2 (arXiv:2405.04434
§2.1-2.2) and the published ``modeling_deepseek.py``:

- RMSNorm, ``weight * x / sqrt(mean(x^2) + eps)``;
- multi-head latent attention with a plain ``q_proj`` (``q_lora_rank`` null):
  ``kv_a_proj_with_mqa`` gives the latent ``c`` (``kv_lora_rank`` wide,
  normed by ``kv_a_layernorm``) and one shared rope key; ``kv_b_proj``
  decompresses ``c`` into each head's no-rope key and value;
- decoupled RoPE over the rope dimensions, in DeepSeek's interleaved layout
  (pairs ``(x0, x1), (x2, x3), ...`` regrouped into evens then odds before
  ``rotate_half``), with YaRN's blended inverse frequencies and its
  attention scale ``qk_head_dim ** -0.5 * mscale(factor, mscale_all_dim) ** 2``;
- SwiGLU MLPs; the first ``first_k_dense_replace`` layers dense, the others
  a mixture of experts: a softmax gate computed in float32, greedy top-k, the
  weights not renormalised (``norm_topk_prob`` false) and scaled by
  ``routed_scaling_factor``, the routed experts' outputs summed with those
  weights, and the shared experts (one MLP of ``n_shared_experts`` times the
  expert width) added;
- an untied ``lm_head`` over the final RMSNorm.

Weights are drawn from a seed per named tensor (``draw``): normal with the
recipe's ``std`` (the published ``initializer_range``), RMSNorm weights 1,
rounded to the storage precision and computed with in float32. Departures
from the published code: none in the equations; the gate may be *told* the
program's expert set at a token where its own k-th and (k+1)-th gate
probabilities lie within ``tie_tol`` (relative to the k-th), so that a tie
that rounding breaks either way does not send the two computations down
different experts; and ``low`` runs the weights and the cached latents
(``c`` and the rope key) through a lower precision, for the control.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# -- the published configuration's derived numbers ----------------------------------

def yarn_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: Dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def yarn_inv_freq(cfg: Dict) -> torch.Tensor:
    """The rope dimensions' inverse frequencies [dim / 2], float32."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    rs = cfg.get("rope_scaling")
    if not rs:
        return 1.0 / base ** exps
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]
    extra = 1.0 / base ** exps
    inter = 1.0 / (factor * base ** exps)

    def corr_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_mscale(cfg: Dict) -> float:
    rs = cfg.get("rope_scaling")
    if not rs:
        return 1.0
    return (yarn_mscale(rs["factor"], rs.get("mscale", 1))
            / yarn_mscale(rs["factor"], rs.get("mscale_all_dim", 0) or 1))


def is_moe(cfg: Dict, i: int) -> bool:
    return (cfg.get("n_routed_experts") is not None and i >= cfg["first_k_dense_replace"]
            and i % cfg["moe_layer_freq"] == 0)


# -- weights --------------------------------------------------------------------------

def layer_shapes(cfg: Dict, i: int) -> Dict[str, Tuple[int, ...]]:
    """Layer ``i``'s tensors by their published names."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, rope, v = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    p = f"model.layers.{i}."
    out = {p + "input_layernorm.weight": (h,), p + "post_attention_layernorm.weight": (h,),
           p + "self_attn.q_proj.weight": (heads * qk, h),
           p + "self_attn.kv_a_proj_with_mqa.weight": (r + rope, h),
           p + "self_attn.kv_a_layernorm.weight": (r,),
           p + "self_attn.kv_b_proj.weight": (heads * (cfg["qk_nope_head_dim"] + v), r),
           p + "self_attn.o_proj.weight": (h, heads * v)}

    def mlp(prefix, width):
        out[prefix + "gate_proj.weight"] = (width, h)
        out[prefix + "up_proj.weight"] = (width, h)
        out[prefix + "down_proj.weight"] = (h, width)

    if is_moe(cfg, i):
        e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        out[p + "mlp.gate.weight"] = (e, h)
        for j in range(e):
            mlp(f"{p}mlp.experts.{j}.", w)
        if cfg.get("n_shared_experts"):
            mlp(p + "mlp.shared_experts.", w * cfg["n_shared_experts"])
    else:
        mlp(p + "mlp.", cfg["intermediate_size"])
    return out


def outer_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    h, vocab = cfg["hidden_size"], cfg["vocab_size"]
    return {"model.embed_tokens.weight": (vocab, h), "model.norm.weight": (h,),
            "lm_head.weight": (vocab, h)}


def published_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    out = dict(outer_shapes(cfg))
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_shapes(cfg, i))
    return out


def tensor_seed(seed: int, name: str) -> int:
    """The seed of one named tensor: the run's seed and the name's CRC-32."""
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (2**63)


def tensor_seeds(cfg: Dict, seed: int) -> Dict[str, int]:
    return {name: tensor_seed(seed, name) for name in published_shapes(cfg)}


def is_norm(name: str) -> bool:
    return name.endswith("layernorm.weight") or name == "model.norm.weight"


def draw(name: str, shape, seed: int, std: float, device, storage=torch.bfloat16) -> torch.Tensor:
    """The named tensor in ``storage``: ones for an RMSNorm weight, else
    normal(0, std) from a generator on ``device`` seeded with ``seed``."""
    if is_norm(name):
        return torch.ones(shape, dtype=storage, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    return (torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std).to(storage)


def weights(shapes: Dict[str, Tuple[int, ...]], seeds: Dict[str, int], std: float, device,
            storage=torch.bfloat16, low: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The named tensors, each drawn from its seed in ``seeds``, in float32
    as stored (rounded through ``low`` first, with ``low``)."""
    return {name: lowered(draw(name, shape, seeds[name], std, device, storage), low)
            for name, shape in shapes.items()}


# -- the layers -----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat((-x[..., half:], x[..., :half]), dim=-1)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """x [..., L, d] at positions ``pos`` [L], DeepSeek's interleaved layout."""
    inv = yarn_inv_freq(cfg).to(x.device)
    freqs = torch.outer(pos.to(torch.float32), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = rope_mscale(cfg)
    cos, sin = emb.cos() * m, emb.sin() * m
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    return x * cos + rotate_half(x) * sin


def lowered(x: torch.Tensor, low: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in float32, rounded through ``low`` first where given."""
    return (x if low is None else x.to(low)).float()


def attention(w: Dict, p: str, x: torch.Tensor, cfg: Dict,
              low: Optional[torch.dtype] = None) -> torch.Tensor:
    """Causal latent attention over one sequence x [L, hidden]."""
    L = x.shape[0]
    heads, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope, r, v = cfg["qk_rope_head_dim"], cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = (x @ w[p + "q_proj.weight"].T).view(L, heads, nope + rope).transpose(0, 1)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    kv = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    c, k_pe = kv[:, :r], kv[:, r:]
    c = rms_norm(c, w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    pos = torch.arange(L, device=x.device)
    q_pe = apply_rope(q_pe, pos, cfg)
    k_pe = apply_rope(k_pe[None], pos, cfg)
    # What a cache would hold: the normed latent and the roped shared key.
    c, k_pe = lowered(c, low), lowered(k_pe, low)
    kv = (c @ w[p + "kv_b_proj.weight"].T).view(L, heads, nope + v).transpose(0, 1)
    k_nope, val = kv[..., :nope], kv[..., nope:]
    qs = torch.cat([q_nope, q_pe], -1)
    ks = torch.cat([k_nope, k_pe.expand(heads, L, rope)], -1)
    scores = (qs @ ks.transpose(-1, -2)) * softmax_scale(cfg)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ val
    return out.transpose(0, 1).reshape(L, heads * v) @ w[p + "o_proj.weight"].T


def mlp(w: Dict, p: str, x: torch.Tensor) -> torch.Tensor:
    g = x @ w[p + "gate_proj.weight"].T
    u = x @ w[p + "up_proj.weight"].T
    return (F.silu(g) * u) @ w[p + "down_proj.weight"].T


def moe(w: Dict, p: str, x: torch.Tensor, cfg: Dict, told: Optional[torch.Tensor] = None,
        tie_tol: float = 0.0):
    """(output [T, hidden], chosen experts [T, k], ambiguous [T] bool). Where
    ``told`` [T, k] is given and the gate's k-th and (k+1)-th probabilities
    are within ``tie_tol`` of each other (relative to the k-th), the told
    set is used, with this gate's probabilities."""
    k = cfg["num_experts_per_tok"]
    scores = torch.softmax(x.float() @ w[p + "gate.weight"].float().T, dim=-1)
    top = torch.topk(scores, k + 1, dim=-1).values
    ambiguous = (top[:, k - 1] - top[:, k]) <= tie_tol * top[:, k - 1]
    idx = torch.topk(scores, k, dim=-1).indices
    if told is not None:
        idx = torch.where(ambiguous[:, None], told.to(idx), idx)
    weight = torch.gather(scores, 1, idx)
    if k > 1 and cfg.get("norm_topk_prob"):
        weight = weight / weight.sum(-1, keepdim=True)
    weight = weight * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        out.index_add_(0, rows, mlp(w, f"{p}experts.{e}.", x[rows]) * weight[rows, slot, None])
    if cfg.get("n_shared_experts"):
        out = out + mlp(w, p + "shared_experts.", x)
    return out, idx, ambiguous


def layer(w: Dict, i: int, x: torch.Tensor, cfg: Dict, told: Optional[torch.Tensor] = None,
          tie_tol: float = 0.0, low: Optional[torch.dtype] = None):
    """Decoder layer ``i`` over one sequence: (x, chosen experts or None, ambiguous or None)."""
    p = f"model.layers.{i}."
    eps = cfg["rms_norm_eps"]
    x = x + attention(w, p + "self_attn.", rms_norm(x, w[p + "input_layernorm.weight"], eps),
                      cfg, low)
    h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
    if is_moe(cfg, i):
        out, idx, amb = moe(w, p + "mlp.", h, cfg, told, tie_tol)
        return x + out, idx, amb
    return x + mlp(w, p + "mlp.", h), None, None


def head(w: Dict, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    return rms_norm(x, w["model.norm.weight"], cfg["rms_norm_eps"]) @ w["lm_head.weight"].T


def forward(w: Dict, ids: torch.Tensor, cfg: Dict, told: Optional[List] = None,
            tie_tol: float = 0.0, low: Optional[torch.dtype] = None):
    """(logits [L, vocab], chosen experts by layer) of one sequence ``ids``
    [L]; ``told`` by layer as ``moe`` takes it (None where not given)."""
    x = w["model.embed_tokens.weight"][ids]
    routes = []
    for i in range(cfg["num_hidden_layers"]):
        t = told[i] if told is not None else None
        x, idx, _ = layer(w, i, x, cfg, t, tie_tol, low)
        routes.append(idx)
    return head(w, x, cfg), routes
