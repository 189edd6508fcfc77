"""A plain reference of Kimi Linear's decoder, for checking the port's generator.

Plain ``torch`` in float32 with TF32 off; it imports nothing of the port and
nothing of JAX, so it runs on a card's machine as it runs in the tests. It is
the full forward pass over whole sequences: no cache, no chunking, no
absorption of the latent projections. It follows Kimi Linear
(arXiv:2510.26692) and the published ``modeling_kimi.py``:

- RMSNorm, ``weight * x / sqrt(mean(x^2) + eps)``;
- Kimi Delta Attention at the 1-based ``linear_attn_config["kda_layers"]``,
  per head of K = V = ``head_dim`` channels: q, k, v = SiLU(causal
  depthwise conv of width ``short_conv_kernel_size`` over ``q_proj`` /
  ``k_proj`` / ``v_proj`` x, no bias, zeros before the first token); q
  and k over their L2 norms (``x / sqrt(sum x^2 + 1e-6)``, fla's kernel),
  q times K ** -0.5; g = -exp(A_log[h]) * softplus(f_b(f_a x) + dt_bias);
  beta = sigmoid(b_proj x); then, token by token from S = 0 [K, V]:
  ``S = Diag(exp g_t) S; S = S + beta_t k_t (v_t - S^T k_t)^T; o_t = S^T
  q_t``; the output ``o_proj(RMSNorm_head(o) * o_norm * sigmoid(g_b(g_a
  x)))``;
- multi-head latent attention without rope at the ``full_attn_layers``
  (``mla_use_nope``): ``kv_a_proj_with_mqa`` gives the latent ``c`` (normed
  by ``kv_a_layernorm``) and one shared key of ``qk_rope_head_dim``
  columns, used unrotated; ``kv_b_proj`` decompresses ``c`` into each
  head's key and value; scale ``(qk_nope + qk_rope) ** -0.5``; causal;
- SwiGLU MLPs; the first ``first_k_dense_replace`` layers dense, the others
  a mixture of experts: sigmoid scores of a float32 gate over all routed
  experts, the top-k of score + ``e_score_correction_bias`` chosen, the
  chosen raw scores renormalised (+1e-20, ``moe_renormalize``) and scaled
  by ``routed_scaling_factor``; the experts ``w2(silu(w1 x) * w3 x)``; one
  shared expert added;
- an untied ``lm_head`` over the final RMSNorm, over the full vocabulary.

Weights are drawn from a seed per named tensor (``draw``), as the port's
recipe states, and rounded to the storage precision (float32 for
``A_log``, ``dt_bias`` and the correction bias), then computed with in
float32. Departures from the published code: the router sums only the
experts of the share ``expert_parallel`` states (as the chip holding it
computes them; all of them without it); the conv's output stays float32,
where fla's kernel rounds it to the activations' precision; the gate may be
*told* the program's expert set at a token where its own k-th and
(k+1)-th choice values (score + bias) lie within ``tie_tol`` of each other,
so that a tie that rounding breaks either way does not send the two
computations down different experts; ``low`` runs the weights, the cached
latents (``c`` and the shared key) and the KDA state (after each token)
through a lower precision, for the control; and sequences are run as a
batch padded at their ends, which a causal computation does not see.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L2_EPS = 1e-6
FLOAT32 = ("A_log", "dt_bias", "e_score_correction_bias")


# -- the layers' kinds ----------------------------------------------------------------

def is_kda(cfg: Dict, i: int) -> bool:
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def is_moe(cfg: Dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0


def routed_experts(cfg: Dict) -> int:
    ep = cfg.get("expert_parallel")
    return int(ep["experts"]) if ep else cfg["num_experts"]


def held(cfg: Dict) -> range:
    """The routed experts this chip holds."""
    ep = cfg.get("expert_parallel")
    n = cfg["num_experts"]
    lo = int(ep["rank"]) * n if ep else 0
    return range(lo, lo + n)


# -- weights --------------------------------------------------------------------------

def layer_shapes(cfg: Dict, i: int) -> Dict[str, Tuple[int, ...]]:
    """Layer ``i``'s tensors by their published names."""
    h = cfg["hidden_size"]
    p = f"model.layers.{i}."
    a = p + "self_attn."
    out = {p + "input_layernorm.weight": (h,), p + "post_attention_layernorm.weight": (h,)}
    if is_kda(cfg, i):
        la = cfg["linear_attn_config"]
        nh, kd, taps = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
        hk = nh * kd
        for n in "qkv":
            out[f"{a}{n}_proj.weight"] = (hk, h)
            out[f"{a}{n}_conv1d.weight"] = (hk, 1, taps)
        out.update({a + "A_log": (1, 1, nh, 1), a + "f_a_proj.weight": (kd, h),
                    a + "f_b_proj.weight": (hk, kd), a + "dt_bias": (hk,),
                    a + "b_proj.weight": (nh, h), a + "g_a_proj.weight": (kd, h),
                    a + "g_b_proj.weight": (hk, kd), a + "o_norm.weight": (kd,),
                    a + "o_proj.weight": (h, hk)})
    else:
        heads, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
        rope, r, v = cfg["qk_rope_head_dim"], cfg["kv_lora_rank"], cfg["v_head_dim"]
        out.update({a + "q_proj.weight": (heads * (nope + rope), h),
                    a + "kv_a_proj_with_mqa.weight": (r + rope, h),
                    a + "kv_a_layernorm.weight": (r,),
                    a + "kv_b_proj.weight": (heads * (nope + v), r),
                    a + "o_proj.weight": (h, heads * v)})

    def mlp(prefix, width, names=("gate_proj", "up_proj", "down_proj")):
        out[f"{prefix}{names[0]}.weight"] = (width, h)
        out[f"{prefix}{names[1]}.weight"] = (width, h)
        out[f"{prefix}{names[2]}.weight"] = (h, width)

    if is_moe(cfg, i):
        m = p + "block_sparse_moe."
        out[m + "gate.weight"] = (routed_experts(cfg), h)
        out[m + "gate.e_score_correction_bias"] = (routed_experts(cfg),)
        for e in held(cfg):
            mlp(f"{m}experts.{e}.", cfg["moe_intermediate_size"], ("w1", "w3", "w2"))
        mlp(m + "shared_experts.", cfg["moe_intermediate_size"] * cfg["num_shared_experts"])
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
    return (name.endswith("layernorm.weight") or name.endswith("o_norm.weight")
            or name == "model.norm.weight")


def draw(name: str, shape, seed: int, std: float, bias_std: float, device,
         storage=torch.bfloat16) -> torch.Tensor:
    """The named tensor as stored: ones for a norm; ``A_log`` = log U(1, 16);
    ``dt_bias`` = softplus^-1 of dt, log-uniform in [1e-3, 0.1], floor 1e-4;
    a conv weight U(-1/2, 1/2); the correction bias normal(0, ``bias_std``);
    the rest normal(0, ``std``); from a generator on ``device`` seeded with
    ``seed``, in float32, then in ``storage`` (float32 for ``FLOAT32``)."""
    store = torch.float32 if name.endswith(FLOAT32) else storage
    if is_norm(name):
        return torch.ones(shape, dtype=store, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    if name.endswith("A_log"):
        x = torch.log(torch.rand(shape, generator=g, device=device) * 15.0 + 1.0)
    elif name.endswith("dt_bias"):
        u = torch.rand(shape, generator=g, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
        x = dt + torch.log(-torch.expm1(-dt))
    elif name.endswith("conv1d.weight"):
        x = (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * 0.5
    else:
        sd = bias_std if name.endswith("e_score_correction_bias") else std
        x = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * sd
    return x.to(store)


def lowered(x: torch.Tensor, low: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in float32, rounded through ``low`` first where given."""
    return (x if low is None else x.to(low)).float()


def weights(shapes: Dict[str, Tuple[int, ...]], seeds: Dict[str, int], std: float,
            bias_std: float, device, storage=torch.bfloat16,
            low: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The named tensors, each drawn from its seed in ``seeds``, in float32
    as stored (rounded through ``low`` first, with ``low``)."""
    return {name: lowered(draw(name, shape, seeds[name], std, bias_std, device, storage), low)
            for name, shape in shapes.items()}


# -- the layers -----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + L2_EPS)


def kda(w: Dict, p: str, x: torch.Tensor, cfg: Dict,
        low: Optional[torch.dtype] = None) -> torch.Tensor:
    """Kimi Delta Attention over a batch of sequences x [B, L, hidden]
    (padded at their ends), token by token."""
    la = cfg["linear_attn_config"]
    nh, kd, taps = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    b, L, _ = x.shape

    def conv(n):
        y = x @ w[f"{p}{n}_proj.weight"].T                           # [B, L, H K]
        y = F.pad(y, (0, 0, taps - 1, 0))                            # zeros before the first
        wt = w[f"{p}{n}_conv1d.weight"][:, 0]                        # [H K, taps]
        out = sum(y[:, i : i + L] * wt[:, i] for i in range(taps))
        return F.silu(out).view(b, L, nh, kd)

    q = l2norm(conv("q")) * kd ** -0.5
    k = l2norm(conv("k"))
    v = conv("v")
    f = (x @ w[p + "f_a_proj.weight"].T) @ w[p + "f_b_proj.weight"].T
    g = -w[p + "A_log"].view(nh, 1).exp() * F.softplus(f.view(b, L, nh, kd)
                                                       + w[p + "dt_bias"].view(nh, kd))
    beta = torch.sigmoid(x @ w[p + "b_proj.weight"].T)               # [B, L, H]
    s = x.new_zeros((b, nh, kd, kd))
    outs = []
    for t in range(L):
        s = s * g[:, t].exp()[..., None]
        kt = k[:, t]
        u = beta[:, t, :, None] * (v[:, t] - torch.einsum("bhk,bhkv->bhv", kt, s))
        s = lowered(s + kt[..., None] * u[..., None, :], low)
        outs.append(torch.einsum("bhk,bhkv->bhv", q[:, t], s))
    o = torch.stack(outs, 1)                                         # [B, L, H, V]
    gate = (x @ w[p + "g_a_proj.weight"].T) @ w[p + "g_b_proj.weight"].T
    o = rms_norm(o, w[p + "o_norm.weight"], cfg["rms_norm_eps"]) * torch.sigmoid(
        gate.view(b, L, nh, kd))
    return o.reshape(b, L, nh * kd) @ w[p + "o_proj.weight"].T


def mla(w: Dict, p: str, x: torch.Tensor, cfg: Dict,
        low: Optional[torch.dtype] = None) -> torch.Tensor:
    """Causal latent attention without rope over one sequence x [L, hidden]."""
    L = x.shape[0]
    heads, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope, r, v = cfg["qk_rope_head_dim"], cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = (x @ w[p + "q_proj.weight"].T).view(L, heads, nope + rope).transpose(0, 1)
    kv = x @ w[p + "kv_a_proj_with_mqa.weight"].T
    c = rms_norm(kv[:, :r], w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
    # What a cache would hold: the normed latent and the shared key.
    c, k_pe = lowered(c, low), lowered(kv[:, r:], low)
    kv = (c @ w[p + "kv_b_proj.weight"].T).view(L, heads, nope + v).transpose(0, 1)
    ks = torch.cat([kv[..., :nope], k_pe[None].expand(heads, L, rope)], -1)
    scores = (q @ ks.transpose(-1, -2)) * (nope + rope) ** -0.5
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ kv[..., nope:]
    return out.transpose(0, 1).reshape(L, heads * v) @ w[p + "o_proj.weight"].T


def attention(w: Dict, i: int, xs: Sequence[torch.Tensor], cfg: Dict,
              low: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Layer ``i``'s attention block over each sequence of ``xs`` ([L, hidden]
    normed inputs): KDA over them as one padded batch, MLA one at a time."""
    p = f"model.layers.{i}.self_attn."
    if not is_kda(cfg, i):
        return [mla(w, p, x, cfg, low) for x in xs]
    lens = [x.shape[0] for x in xs]
    batch = torch.stack([F.pad(x, (0, 0, 0, max(lens) - x.shape[0])) for x in xs])
    out = kda(w, p, batch, cfg, low)
    return [o[:n] for o, n in zip(out, lens)]


def mlp(w: Dict, p: str, x: torch.Tensor, names=("gate_proj", "up_proj", "down_proj")):
    g = x @ w[f"{p}{names[0]}.weight"].T
    u = x @ w[f"{p}{names[1]}.weight"].T
    return (F.silu(g) * u) @ w[f"{p}{names[2]}.weight"].T


def moe(w: Dict, p: str, x: torch.Tensor, cfg: Dict, told: Optional[torch.Tensor] = None,
        tie_tol: float = 0.0):
    """(output [T, hidden], chosen experts [T, k], ambiguous [T] bool). Where
    ``told`` [T, k] is given and the k-th and (k+1)-th choice values lie
    within ``tie_tol`` of each other, the told set is used, with this gate's
    scores. Only the held experts' pairs are summed."""
    k = cfg["num_experts_per_token"]
    scores = torch.sigmoid(x.float() @ w[p + "gate.weight"].float().T)
    choice = scores + w[p + "gate.e_score_correction_bias"]
    top = torch.topk(choice, k + 1, dim=-1).values
    ambiguous = (top[:, k - 1] - top[:, k]) <= tie_tol
    idx = torch.topk(choice, k, dim=-1).indices
    if told is not None:
        idx = torch.where(ambiguous[:, None], told.to(idx), idx)
    weight = torch.gather(scores, 1, idx)
    if k > 1 and cfg["moe_renormalize"]:
        weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
    weight = weight * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    mine = held(cfg)
    for e in torch.unique(idx).tolist():
        if e not in mine:
            continue
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        out.index_add_(0, rows, mlp(w, f"{p}experts.{e}.", x[rows], ("w1", "w3", "w2"))
                       * weight[rows, slot, None])
    return out + mlp(w, p + "shared_experts.", x), idx, ambiguous


def ffn(w: Dict, i: int, x: torch.Tensor, cfg: Dict, told: Optional[torch.Tensor] = None,
        tie_tol: float = 0.0):
    """Layer ``i``'s FFN over x [T, hidden] (its normed input): (output,
    chosen experts or None, ambiguous or None)."""
    p = f"model.layers.{i}."
    if is_moe(cfg, i):
        return moe(w, p + "block_sparse_moe.", x, cfg, told, tie_tol)
    return mlp(w, p + "mlp.", x), None, None


def layer(w: Dict, i: int, xs: Sequence[torch.Tensor], cfg: Dict,
          told: Optional[Sequence[Optional[torch.Tensor]]] = None, tie_tol: float = 0.0,
          low: Optional[torch.dtype] = None):
    """Decoder layer ``i`` over sequences ``xs``: (the new xs, per sequence
    the chosen experts or None and the ambiguous tokens or None)."""
    p = f"model.layers.{i}."
    eps = cfg["rms_norm_eps"]
    att = attention(w, i, [rms_norm(x, w[p + "input_layernorm.weight"], eps) for x in xs], cfg,
                    low)
    out, routes, amb = [], [], []
    for j, (x, a) in enumerate(zip(xs, att)):
        x = x + a
        t = told[j] if told is not None else None
        y, idx, am = ffn(w, i, rms_norm(x, w[p + "post_attention_layernorm.weight"], eps), cfg,
                         t, tie_tol)
        out.append(x + y)
        routes.append(idx)
        amb.append(am)
    return out, routes, amb


def head(w: Dict, x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    return rms_norm(x, w["model.norm.weight"], cfg["rms_norm_eps"]) @ w["lm_head.weight"].T


def forward(w: Dict, ids: torch.Tensor, cfg: Dict, told: Optional[List] = None,
            tie_tol: float = 0.0, low: Optional[torch.dtype] = None):
    """(logits [L, vocab], chosen experts by layer) of one sequence ``ids``
    [L]; ``told`` by layer as ``moe`` takes it (None where not given)."""
    x = w["model.embed_tokens.weight"][ids]
    routes = []
    for i in range(cfg["num_hidden_layers"]):
        t = [told[i]] if told is not None and told[i] is not None else None
        (x,), (idx,), _ = layer(w, i, [x], cfg, t, tie_tol, low)
        routes.append(idx)
    return head(w, x, cfg), routes
