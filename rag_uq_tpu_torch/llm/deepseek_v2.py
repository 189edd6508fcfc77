"""DeepSeek-V2 as the port's generator: latent attention with YaRN and
fine-grained experts with shared experts, sampled through the port's MC path.

The equations are DeepSeek-V2's (arXiv:2405.04434 §2.1-2.2) as the published
``modeling_deepseek.py`` computes them (``DeepseekV2Attention``,
``DeepseekV2YarnRotaryEmbedding``, ``MoEGate``, ``DeepseekV2MoE``), in
bfloat16 with float32 norms, rope, softmaxes and gate:

- RMSNorm, ``weight * (x / sqrt(mean(x^2) + eps))`` computed in float32;
- multi-head latent attention (MLA) with a plain ``q_proj``:
  ``kv_a_proj_with_mqa`` gives the latent ``c`` (``kv_lora_rank`` wide,
  normed by ``kv_a_layernorm``) and one rope key shared by the heads;
  ``kv_b_proj`` holds each head's ``W_UK`` (no-rope key) and ``W_UV``
  (value) over the latent;
- decoupled RoPE over ``qk_rope_head_dim`` dimensions in DeepSeek's
  interleaved layout, with YaRN's blended inverse frequencies and the
  softmax scale ``(qk_nope + qk_rope) ** -0.5 * mscale ** 2``, ``mscale =
  0.1 * mscale_all_dim * ln(factor) + 1``;
- SwiGLU MLPs: the first ``first_k_dense_replace`` layers dense, then the
  expert layers: a softmax gate in float32, greedy top-k with the weights
  not renormalised (``norm_topk_prob`` false) and scaled by
  ``routed_scaling_factor``, the routed experts' outputs weighed and summed
  in float32, and the shared experts (one MLP of ``n_shared_experts`` times
  the expert width) added.

The cache holds latents, 576 values a token a layer at the published
widths (the normed ``c`` and the roped key), never decompressed keys or
values. A call prefills each *distinct* prompt once through the
decompressed path (``kv_b_proj`` applied, causal attention over the prompt
by ``scaled_dot_product_attention``) and writes its latents to the prompt
part of the cache, ``[prompts, L, 576]`` a layer with per-prompt lengths.
The rows that share a prompt are its *slots*: the prompt part is shared,
not copied, and each slot has its own part, ``[slots, max_tokens, 576]`` a
layer, for the tokens it generates. Decode attends in the latent space by
absorbing ``W_UK`` into the query and ``W_UV`` after the attention. Between
the two, ``ops/mla_decode.py::mla_decode`` attends each slot over its
prompt's latents and its own under one softmax: on the card one
hand-written kernel (``csrc/mla_decode.cu``: the slots of one prompt read
its latents once a step, as 64-row tiles of (slot, head) rows, scores and
probabilities kept on chip, sums in float32), on the CPU the plain chain of
batched products. Each slot's position is its prompt's length plus the
step. The kernel is built when the generator is made on a card.

The expert layer sorts the token-expert pairs by expert and runs each
expert's product over its group as one grouped product a weight matrix
(``torch._grouped_mm`` with the groups' ends as offsets): no loop over
tokens or experts, no padding, and nothing read back to the host.

The layer loop, the latent attention's paths and cache, the expert layer,
``Capture``, ``_Samples`` and the generate loop also serve Kimi Linear
(``llm/kimi_linear.py``), which adds to them what DeepSeek-V2-Lite does not
use: latent attention without rope (``cos`` None), a sigmoid gate with a
correction bias (a layer's ``score_bias``), and an expert share (``held``:
the layer routes over all experts and computes its own experts' pairs).

Weights carry the published checkpoint's names (``published()``); the
experts are stored stacked (``w13`` [E, hidden, 2 * width] and ``w2`` [E,
width, hidden]) and each published expert tensor is a view into them, so
``load_state_dict`` takes the published tensors as they are. Without a
checkpoint (none is in the repository) the weights are drawn from a seed
per named tensor (``draw_weights``): normal with ``initializer_range``,
RMSNorm weights 1.

``DeepseekV2LM`` is the ``llm/base.py::Generator`` over it, with TinyLM's
scored contract: texts, and the mean and min log-probability of the sampled
tokens under the T = 1 model over the generated span, EOS included. It
samples with ``llm/tiny_lm.py::sample_top_p``. Its tokenizer is the
stand-in ``llm/word_tokenizer.py`` until the published one is in the
repository.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import asdict, dataclass, field, fields
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.llm.tiny_lm import sample_top_p
from rag_uq_tpu_torch.llm.word_tokenizer import WordTokenizer
from rag_uq_tpu_torch.ops import mla_decode as mla
from rag_uq_tpu_torch.utils import profiling

# The expert layer runs the prefill's tokens in chunks of at most this many.
MOE_CHUNK = 16384


def _published_rope_scaling() -> Dict:
    return {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
            "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


@dataclass
class DeepseekV2Config:
    """The published ``config.json`` keys; the defaults are DeepSeek-V2-Lite's.
    ``dtype`` is the port's storage and compute precision."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: Optional[int] = 2
    n_routed_experts: Optional[int] = 64
    routed_scaling_factor: float = 1.0
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    hidden_act: str = "silu"
    max_position_embeddings: int = 163840
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict] = field(default_factory=_published_rope_scaling)
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: Mapping) -> "DeepseekV2Config":
        """The published keys of ``d``; keys that do not shape the model
        (``model_type``, ``seq_aux``, ...) are ignored."""
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> Dict:
        return asdict(self)

    def __post_init__(self):
        unsupported = {"q_lora_rank": self.q_lora_rank is not None,
                       "topk_method": self.topk_method != "greedy",
                       "scoring_func": self.scoring_func != "softmax",
                       "hidden_act": self.hidden_act != "silu",
                       "attention_bias": self.attention_bias,
                       "tie_word_embeddings": self.tie_word_embeddings}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"DeepseekV2Config: unsupported settings {bad}")

    def is_moe(self, i: int) -> bool:
        return (self.n_routed_experts is not None and i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


# -- YaRN -----------------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """``qk_head_dim ** -0.5``, times ``mscale(factor, mscale_all_dim) ** 2`` under YaRN."""
    scale = cfg.qk_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs and rs.get("mscale_all_dim"):
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope_mscale(cfg: DeepseekV2Config) -> float:
    """The factor on cos and sin: ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""
    rs = cfg.rope_scaling
    if not rs:
        return 1.0
    return (yarn_mscale(rs["factor"], rs.get("mscale", 1))
            / yarn_mscale(rs["factor"], rs.get("mscale_all_dim", 0) or 1))


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """Inverse frequencies [qk_rope_head_dim / 2] f32: the extrapolated
    ``base ** -(2i/d)`` on the fast dimensions, the interpolated ones divided
    by ``factor`` on the slow, a linear ramp between the correction range
    that ``beta_fast`` and ``beta_slow`` rotations give."""
    dim, base = cfg.qk_rope_head_dim, float(cfg.rope_theta)
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** exps
    rs = cfg.rope_scaling
    if not rs:
        return extra
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]
    inter = 1.0 / (factor * base ** exps)

    def correction_dim(rotations: float) -> float:
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    extra_share = 1.0 - ramp
    return inter * (1 - extra_share) + extra * extra_share


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., d] in DeepSeek's interleaved layout, rotated in float32 and
    returned in its dtype, in the published output layout (the evens' then
    the odds' rotated halves). cos and sin broadcast to [..., d / 2]."""
    xf = x.float()
    a, b = xf[..., 0::2], xf[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 (``F.rms_norm`` upcasts a bfloat16 input), rounded once."""
    return F.rms_norm(x, (x.shape[-1],), w, eps)


def swiglu(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)), gate and up as one [2 * width, hidden] weight."""
    h = F.linear(x, w_gate_up)
    width = h.shape[-1] // 2
    return F.linear(F.silu(h[..., :width]) * h[..., width:], w_down)


def tensor_seed(seed: int, name: str) -> int:
    """The seed of one named tensor: the model's seed and the name's CRC-32."""
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (2**63)


def is_norm(name: str) -> bool:
    return name.endswith("layernorm.weight") or name == "model.norm.weight"


# -- the model ------------------------------------------------------------------------

def init_mla(layer, cfg, e) -> None:
    """Latent attention's tensors on ``layer`` (``e(*shape)`` allocates one),
    with the absorbed views ``w_uk`` and ``w_uv_t`` of ``kv_b``."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    r, nope, v = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    layer.q_proj = e(nh * cfg.qk_head_dim, h)
    layer.kv_a = e(cfg.latent_dim, h)
    layer.kv_norm = e(r)
    layer.kv_b = e(nh * (nope + v), r)
    layer.o_proj = e(h, nh * v)
    per_head = layer.kv_b.view(nh, nope + v, r)
    layer.w_uk = per_head[:, :nope]                   # [nh, nope, r]
    layer.w_uv_t = per_head[:, nope:].transpose(1, 2)  # [nh, r, v]


def init_experts(layer, routed: int, held: int, hidden: int, width: int, shared: int,
                 e) -> None:
    """An expert layer's tensors on ``layer``: the gate over all ``routed``
    experts, the ``held`` experts stacked (``w13`` [held, hidden, 2 *
    width], ``w2`` [held, width, hidden]) and the shared experts as one MLP
    ``shared`` wide."""
    layer.gate = e(routed, hidden)
    layer.gate_f32 = None
    layer.score_bias = None  # a sigmoid router's correction bias [routed] f32
    layer.w13 = e(held, hidden, 2 * width)
    layer.w2 = e(held, width, hidden)
    layer.w_gate_up, layer.w_down = e(2 * shared, hidden), e(hidden, shared)


class _Layer:
    """One decoder layer's tensors (no autograd)."""

    mixer = "mla"  # the device range of its attention block

    def __init__(self, cfg: DeepseekV2Config, i: int, dt: torch.dtype, dev: torch.device):
        h = cfg.hidden_size
        e = lambda *shape: torch.empty(shape, dtype=dt, device=dev)
        self.moe = cfg.is_moe(i)
        self.ln_in, self.ln_post = e(h), e(h)
        init_mla(self, cfg, e)
        if self.moe:
            n, w = cfg.n_routed_experts, cfg.moe_intermediate_size
            init_experts(self, n, n, h, w, w * (cfg.n_shared_experts or 0), e)
        else:
            w = cfg.intermediate_size
            self.w_gate_up, self.w_down = e(2 * w, h), e(h, w)

    def published(self, p: str, cfg: DeepseekV2Config) -> Iterator[Tuple[str, torch.Tensor]]:
        yield p + "input_layernorm.weight", self.ln_in
        yield p + "post_attention_layernorm.weight", self.ln_post
        yield from mla_published(self, p + "self_attn.")
        m = p + "mlp."
        if self.moe:
            yield m + "gate.weight", self.gate
            w = cfg.moe_intermediate_size
            for j in range(cfg.n_routed_experts):
                x = f"{m}experts.{j}."
                yield x + "gate_proj.weight", self.w13[j, :, :w].t()
                yield x + "up_proj.weight", self.w13[j, :, w:].t()
                yield x + "down_proj.weight", self.w2[j].t()
            m = m + "shared_experts."
            if not cfg.n_shared_experts:
                return
        yield from mlp_published(self, m)


def mla_published(layer, a: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Latent attention's published tensors under the prefix ``a``."""
    yield a + "q_proj.weight", layer.q_proj
    yield a + "kv_a_proj_with_mqa.weight", layer.kv_a
    yield a + "kv_a_layernorm.weight", layer.kv_norm
    yield a + "kv_b_proj.weight", layer.kv_b
    yield a + "o_proj.weight", layer.o_proj


def mlp_published(layer, m: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """A SwiGLU MLP's (``w_gate_up``, ``w_down``) published tensors under ``m``."""
    width = layer.w_down.shape[1]
    yield m + "gate_proj.weight", layer.w_gate_up[:width]
    yield m + "up_proj.weight", layer.w_gate_up[width:]
    yield m + "down_proj.weight", layer.w_down


class LatentCache:
    """The latents of one call: ``prompt[i]`` [P, Lp, latent] (the distinct
    prompts, shared by their slots; zero past each prompt's length ``lens``),
    ``gen[i]`` [S, max_tokens, latent] (each slot's generated tokens) and
    ``group``, the slots a prompt."""

    def __init__(self, prompt: List[torch.Tensor], lens: torch.Tensor):
        self.prompt, self.lens = prompt, lens
        self.gen: List[torch.Tensor] = []
        self.group = 0

    def fork(self, group: int, max_tokens: int) -> None:
        """Give each prompt ``group`` slots, each with room for ``max_tokens``."""
        p, _, d = self.prompt[0].shape
        self.group = group
        self.gen = [torch.empty((p * group, max_tokens, d), dtype=c.dtype, device=c.device)
                    for c in self.prompt]


class DeepseekV2Model:
    """The decoder's tensors and its two paths: ``prefill`` of packed prompts
    and ``decode_step`` of slots."""

    LAYER = _Layer

    def __init__(self, config: DeepseekV2Config, device: DeviceLike = "cuda"):
        self.config = cfg = config
        self.device = dev = resolve_device(device)
        self.dtype = dt = getattr(torch, cfg.dtype)
        self.embed = torch.empty((cfg.vocab_size, cfg.hidden_size), dtype=dt, device=dev)
        self.layers = [self.LAYER(cfg, i, dt, dev) for i in range(cfg.num_hidden_layers)]
        self.norm = torch.empty((cfg.hidden_size,), dtype=dt, device=dev)
        self.lm_head = torch.empty((cfg.vocab_size, cfg.hidden_size), dtype=dt, device=dev)
        self.scale = softmax_scale(cfg)
        self.inv_freq = yarn_inv_freq(cfg).to(dev)
        self.rope_m = rope_mscale(cfg)
        self.top_k = cfg.num_experts_per_tok
        # 1 .. E: sorted expert ids below each of these end each expert's group.
        self.expert_ends = torch.arange(1, (cfg.n_routed_experts or 0) + 1, device=dev)
        # (first, count) of the experts an expert share holds; None: all of them.
        self.held: Optional[Tuple[int, int]] = None
        # Each expert layer's chosen experts, appended while not None.
        self.route_log: Optional[List[torch.Tensor]] = None
        # Each layer's attention input (normed) and output at the rows
        # ``attn_rows``, appended while not None.
        self.attn_log: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        self.attn_rows: Optional[torch.Tensor] = None

    # -- weights --------------------------------------------------------------------

    def published(self) -> Iterator[Tuple[str, torch.Tensor]]:
        """(published name, the tensor or the view that holds it) for every weight."""
        yield "model.embed_tokens.weight", self.embed
        for i, layer in enumerate(self.layers):
            yield from layer.published(f"model.layers.{i}.", self.config)
        yield "model.norm.weight", self.norm
        yield "lm_head.weight", self.lm_head

    def num_params(self) -> int:
        return sum(t.numel() for _, t in self.published())

    @staticmethod
    def build_kernels() -> None:
        """Compile the card's kernels of the decode step."""
        mla.build()

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy the published checkpoint's tensors in by name."""
        for name, target in self.published():
            target.copy_(state[name])
        self._refresh()

    @torch.no_grad()
    def draw_weights(self, seed: int) -> None:
        """Each named tensor from its own generator on the device, seeded with
        ``tensor_seed(seed, name)``: normal(0, ``initializer_range``) rounded
        to the storage precision, RMSNorm weights 1."""
        std = self.config.initializer_range
        for name, target in self.published():
            if is_norm(name):
                target.fill_(1.0)
                continue
            g = torch.Generator(device=self.device).manual_seed(tensor_seed(seed, name))
            target.copy_(torch.randn(tuple(target.shape), generator=g, device=self.device,
                                     dtype=torch.float32) * std)
        self._refresh()

    def _refresh(self) -> None:
        for layer in self.layers:
            if layer.moe:
                layer.gate_f32 = layer.gate.float()

    # -- pieces -----------------------------------------------------------------------

    def rope(self, pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        freqs = pos.float()[:, None] * self.inv_freq[None, :]
        return freqs.cos() * self.rope_m, freqs.sin() * self.rope_m

    def _qkv(self, layer: _Layer, h: torch.Tensor, cos, sin):
        """(q_nope [T, nh, nope], q_pe [T, nh, rope] roped, latent [T, r + rope]);
        ``cos`` and ``sin`` None leave the rope columns unrotated."""
        cfg = self.config
        t, nh, r = h.shape[0], cfg.num_attention_heads, cfg.kv_lora_rank
        q = F.linear(h, layer.q_proj).view(t, nh, cfg.qk_head_dim)
        kv = F.linear(h, layer.kv_a)
        c = rms_norm(kv[:, :r], layer.kv_norm, cfg.rms_norm_eps)
        # The heads' rope queries and the shared rope key, rotated together
        # (left as they are without rope: ``cos`` None).
        pe = torch.cat([q[..., cfg.qk_nope_head_dim :], kv[:, None, r:]], dim=1)
        if cos is not None:
            pe = apply_rope(pe, cos[:, None], sin[:, None])
        return q[..., : cfg.qk_nope_head_dim], pe[:, :nh], torch.cat([c, pe[:, nh]], dim=-1)

    @staticmethod
    def store_latent(gen: torch.Tensor, t: int, latent: torch.Tensor) -> None:
        """Write each slot's latent [S, latent] at its generated position ``t``."""
        gen[:, t] = latent

    @staticmethod
    def store_prompt_latents(cache: torch.Tensor, flat: torch.Tensor,
                             latent: torch.Tensor) -> None:
        """Write packed prompt tokens' latents [T, latent] to ``cache`` [P, Lp,
        latent] at the flat positions ``flat`` (prompt * Lp + position)."""
        cache.view(-1, cache.shape[-1])[flat] = latent

    def _attn_prefill(self, layer: _Layer, h: torch.Tensor, cos, sin, pack: Dict,
                      cache: torch.Tensor) -> torch.Tensor:
        """Decompressed causal attention over packed prompt tokens h [T, hidden];
        writes their latents to ``cache`` [P, Lp, latent]."""
        cfg = self.config
        t, nh = h.shape[0], cfg.num_attention_heads
        nope, rope, qk, v = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.qk_head_dim,
                             cfg.v_head_dim)
        q_nope, q_pe, latent = self._qkv(layer, h, cos, sin)
        flat = pack["flat"]
        p, lp = cache.shape[:2]
        self.store_prompt_latents(cache, flat, latent)
        c, k_pe = latent[:, : cfg.kv_lora_rank], latent[:, cfg.kv_lora_rank :]
        kv = F.linear(c, layer.kv_b).view(t, nh, nope + v)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([kv[..., :nope], k_pe[:, None, :].expand(t, nh, rope)], dim=-1)
        # Values padded to the query width: one head width for the kernel.
        val = F.pad(kv[..., nope:], (0, qk - v))

        def padded(z):
            out = z.new_zeros((p * lp, nh, qk))
            out[flat] = z
            return out.view(p, lp, nh, qk).transpose(1, 2)

        o = F.scaled_dot_product_attention(padded(q), padded(k), padded(val), is_causal=True,
                                           scale=self.scale)
        o = o.transpose(1, 2).reshape(p * lp, nh, qk)[flat][..., :v]
        return F.linear(o.reshape(t, nh * v), layer.o_proj)

    def _attn_decode(self, layer: _Layer, i: int, h: torch.Tensor, cos, sin,
                     cache: LatentCache, t: int) -> torch.Tensor:
        """Absorbed attention of the slots h [S, hidden] over their prompt's
        latents and their own first ``t + 1`` generated positions."""
        cfg = self.config
        s, nh, r = h.shape[0], cfg.num_attention_heads, cfg.kv_lora_rank
        q_nope, q_pe, latent = self._qkv(layer, h, cos, sin)
        gen = cache.gen[i]
        self.store_latent(gen, t, latent)
        q_lat = torch.bmm(q_nope.transpose(0, 1), layer.w_uk)        # [nh, S, r]
        q = torch.cat([q_lat.transpose(0, 1), q_pe], dim=-1)         # [S, nh, latent]
        o = mla.mla_decode(q, cache.prompt[i], cache.lens, gen, t, cache.group, self.scale, r)
        o = torch.bmm(o.transpose(0, 1), layer.w_uv_t)               # [nh, S, v]
        return F.linear(o.transpose(0, 1).reshape(s, nh * cfg.v_head_dim), layer.o_proj)

    def route(self, layer: _Layer, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights [T, k] f32, experts [T, k]) over all routed experts, the
        gate in float32: a softmax and greedy top-k; or, with the layer's
        ``score_bias``, sigmoid scores, the top-k of score + bias chosen and
        the chosen raw scores as weights. Renormalised where
        ``norm_topk_prob``, times ``routed_scaling_factor``."""
        cfg = self.config
        logits = F.linear(h.float(), layer.gate_f32)
        if layer.score_bias is None:
            weight, idx = torch.topk(torch.softmax(logits, dim=-1), self.top_k, dim=-1,
                                     sorted=False)
        else:
            scores = torch.sigmoid(logits)
            idx = torch.topk(scores + layer.score_bias, self.top_k, dim=-1, sorted=False).indices
            weight = scores.gather(1, idx)
        if self.top_k > 1 and cfg.norm_topk_prob:
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        if cfg.routed_scaling_factor != 1.0:
            weight = weight * cfg.routed_scaling_factor
        return weight, idx

    def shared_experts(self, layer: _Layer, h: torch.Tensor) -> torch.Tensor:
        return swiglu(h, layer.w_gate_up, layer.w_down)

    def _moe(self, layer: _Layer, h: torch.Tensor) -> torch.Tensor:
        """The expert layer over h [T, hidden]."""
        parts = [self._routed(layer, h[lo : lo + MOE_CHUNK])
                 for lo in range(0, h.shape[0], MOE_CHUNK)]
        out = torch.cat([o for o, _ in parts]) if len(parts) > 1 else parts[0][0]
        if self.route_log is not None:
            self.route_log.append(torch.cat([i for _, i in parts]))
        if self.config.n_shared_experts:
            out = out + self.shared_experts(layer, h)
        return out

    def _routed(self, layer: _Layer, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the routed experts' weighed sum, the chosen experts): the
        token-expert pairs sorted by expert, each expert's product over its
        group by one grouped product a matrix (``torch._grouped_mm``, the
        groups' ends as offsets), so the host never waits for the counts.
        With an expert share (``held``) only the held experts' pairs are
        computed: the others sort past the last group, whose end the grouped
        products stop at, and their rows are summed into a spare row."""
        n, hidden = h.shape
        k = self.top_k
        weight, idx = self.route(layer, h)
        profiling.count("moe.pairs", n * k)
        flat = idx.reshape(-1)
        if self.held is not None:
            lo, e = self.held
            flat = torch.where((flat >= lo) & (flat < lo + e), flat - lo, e)
        order = torch.argsort(flat, stable=True)
        # Each group's end in the sorted pairs; searchsorted, unlike bincount,
        # sizes nothing from the data, so nothing is read back.
        ends = torch.searchsorted(flat[order], self.expert_ends, out_int32=True)
        token = order // k
        up = torch._grouped_mm(h[token], layer.w13, offs=ends)
        half = up.shape[-1] // 2
        y = torch._grouped_mm(F.silu(up[:, :half]) * up[:, half:], layer.w2, offs=ends)
        if self.held is None:
            out = torch.zeros((n, hidden), dtype=torch.float32, device=h.device)
            out.index_add_(0, token, y.float() * weight.reshape(-1)[order][:, None])
            return out.to(h.dtype), idx
        profiling.count_device("moe.local_pairs", ends[-1])
        dest = torch.where(torch.arange(n * k, device=h.device) < ends[-1], token, n)
        out = torch.zeros((n + 1, hidden), dtype=torch.float32, device=h.device)
        out.index_add_(0, dest, y.float() * weight.reshape(-1)[order][:, None])
        return out[:n].to(h.dtype), idx

    def _ffn(self, layer: _Layer, h: torch.Tensor) -> torch.Tensor:
        if layer.moe:
            return self._moe(layer, h)
        return swiglu(h, layer.w_gate_up, layer.w_down)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.norm, self.config.rms_norm_eps)
        return F.linear(x, self.lm_head).float()

    def _layers(self, x: torch.Tensor, attend) -> torch.Tensor:
        eps = self.config.rms_norm_eps
        for i, layer in enumerate(self.layers):
            with profiling.device_range(layer.mixer):
                h = rms_norm(x, layer.ln_in, eps)
                a = attend(layer, i, h)
                if self.attn_log is not None:
                    self.attn_log.append((h[self.attn_rows], a[self.attn_rows]))
                x = x + a
            with profiling.device_range("moe" if layer.moe else "mlp"):
                x = x + self._ffn(layer, rms_norm(x, layer.ln_post, eps))
        return x

    # -- the two paths ----------------------------------------------------------------

    def pack(self, prompts: Sequence[torch.Tensor]) -> Dict:
        """The prompts' ids packed: ``tok`` [T], ``lens`` [P], ``starts`` [P],
        each token's prompt ``pid``, ``pos`` in it and ``flat`` position
        (prompt * Lp + pos) in a padded [P, Lp] layout, and ``p``, ``lp``."""
        dev = self.device
        lens = torch.tensor([len(p) for p in prompts], dtype=torch.long, device=dev)
        p, lp = len(prompts), max(len(x) for x in prompts)
        tok = torch.cat(list(prompts)).to(dev)
        pid = torch.repeat_interleave(torch.arange(p, device=dev), lens)
        starts = torch.cumsum(lens, 0) - lens
        pos = torch.arange(tok.shape[0], device=dev) - starts[pid]
        return {"tok": tok, "lens": lens, "starts": starts, "pos": pos, "pid": pid,
                "flat": pid * lp + pos, "p": p, "lp": lp}

    @torch.inference_mode()
    def prefill(self, prompts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, LatentCache]:
        """Each prompt's ids [L_p] (on the device) once: (the logits [P,
        vocab] f32 at each prompt's last position, the cache of their latents)."""
        dev = self.device
        pack = self.pack(prompts)
        tok, lens, starts, pos, p, lp = (pack[k] for k in ("tok", "lens", "starts", "pos", "p",
                                                           "lp"))
        cache = [torch.zeros((p, lp, self.config.latent_dim), dtype=self.dtype, device=dev)
                 for _ in self.layers]
        cos, sin = self.rope(pos)
        x = F.embedding(tok, self.embed)
        x = self._layers(x, lambda layer, i, h: self._attn_prefill(layer, h, cos, sin, pack,
                                                                   cache[i]))
        last = starts + lens - 1
        return self._head(x[last]), LatentCache(cache, lens)

    @torch.inference_mode()
    def decode_step(self, tok: torch.Tensor, pos: torch.Tensor, cache: LatentCache,
                    t: int) -> torch.Tensor:
        """Slot tokens [S] at positions ``pos`` [S], each slot's ``t``-th
        generated input: the next logits [S, vocab] f32."""
        cos, sin = self.rope(pos)
        x = F.embedding(tok, self.embed)
        x = self._layers(x, lambda layer, i, h: self._attn_decode(layer, i, h, cos, sin,
                                                                  cache, t))
        return self._head(x)


# -- the generator --------------------------------------------------------------------

class Capture:
    """What one call keeps of the rows ``rows`` (indices into its prompts),
    for a checker: per row, in ``out["rows"]``, its prompt ids, generated ids,
    logits [n, vocab] f32 (at the prompt's last position, then at each
    generated input), the chosen experts by expert layer ([L_p + n - 1, k])
    and each layer's attention input and output (``attn_in``, ``attn_out``:
    [L_p + n - 1, hidden] a layer, on the host); positions are the prompt's,
    then the generated inputs."""

    def __init__(self, rows: Sequence[int]):
        self.rows = [int(r) for r in rows]
        self.out: Dict = {}
        self._slots = None
        self._logits: List[torch.Tensor] = []
        self._prefill: Optional[Tuple[List[torch.Tensor], List]] = None
        self._decode: List[Tuple[List[torch.Tensor], List]] = []
        self._prompt_at: Dict[int, int] = {}

    def start(self, model: "DeepseekV2Model", lens: np.ndarray, prompt_of: np.ndarray,
              slot_of: np.ndarray) -> None:
        """Before the prefill: log the judged prompts' packed tokens."""
        dev = model.device
        self._slots = torch.as_tensor(slot_of[self.rows], dtype=torch.long, device=dev)
        self._logits, self._prefill, self._decode = [], None, []
        starts = np.cumsum(lens) - lens
        keep, self._prompt_at = [], {}
        for p in sorted({int(prompt_of[r]) for r in self.rows}):
            self._prompt_at[p] = sum(len(k) for k in keep)
            keep.append(np.arange(starts[p], starts[p] + lens[p]))
        model.route_log, model.attn_log = [], []
        model.attn_rows = torch.as_tensor(np.concatenate(keep), dtype=torch.long, device=dev)

    def step(self, model: "DeepseekV2Model", logits: torch.Tensor) -> None:
        """One sampled position's logits [S, vocab] and what the model logged
        on the way there: the prefill's first, then each decode step's."""
        self._logits.append(logits[self._slots])
        routes, attn = model.route_log, model.attn_log
        if self._prefill is None:
            self._prefill = (routes, [(h.cpu(), a.cpu()) for h, a in attn])
            model.attn_rows = self._slots
        else:
            self._decode.append(([r[self._slots] for r in routes], attn))
        model.route_log, model.attn_log = [], []

    def finish(self, model: "DeepseekV2Model", ids, prompt_of, out_h, n_h) -> None:
        model.route_log = model.attn_log = model.attn_rows = None
        lens = torch.tensor([len(x) for x in ids])
        starts = torch.cumsum(lens, 0) - lens
        logits = torch.stack(self._logits, dim=1)  # [rows, positions, vocab]
        pre_routes, pre_attn = self._prefill
        n_max = max(int(n_h[r]) for r in self.rows)
        steps = self._decode[: n_max - 1]
        # Per layer: [steps, rows, hidden] of the decode steps' inputs and outputs.
        dec = [tuple(torch.stack([s[1][li][w] for s in steps]).cpu() if steps else None
                     for w in (0, 1)) for li in range(len(pre_attn))]
        rows_out = []
        for j, r in enumerate(self.rows):
            p, n = int(prompt_of[r]), int(n_h[r])
            a, b = int(starts[p]), int(starts[p] + lens[p])
            routes = [torch.cat([pr[a:b]] + [s[0][li][j][None] for s in steps[: n - 1]]).cpu()
                      for li, pr in enumerate(pre_routes)]
            at = self._prompt_at[p]
            attn = [[torch.cat([pre[w][at : at + b - a]]
                               + ([d[w][: n - 1, j]] if d[w] is not None else []))
                     for w in (0, 1)] for pre, d in zip(pre_attn, dec)]
            rows_out.append({"prompt": list(ids[p]), "generated": out_h[r, :n].tolist(),
                             "logits": logits[j, :n].cpu(), "routes": routes,
                             "attn_in": [x[0] for x in attn], "attn_out": [x[1] for x in attn]})
        self.out = {"rows": rows_out}


class _Samples:
    """The slots' sampled tokens [S, max_tokens] and the log-probabilities of
    each under the T = 1 model, summed and least, over each slot's
    generated span up to EOS; dead slots (padding) take none."""

    def __init__(self, dead: torch.Tensor, max_tokens: int, temps: torch.Tensor,
                 tops: torch.Tensor, seed: int, eos: int):
        dev, slots = dead.device, dead.shape[0]
        self.temps, self.tops, self.eos = temps, tops, eos
        self.gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.ar = torch.arange(slots, device=dev)
        self.out = torch.zeros((slots, max_tokens), dtype=torch.long, device=dev)
        self.lp_sum = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self.lp_min = torch.full((slots,), float("inf"), dtype=torch.float32, device=dev)
        self.n_gen = torch.zeros((slots,), dtype=torch.long, device=dev)
        self.done = dead.clone()

    def take(self, t: int, logits: torch.Tensor) -> torch.Tensor:
        """Sample each slot's ``t``-th token from ``logits`` [S, vocab]."""
        tok = sample_top_p(logits, self.temps, self.tops, self.gen)
        active = ~self.done
        self.out[:, t] = torch.where(active, tok, torch.zeros_like(tok))
        lp = torch.log_softmax(logits, dim=-1)[self.ar, tok]
        self.lp_sum += torch.where(active, lp, torch.zeros_like(lp))
        self.lp_min = torch.minimum(self.lp_min,
                                    torch.where(active, lp, torch.full_like(lp, float("inf"))))
        self.n_gen += active.long()
        self.done |= active & (tok == self.eos)
        return tok


class DeepseekV2LM:
    """Batched sampler over ``DeepseekV2Model`` on ``device``."""

    CONFIG, MODEL = DeepseekV2Config, DeepseekV2Model

    def __init__(self, config: Optional[DeepseekV2Config] = None, seed: int = 0,
                 device: DeviceLike = "cuda", tokenizer: Optional[WordTokenizer] = None):
        self.config = config or self.CONFIG()
        self.model = self.MODEL(self.config, device)
        self.device = self.model.device
        if self.device.type == "cuda":
            self.model.build_kernels()  # at set-up rather than at the first step
        self.model.draw_weights(seed)
        self.tokenizer = tokenizer or WordTokenizer(min(100_000, self.config.vocab_size - 2))
        if self.tokenizer.eos >= self.config.vocab_size:
            raise ValueError("the tokenizer's ids do not fit the vocabulary")
        # The last call's counts: rows, distinct prompts, their lengths, the
        # slots a prompt, decode steps, tokens generated, rows with none.
        self.last_stats: Dict = {}
        # Set to a ``Capture`` to keep its rows' ids, logits and routes of the next call.
        self.capture: Optional[Capture] = None

    def _encode(self, prompts: Sequence[str]):
        """(distinct prompts' ids, each row's distinct prompt, slot of each row, group)."""
        index: Dict[str, int] = {}
        prompt_of = [index.setdefault(p, len(index)) for p in prompts]
        group = int(np.bincount(prompt_of).max())
        seen = np.zeros(len(index), dtype=np.int64)
        slot = []
        for p in prompt_of:
            slot.append(p * group + int(seen[p]))
            seen[p] += 1
        ids = [self.tokenizer.encode(text) for text in index]
        if max(len(x) for x in ids) >= self.config.max_position_embeddings:
            raise ValueError("a prompt is past max_position_embeddings")
        return ids, np.asarray(prompt_of), np.asarray(slot), group

    @torch.inference_mode()
    def generate_batch_scored(self, prompts: Sequence[str], temperatures: Sequence[float],
                              top_ps: Sequence[float], max_tokens: int = 100,
                              seed: Optional[int] = None):
        """(texts, mean_logprob [B], min_logprob [B]): the log-probabilities of
        the sampled tokens under the T = 1 model over the generated span, EOS
        included; 0.0 for an empty generation."""
        rows = len(prompts)
        if rows == 0:
            return [], np.zeros(0), np.zeros(0)
        if max_tokens < 1:
            raise ValueError("max_tokens must be at least 1")
        dev, model, cap = self.device, self.model, self.capture
        on_card = dev.type == "cuda"
        with profiling.span("generate", n=rows):
            with profiling.span("generate.encode"):
                ids, prompt_of, slot_of, group = self._encode(prompts)
                slots = len(ids) * group
                temps = np.ones(slots, dtype=np.float32)
                tops = np.ones(slots, dtype=np.float32)
                temps[slot_of] = np.asarray(temperatures, dtype=np.float32)
                tops[slot_of] = np.asarray(top_ps, dtype=np.float32)
                dead = np.ones(slots, dtype=bool)
                dead[slot_of] = False
                lens = np.asarray([len(x) for x in ids], dtype=np.int64)
                prompt_t = [torch.tensor(x, dtype=torch.long).to(dev, non_blocking=True)
                            for x in ids]
                slot_prompt = torch.arange(slots, device=dev) // group
                samples = _Samples(torch.from_numpy(dead).to(dev), max_tokens,
                                   torch.from_numpy(temps).to(dev),
                                   torch.from_numpy(tops).to(dev), seed or 0, self.tokenizer.eos)
            if cap is not None:
                cap.start(model, lens, prompt_of, slot_of)
            n_tok = int(lens.sum())
            with profiling.span("generate.prefill", cuda=on_card, n=n_tok):
                logits, cache = model.prefill(prompt_t)
            with profiling.span("generate.fork", cuda=on_card):
                cache.fork(group, max_tokens)
                logits = logits[slot_prompt]
                base = torch.from_numpy(lens).to(dev)[slot_prompt]
                if cap is not None:
                    cap.step(model, logits)
                tok = samples.take(0, logits)
            steps = 0
            with profiling.span("generate.decode", cuda=on_card) as sp:
                for t in range(1, max_tokens):
                    logits = model.decode_step(tok, base + (t - 1), cache, t - 1)
                    steps = t
                    if cap is not None:
                        cap.step(model, logits)
                    tok = samples.take(t, logits)
                    if t % 8 == 0 and bool(samples.done.all()):
                        break
                if sp is not None:
                    sp.n = steps
            with profiling.span("generate.readback"):
                sel = torch.as_tensor(slot_of, dtype=torch.long, device=dev)
                out_h = samples.out[sel].cpu().numpy()
                n_h = samples.n_gen[sel].cpu().numpy()
                lp_sum = samples.lp_sum[sel].cpu().numpy()
                lp_min = samples.lp_min[sel].cpu().numpy()
                texts = [self.tokenizer.decode(out_h[i, : n_h[i]]) for i in range(rows)]
            if cap is not None:
                cap.finish(model, ids, prompt_of, out_h, n_h)
            self._count(rows, lens, prompt_of, steps, int(n_h.sum()), group,
                        int((n_h == 0).sum()))
        has = n_h > 0
        mean_lp = np.where(has, lp_sum / np.maximum(n_h, 1), 0.0)
        min_lp = np.where(has, lp_min, 0.0)
        return texts, mean_lp.astype(np.float64), min_lp.astype(np.float64)

    def _count(self, rows, lens, prompt_of, steps, tokens, group, empty) -> None:
        self.last_stats = {"rows": rows, "prompts": len(lens), "prompt_lens": lens.tolist(),
                           "group": group, "steps": steps, "tokens": tokens,
                           "empty_rows": empty}
        profiling.count("gen.rows", rows)
        profiling.count("gen.prompts", len(lens))
        profiling.count("gen.prefill_tokens", int(lens.sum()))
        profiling.count("gen.prefill_pairs", int((lens * (lens + 1) // 2).sum()))
        profiling.count("gen.decode_steps", steps)
        profiling.count("gen.decode_positions", steps * rows)
        # Decode step t (from 0) attends over the prompt and t + 1 own positions.
        per_row = int(lens[prompt_of].sum())
        profiling.count("gen.cache_positions", steps * per_row + rows * steps * (steps + 1) // 2)
        profiling.count("gen.tokens", tokens)

    def generate_batch(self, prompts: Sequence[str], temperatures: Sequence[float],
                       top_ps: Sequence[float], max_tokens: int = 100,
                       seed: Optional[int] = None) -> List[str]:
        return self.generate_batch_scored(prompts, temperatures, top_ps, max_tokens, seed)[0]

    def generate(self, prompt: str, temperature: float = 0.1, top_p: float = 0.9,
                 max_tokens: int = 100, seed: Optional[int] = None) -> str:
        return self.generate_batch([prompt], [temperature], [top_p], max_tokens, seed)[0]
