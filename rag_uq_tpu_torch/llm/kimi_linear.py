"""Kimi Linear as the port's generator: Kimi Delta Attention (KDA) layers
beside latent attention without rope, and sigmoid-routed experts, sampled
through the port's MC path.

The equations are Kimi Linear's ("Kimi Linear: An Expressive, Efficient
Attention Architecture", arXiv:2510.26692) as the published
``modeling_kimi.py`` computes them (``KimiDeltaAttention``,
``KimiMLAAttention``, ``KimiMoEGate``, ``KimiSparseMoeBlock``), in bfloat16
with float32 norms, gates, router and recurrent state. ``linear_attn_config``
names the KDA layers and the full-attention (MLA) layers by 1-based index.

- KDA (per head, K = V = ``linear_attn_config["head_dim"]``), over the
  layer's normed input x: q, k, v = SiLU(causal depthwise conv of width
  ``short_conv_kernel_size`` over ``q_proj`` / ``k_proj`` / ``v_proj`` x,
  no bias, zero before a sequence's first token); q and k L2-normalised, q
  scaled by K ** -0.5; the per-channel log decay g = -exp(A_log[h]) *
  softplus(f_b(f_a(x)) + dt_bias) with a rank-K bottleneck; beta =
  sigmoid(b_proj x); the gated delta rule ``ops/kda.py`` states; the output
  ``o_proj(RMSNorm_head(o) * o_norm * sigmoid(g_b(g_a(x))))``.
- MLA with ``mla_use_nope``: DeepSeek-V2's latent attention
  (``llm/deepseek_v2.py``) with the 64 rope columns of the query and of the
  shared key left unrotated and the softmax scale ``(qk_nope + qk_rope) **
  -0.5``; its paths, cache and decode kernel are DeepSeek-V2's own.
- The first ``first_k_dense_replace`` FFNs dense, the rest expert layers:
  sigmoid scores of a float32 gate, the top-k of score +
  ``e_score_correction_bias`` chosen, the chosen raw scores renormalised
  (``moe_renormalize``) and scaled by ``routed_scaling_factor``, plus one
  shared expert. The expert product is DeepSeek-V2's grouped one.

**Expert share.** ``expert_parallel`` ({"experts": E, "ranks": R, "rank":
r}) states a deployment whose R chips share each expert layer: this chip
holds ``num_experts`` = E / R of them, from r * E / R on. The router keeps
all E outputs, and the layer computes the pairs routed to its own experts
only; attention, the dense layer, the shared expert, the embeddings and the
head are whole on every chip. Without it the layer holds all its experts.

**The cache** (``HybridCache``) holds two kinds of state. MLA layers keep
``LatentCache``'s latents: a prompt's shared by its slots, each slot's own
for its generated tokens. KDA layers keep a fixed-size state a row, [H, K,
V] float32, and the conv tail (the last ``short_conv_kernel_size - 1``
inputs). The prefill ends each distinct prompt's recurrence once
(``ops/kda.py::kda_chunked``: one launch a layer of the ``sm_90a`` kernel
``csrc/kda_prefill.cu`` on a card, each sequence's float32 state in
registers from its first token to its last; the chunked form in plain
torch on the CPU), and ``fork`` copies its end state and tail to each of
its slots, since the slots' samples diverge from their first token. A
decode step updates a KDA layer's states in place by one kernel launch
(``ops/kda.py::kda_decode``: ``csrc/kda_decode.cu`` on a card, the plain
twin on the CPU).

Weights carry the published checkpoint's names and are drawn from a seed
per named tensor (``draw_tensor``) without a checkpoint. ``KimiLinearLM``
is ``DeepseekV2LM`` over this model: the same scored contract, sampling
loop, counters and capture.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field, fields
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.llm.deepseek_v2 import (DeepseekV2LM, DeepseekV2Model, LatentCache,
                                              init_experts, init_mla, mla_published,
                                              mlp_published, tensor_seed)
from rag_uq_tpu_torch.ops import kda
from rag_uq_tpu_torch.ops import mla_decode as mla
from rag_uq_tpu_torch.utils import profiling

# dt's range for dt_bias = softplus^-1(dt), as fla's KDA layer initialises it.
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4


def _published_linear_attn() -> Dict:
    return {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
            "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23,
                           25, 26],
            "num_heads": 32, "short_conv_kernel_size": 4}


@dataclass
class KimiLinearConfig:
    """The published ``config.json`` keys that shape the model; the
    defaults are Kimi-Linear-48B-A3B-Instruct's. ``expert_parallel`` is the
    expert share (see the module's docstring), ``initializer_range`` and
    ``router_bias_std`` the weight recipe, ``dtype`` the port's precision."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mla_use_nope: bool = True
    linear_attn_config: Dict = field(default_factory=_published_linear_attn)
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    num_expert_group: int = 1
    topk_group: int = 1
    moe_renormalize: bool = True
    moe_router_activation_func: str = "sigmoid"
    routed_scaling_factor: float = 2.446
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict] = None
    model_max_length: int = 1048576
    tie_word_embeddings: bool = False
    expert_parallel: Optional[Dict] = None
    initializer_range: float = 0.02
    router_bias_std: float = 0.05
    dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: Mapping) -> "KimiLinearConfig":
        """The known keys of ``d``; keys that do not shape the model are ignored."""
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_dict(self) -> Dict:
        return asdict(self)

    def __post_init__(self):
        la = self.linear_attn_config
        unsupported = {"q_lora_rank": self.q_lora_rank is not None,
                       "mla_use_nope": not self.mla_use_nope,
                       "hidden_act": self.hidden_act != "silu",
                       "moe_router_activation_func": self.moe_router_activation_func != "sigmoid",
                       "num_expert_group": self.num_expert_group != 1 or self.topk_group != 1,
                       "tie_word_embeddings": self.tie_word_embeddings,
                       "rope_scaling": self.rope_scaling is not None}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"KimiLinearConfig: unsupported settings {bad}")
        every = sorted(la["kda_layers"] + la["full_attn_layers"])
        if every != list(range(1, self.num_hidden_layers + 1)):
            raise ValueError("kda_layers and full_attn_layers must split layers 1 .. "
                             f"{self.num_hidden_layers}")
        if self.routed_experts % self.num_experts or not 0 <= self.held_first < \
                self.routed_experts:
            raise ValueError(f"expert_parallel {self.expert_parallel} does not hold "
                             f"{self.num_experts} experts")

    # -- the names the shared code reads ---------------------------------------------

    @property
    def n_routed_experts(self) -> int:
        """The experts this chip holds."""
        return self.num_experts

    @property
    def n_shared_experts(self) -> int:
        return self.num_shared_experts

    @property
    def num_experts_per_tok(self) -> int:
        return self.num_experts_per_token

    @property
    def norm_topk_prob(self) -> bool:
        return self.moe_renormalize

    @property
    def max_position_embeddings(self) -> int:
        return self.model_max_length

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    # -- the layers -------------------------------------------------------------------

    @property
    def routed_experts(self) -> int:
        """The experts the router chooses among."""
        ep = self.expert_parallel
        return int(ep["experts"]) if ep else self.num_experts

    @property
    def held_first(self) -> int:
        ep = self.expert_parallel
        return int(ep["rank"]) * self.num_experts if ep else 0

    @property
    def kda_heads(self) -> int:
        return int(self.linear_attn_config["num_heads"])

    @property
    def kda_head_dim(self) -> int:
        return int(self.linear_attn_config["head_dim"])

    def is_kda(self, i: int) -> bool:
        return i + 1 in self.linear_attn_config["kda_layers"]

    def is_moe(self, i: int) -> bool:
        return i >= self.first_k_dense_replace and i % self.moe_layer_freq == 0


# -- weights ----------------------------------------------------------------------------

def is_norm(name: str) -> bool:
    return (name.endswith("layernorm.weight") or name.endswith("o_norm.weight")
            or name == "model.norm.weight")


def draw_tensor(name: str, shape: Tuple[int, ...], seed: int, std: float, bias_std: float,
                device) -> torch.Tensor:
    """The named tensor in float32 from a generator on ``device`` seeded with
    ``seed``: ones for a norm; ``A_log`` = log U(1, 16) and ``dt_bias`` =
    softplus^-1 of dt, log-uniform in [1e-3, 0.1] (floor 1e-4), as fla's KDA
    layer initialises them; a conv weight U(-1/2, 1/2) (``nn.Conv1d``'s
    default bound, 1 / sqrt(taps) for a depthwise width-4 conv); the
    router's correction bias normal(0, ``bias_std``); the rest
    normal(0, ``std``)."""
    if is_norm(name):
        return torch.ones(shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    if name.endswith("A_log"):
        return torch.log(torch.rand(shape, generator=g, device=device) * 15.0 + 1.0)
    if name.endswith("dt_bias"):
        u = torch.rand(shape, generator=g, device=device)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
        dt = dt.clamp(min=DT_FLOOR)
        return dt + torch.log(-torch.expm1(-dt))
    if name.endswith("conv1d.weight"):
        return (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * 0.5
    scale = bias_std if name.endswith("e_score_correction_bias") else std
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32) * scale


class _KimiLayer:
    """One decoder layer's tensors (no autograd): KDA or MLA, then a dense
    or an expert FFN. ``slot`` is its index among the layers of its mixer."""

    def __init__(self, cfg: KimiLinearConfig, i: int, dt: torch.dtype, dev: torch.device):
        h = cfg.hidden_size
        e = lambda *shape: torch.empty(shape, dtype=dt, device=dev)
        f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        self.moe, self.kda = cfg.is_moe(i), cfg.is_kda(i)
        self.mixer = "kda" if self.kda else "mla"
        self.slot = sum(cfg.is_kda(j) == self.kda for j in range(i))
        self.ln_in, self.ln_post = e(h), e(h)
        if self.kda:
            nh, kd = cfg.kda_heads, cfg.kda_head_dim
            hk = nh * kd
            # q, k, v | f_a | g_a | b: the projections of the layer's input, one product.
            self.w_in = e(3 * hk + 2 * kd + nh, h)
            self.conv_w = e(3 * hk, kda.TAPS)
            self.a_log, self.dt_bias = f32(nh), f32(hk)
            self.f_b, self.g_b = e(hk, kd), e(hk, kd)
            self.o_norm = e(kd)
            self.o_proj = e(h, hk)
        else:
            init_mla(self, cfg, e)
        if self.moe:
            w = cfg.moe_intermediate_size
            init_experts(self, cfg.routed_experts, cfg.num_experts, h, w,
                         w * cfg.num_shared_experts, e)
            self.score_bias = f32(cfg.routed_experts)
        else:
            w = cfg.intermediate_size
            self.w_gate_up, self.w_down = e(2 * w, h), e(h, w)

    def split_in(self, cfg: KimiLinearConfig, proj: torch.Tensor):
        """(x [T, 3 H K], f_a, g_a [T, K], b [T, H]): views of ``w_in``'s product."""
        nh, kd = cfg.kda_heads, cfg.kda_head_dim
        return proj.split([3 * nh * kd, kd, kd, nh], dim=-1)

    def published(self, p: str, cfg: KimiLinearConfig) -> Iterator[Tuple[str, torch.Tensor]]:
        yield p + "input_layernorm.weight", self.ln_in
        yield p + "post_attention_layernorm.weight", self.ln_post
        a = p + "self_attn."
        if self.kda:
            nh, kd = cfg.kda_heads, cfg.kda_head_dim
            hk = nh * kd
            for j, n in enumerate("qkv"):
                yield f"{a}{n}_proj.weight", self.w_in[j * hk : (j + 1) * hk]
                yield f"{a}{n}_conv1d.weight", self.conv_w[j * hk : (j + 1) * hk].view(
                    hk, 1, kda.TAPS)
            yield a + "f_a_proj.weight", self.w_in[3 * hk : 3 * hk + kd]
            yield a + "g_a_proj.weight", self.w_in[3 * hk + kd : 3 * hk + 2 * kd]
            yield a + "b_proj.weight", self.w_in[3 * hk + 2 * kd :]
            yield a + "f_b_proj.weight", self.f_b
            yield a + "g_b_proj.weight", self.g_b
            yield a + "A_log", self.a_log.view(1, 1, nh, 1)
            yield a + "dt_bias", self.dt_bias
            yield a + "o_norm.weight", self.o_norm
            yield a + "o_proj.weight", self.o_proj
        else:
            yield from mla_published(self, a)
        if not self.moe:
            yield from mlp_published(self, p + "mlp.")
            return
        m = p + "block_sparse_moe."
        yield m + "gate.weight", self.gate
        yield m + "gate.e_score_correction_bias", self.score_bias
        w, lo = cfg.moe_intermediate_size, cfg.held_first
        for j in range(cfg.num_experts):
            x = f"{m}experts.{lo + j}."
            yield x + "w1.weight", self.w13[j, :, :w].t()
            yield x + "w3.weight", self.w13[j, :, w:].t()
            yield x + "w2.weight", self.w2[j].t()
        yield from mlp_published(self, m + "shared_experts.")


class HybridCache(LatentCache):
    """Both kinds of a call's state: the MLA layers' latents (``prompt``,
    ``gen``, as ``LatentCache``; indexed by the layer's ``slot``) and the KDA
    layers' recurrent states. The prefill leaves each distinct prompt's end
    state ``prompt_state[j]`` [P, H, K, V] f32 and conv tail
    ``prompt_conv[j]`` [P, taps - 1, 3 H K]; ``fork`` gives each slot its
    own copies, ``state[j]`` [S, H, K, V] and ``conv[j]``, which the decode
    steps update in place, and drops the prompts'."""

    def __init__(self, prompt: List[torch.Tensor], lens: torch.Tensor, kda_layers: int):
        super().__init__(prompt, lens)
        self.prompt_state: List[Optional[torch.Tensor]] = [None] * kda_layers
        self.prompt_conv: List[Optional[torch.Tensor]] = [None] * kda_layers
        self.state: List[torch.Tensor] = []
        self.conv: List[torch.Tensor] = []

    def fork(self, group: int, max_tokens: int) -> None:
        super().fork(group, max_tokens)
        self.state = [s.repeat_interleave(group, dim=0) for s in self.prompt_state]
        self.conv = [c.repeat_interleave(group, dim=0) for c in self.prompt_conv]
        self.prompt_state = self.prompt_conv = []


class KimiLinearModel(DeepseekV2Model):
    """Kimi Linear's tensors and its two paths, ``prefill`` of packed
    prompts and ``decode_step`` of slots, on DeepSeek-V2's layer loop, MLA
    paths and expert layer."""

    LAYER = _KimiLayer

    def __init__(self, config: KimiLinearConfig, device: DeviceLike = "cuda"):
        super().__init__(config, device)
        if config.num_experts != config.routed_experts:
            self.held = (config.held_first, config.num_experts)
        self.kda_layers = sum(layer.kda for layer in self.layers)

    @staticmethod
    def build_kernels() -> None:
        mla.build()
        kda.build()

    @torch.no_grad()
    def draw_weights(self, seed: int) -> None:
        """Each named tensor by ``draw_tensor`` from ``tensor_seed(seed,
        name)``, rounded to the tensor's storage precision."""
        cfg = self.config
        for name, target in self.published():
            target.copy_(draw_tensor(name, tuple(target.shape), tensor_seed(seed, name),
                                     cfg.initializer_range, cfg.router_bias_std, self.device))
        self._refresh()

    # -- KDA ----------------------------------------------------------------------------

    def _kda_prefill(self, layer: _KimiLayer, h: torch.Tensor, pack: Dict,
                     cache: HybridCache) -> torch.Tensor:
        """The recurrence over packed prompt tokens h [T, hidden]
        (``kda.kda_chunked``: the kernel on a card); leaves each prompt's
        end state and conv tail in ``cache``."""
        cfg = self.config
        nh, kd = cfg.kda_heads, cfg.kda_head_dim
        t = h.shape[0]
        p, lp, flat, lens = pack["p"], pack["lp"], pack["flat"], pack["lens"]
        x, fa, ga, b = layer.split_in(cfg, F.linear(h, layer.w_in))
        pad = kda.TAPS - 1
        # The inputs in a [P, pad + Lp] layout, zero before each prompt's first token.
        xpad = x.new_zeros((p, pad + lp, x.shape[1]))
        xpad.view(-1, x.shape[1])[pack["pid"] * (pad + lp) + pack["pos"] + pad] = x
        c = kda.conv_prefill(xpad, layer.conv_w).view(p, lp, 3, nh, kd)
        tail = xpad[torch.arange(p, device=h.device)[:, None],
                    lens[:, None] + torch.arange(pad, device=h.device)]
        g = h.new_zeros((p * lp, nh, kd), dtype=torch.float32)
        g[flat] = kda.kda_gate(F.linear(fa, layer.f_b).view(t, nh, kd), layer.a_log,
                               layer.dt_bias.view(nh, kd))
        beta = h.new_zeros((p * lp, nh, 1), dtype=torch.float32)
        beta[flat] = torch.sigmoid(b.float())[..., None]

        def by_head(z):  # [P, Lp, H, d] -> [P * H, Lp, d], contiguous
            return z.reshape(p, lp, nh, -1).transpose(1, 2).reshape(p * nh, lp, -1).contiguous()

        o, state = kda.kda_chunked(by_head(kda.l2norm(c[:, :, 0]) * kd ** -0.5),
                                   by_head(kda.l2norm(c[:, :, 1])), by_head(c[:, :, 2]),
                                   by_head(g), by_head(beta).squeeze(-1))
        del c, g, beta
        o = o.view(p, nh, lp, kd).transpose(1, 2).reshape(p * lp, nh, kd)[flat]
        y = kda.gated_norm(o, layer.o_norm, F.linear(ga, layer.g_b).view(t, nh, kd),
                           cfg.rms_norm_eps)
        cache.prompt_state[layer.slot] = state.view(p, nh, kd, kd)
        cache.prompt_conv[layer.slot] = tail
        return F.linear(y.reshape(t, nh * kd).to(h.dtype), layer.o_proj)

    def _kda_decode(self, layer: _KimiLayer, h: torch.Tensor, cache: HybridCache) -> torch.Tensor:
        """One step of the slots h [S, hidden] through their states, in place."""
        cfg = self.config
        x, fa, ga, b = layer.split_in(cfg, F.linear(h, layer.w_in))
        y = kda.kda_decode(x, cache.conv[layer.slot], layer.conv_w, F.linear(fa, layer.f_b),
                           layer.a_log, layer.dt_bias, b, F.linear(ga, layer.g_b), layer.o_norm,
                           cache.state[layer.slot], cfg.rms_norm_eps)
        return F.linear(y, layer.o_proj)

    # -- the two paths ------------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, prompts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, HybridCache]:
        """Each prompt's ids [L_p] (on the device) once: (the logits [P,
        vocab] f32 at each prompt's last position, the cache of its states)."""
        pack = self.pack(prompts)
        p, lp = pack["p"], pack["lp"]
        latents = [torch.zeros((p, lp, self.config.latent_dim), dtype=self.dtype,
                               device=self.device) for layer in self.layers if not layer.kda]
        cache = HybridCache(latents, pack["lens"], self.kda_layers)
        profiling.count("kda.prefill_tokens", pack["tok"].shape[0])

        def attend(layer, i, h):
            if layer.kda:
                return self._kda_prefill(layer, h, pack, cache)
            return self._attn_prefill(layer, h, None, None, pack, latents[layer.slot])

        x = self._layers(F.embedding(pack["tok"], self.embed), attend)
        last = pack["starts"] + pack["lens"] - 1
        return self._head(x[last]), cache

    @torch.inference_mode()
    def decode_step(self, tok: torch.Tensor, pos: torch.Tensor, cache: HybridCache,
                    t: int) -> torch.Tensor:
        """Slot tokens [S], each slot's ``t``-th generated input: the next
        logits [S, vocab] f32 (``pos`` is unused: no layer takes positions)."""

        def attend(layer, i, h):
            if layer.kda:
                return self._kda_decode(layer, h, cache)
            return self._attn_decode(layer, layer.slot, h, None, None, cache, t)

        return self._head(self._layers(F.embedding(tok, self.embed), attend))


class KimiLinearLM(DeepseekV2LM):
    """Batched sampler over ``KimiLinearModel`` on ``device``: DeepSeek-V2's
    ``generate_batch_scored``, ``last_stats`` and ``capture``."""

    CONFIG, MODEL = KimiLinearConfig, KimiLinearModel
