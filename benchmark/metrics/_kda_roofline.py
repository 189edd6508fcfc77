"""The Kimi Linear generator's work from its configuration and a call's
shapes: the least times of its KDA layers and of the KDA decode kernel, and
the model's operations.

Counted from the model's equations, whatever implements them. A least time
is the larger of the operations at the bf16 peak and the bytes at the HBM
peak (``peaks.json``), taken for each layer of each step and summed; each
input read once and each output written once, at 2 bytes a bfloat16 value
and 4 a float32 one.

- KDA layer (one layer, one step): its weights once (the q, k, v, f_a,
  g_a and b projections, f_b, g_b, o_proj and the conv in bf16; A_log and
  dt_bias in f32); the rows' hidden states in and out. Operations: 2 x the
  projections' weights a token, and the recurrence's 7 K V a token and
  head (the decay, S^T k, the rank-one update and S^T q; the L2 norms, the
  gate and the output norm, O(K) a head, are left out). Prefill: each
  distinct prompt's end state and conv tail written. Decode: each row's
  state (H K V f32) and conv tail (taps - 1 inputs of 3 H K) read and
  written.
- KDA decode kernel (one launch of R rows): the states read and written,
  x (3 H K), the tails read and written, f, the gate and the output (H K
  each), beta (H), and the conv weights, dt_bias, A_log and o_norm.
- Whole model, for MFU: the linear layers' operations a token (KDA and
  MLA projections, the dense FFN, the router's gate over every routed
  expert, the shared expert, 2 x hidden x vocab a logits row), the routed
  experts' 2 x 3 x hidden x width for each pair the chip computed
  (``moe.local_pairs``), the KDA recurrence, and MLA's scores and values
  over the query-key pairs and cached positions the counters give.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from benchmark.metrics._gen_roofline import attn_params

BF16, F32 = 2, 4


def shape(cfg: Dict) -> Tuple[int, int, int]:
    """(heads, head width, conv taps) of a KDA layer."""
    la = cfg["linear_attn_config"]
    return la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]


def layer_counts(cfg: Dict) -> Dict[str, int]:
    la = cfg["linear_attn_config"]
    n = cfg["num_hidden_layers"]
    moe = sum(1 for i in range(n) if i >= cfg["first_k_dense_replace"]
              and i % cfg["moe_layer_freq"] == 0)
    return {"kda": len(la["kda_layers"]), "mla": len(la["full_attn_layers"]),
            "moe": moe, "dense": n - moe}


def kda_proj_params(cfg: Dict) -> int:
    """A KDA layer's projection weights (the products a token runs through)."""
    h = cfg["hidden_size"]
    nh, kd, _ = shape(cfg)
    hk = nh * kd
    return (3 * hk + 2 * kd + nh) * h + 2 * hk * kd + h * hk


def kda_weight_bytes(cfg: Dict) -> int:
    nh, kd, taps = shape(cfg)
    hk = nh * kd
    return BF16 * (kda_proj_params(cfg) + 3 * hk * taps + kd) + F32 * (nh + hk)


def _state_ops(cfg: Dict) -> int:
    nh, kd, _ = shape(cfg)
    return 7 * nh * kd * kd


def _kda_parts(cfg: Dict, lens: Sequence[int], group: int, steps: int) -> List[Tuple]:
    """(operations, bytes) of one KDA layer: the prefill of the distinct
    prompts ``lens``, then each of ``steps`` decode steps of ``group`` rows
    a prompt."""
    h = cfg["hidden_size"]
    nh, kd, taps = shape(cfg)
    state, tail = F32 * nh * kd * kd, BF16 * (taps - 1) * 3 * nh * kd
    per_token = 2.0 * kda_proj_params(cfg) + _state_ops(cfg)
    tokens, prompts, rows = sum(lens), len(lens), len(lens) * group
    parts = [(per_token * tokens,
              kda_weight_bytes(cfg) + 2 * BF16 * tokens * h + prompts * (state + tail))]
    step = (per_token * rows, kda_weight_bytes(cfg) + 2 * BF16 * rows * h
            + 2 * rows * (state + tail))
    return parts + [step] * steps


def _least(ops: float, nbytes: float, peaks: Dict) -> float:
    return max(ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def kda_least_s(cfg: Dict, lens: Sequence[int], group: int, steps: int, peaks: Dict) -> float:
    """The KDA layers' least seconds in one call, summed over the layers."""
    parts = _kda_parts(cfg, lens, group, steps)
    return layer_counts(cfg)["kda"] * sum(_least(o, b, peaks) for o, b in parts)


def kernel_bytes(cfg: Dict, rows: int) -> int:
    """One launch of the KDA decode kernel over ``rows`` rows."""
    nh, kd, taps = shape(cfg)
    hk = nh * kd
    per_row = (2 * F32 * nh * kd * kd + BF16 * (3 * hk + 2 * (taps - 1) * 3 * hk
                                                + 3 * hk + nh))
    return rows * per_row + BF16 * (3 * hk * taps + kd) + F32 * (hk + nh)


def kernel_least_s(cfg: Dict, rows: int, launches: int, peaks: Dict) -> float:
    return launches * kernel_bytes(cfg, rows) / peaks["hbm_bytes_per_s"]


def model_ops(cfg: Dict, counters: Dict[str, int]) -> float:
    """The model's operations for the tokens the counters of a window give."""
    h, vocab = cfg["hidden_size"], cfg["vocab_size"]
    heads, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    latent, v = r + cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    n = layer_counts(cfg)
    routed = cfg["expert_parallel"]["experts"] if cfg.get("expert_parallel") \
        else cfg["num_experts"]
    expert = 3 * h * cfg["moe_intermediate_size"]
    per_token = 2.0 * (n["kda"] * kda_proj_params(cfg) + n["mla"] * attn_params(cfg)
                       + n["dense"] * 3 * h * cfg["intermediate_size"]
                       + n["moe"] * (h * routed + expert * cfg["num_shared_experts"]))
    per_token += n["kda"] * _state_ops(cfg)
    tokens = counters.get("kda.prefill_tokens", 0) + counters.get("gen.decode_positions", 0)
    heads_out = counters.get("gen.prompts", 0) + counters.get("gen.decode_positions", 0)
    attn = n["mla"] * 2.0 * heads * ((qk + v) * counters.get("gen.prefill_pairs", 0)
                                     + (latent + r) * counters.get("gen.cache_positions", 0))
    return (per_token * tokens + 2.0 * expert * counters.get("moe.local_pairs", 0)
            + 2.0 * h * vocab * heads_out + attn)
