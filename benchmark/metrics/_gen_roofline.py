"""The generator's work from its configuration and a call's shapes: the least
times of its latent attention and expert layers, and the model's operations.

Counted from the model's equations, whatever implements them. A least time
is the larger of the operations at the bf16 peak and the bytes at the HBM
peak (``peaks.json``), taken for each layer of each step and summed; bytes
at 2 a bfloat16 value, each input read once and each output written once.

- Latent attention (one layer, one step): its weights once (``q_proj``,
  ``kv_a_proj_with_mqa``, ``kv_b_proj``, ``o_proj``); the rows' hidden
  states in and out. Prefill: the prompt tokens' projections and the
  decompression (2 x params a token), causal scores and values (2 x heads
  x (qk + v) a query-key pair), the latents written. Decode: the rows'
  projections and the absorbed ``W_UK`` and ``W_UV`` (the same 2 x
  ``kv_b`` params a row), the scores and the latent-space values over
  each cached position (2 x heads x (latent + kv_lora_rank)); each
  distinct prompt's latents read once, each row's own positions read,
  and its new latent written (latent values a position).
- Expert layer (one layer, one step): the gate (2 x hidden x experts a
  token), the routed experts (2 x 3 x hidden x width x k a token) and the
  shared ones (2 x 3 x hidden x width x shared); the gate and shared
  weights once, and the routed experts that ``rows`` tokens hit: ``E (1 -
  (1 - k / E) ** rows)`` of them, the expected count under routing spread
  evenly (all 64 at 320 rows: one is missed with a chance under 1e-13).
- Whole model, for MFU: the linear layers' operations a token (attention,
  the dense or expert FFN, 2 x hidden x vocab for each token's logits)
  and the attention's over the query-key pairs and cached positions that
  the port's counters give.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

BF16 = 2


def attn_params(cfg: Dict) -> int:
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, rope, v = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return (heads * qk * h + (r + rope) * h + heads * (cfg["qk_nope_head_dim"] + v) * r
            + h * heads * v)


def expert_params(cfg: Dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def layer_kinds(cfg: Dict):
    """(dense layers, expert layers)."""
    moe = sum(1 for i in range(cfg["num_hidden_layers"])
              if cfg.get("n_routed_experts") and i >= cfg["first_k_dense_replace"]
              and i % cfg["moe_layer_freq"] == 0)
    return cfg["num_hidden_layers"] - moe, moe


def _least(ops: float, nbytes: float, peaks: Dict) -> float:
    return max(ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def _mla_parts(cfg: Dict, lens: Sequence[int], group: int, steps: int) -> List[Tuple]:
    """(operations, bytes) of one layer's latent attention: the prefill of the
    distinct prompts ``lens``, then each of ``steps`` decode steps of
    ``group`` rows a prompt."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, v = cfg["kv_lora_rank"], cfg["v_head_dim"]
    latent = r + cfg["qk_rope_head_dim"]
    params = attn_params(cfg)
    tokens = sum(lens)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    parts = [(2.0 * tokens * params + 2.0 * heads * (qk + v) * pairs,
              BF16 * (params + 2 * tokens * h + tokens * latent))]
    rows = len(lens) * group
    prompt_latents = sum(lens) * latent
    for t in range(steps):
        cached = rows * (t + 1) + group * tokens
        parts.append((2.0 * rows * params + 2.0 * heads * (latent + r) * cached,
                      BF16 * (params + 2 * rows * h + prompt_latents + rows * (t + 2) * latent)))
    return parts


def _moe_parts(cfg: Dict, lens: Sequence[int], group: int, steps: int) -> List[Tuple]:
    """(operations, bytes) of one expert layer, as ``_mla_parts``."""
    h, e, k = cfg["hidden_size"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    shared = expert_params(cfg) * (cfg.get("n_shared_experts") or 0)
    one = expert_params(cfg)

    def layer(tokens: int) -> Tuple[float, float]:
        hit = e * (1.0 - (1.0 - k / e) ** tokens)
        return (2.0 * tokens * (h * e + one * k + shared),
                BF16 * (h * e + shared + hit * one + 2 * tokens * h))

    return [layer(sum(lens))] + [layer(len(lens) * group)] * steps


def mla_least_s(cfg: Dict, lens: Sequence[int], group: int, steps: int, peaks: Dict) -> float:
    """Latent attention's least seconds in one call: the prefill of the
    distinct prompts ``lens`` and ``steps`` decode steps of ``group`` rows a
    prompt, summed over the layers."""
    parts = _mla_parts(cfg, lens, group, steps)
    return cfg["num_hidden_layers"] * sum(_least(o, b, peaks) for o, b in parts)


def moe_least_s(cfg: Dict, lens: Sequence[int], group: int, steps: int, peaks: Dict) -> float:
    """The expert layers' least seconds in one call, as ``mla_least_s``."""
    parts = _moe_parts(cfg, lens, group, steps)
    return layer_kinds(cfg)[1] * sum(_least(o, b, peaks) for o, b in parts)


def call_ops(cfg: Dict, lens: Sequence[int], group: int, steps: int) -> float:
    """The model's operations in one call, from its shapes: the latent
    attention's and the expert layers' as their least times count them, the
    dense layers' and the head's (each prompt's last position and each
    decode position). ``model_ops`` counts the same from the counters."""
    h, vocab = cfg["hidden_size"], cfg["vocab_size"]
    dense, moe = layer_kinds(cfg)
    rows = len(lens) * group
    tokens = sum(lens) + steps * rows
    return (cfg["num_hidden_layers"] * sum(o for o, _ in _mla_parts(cfg, lens, group, steps))
            + moe * sum(o for o, _ in _moe_parts(cfg, lens, group, steps))
            + dense * 2.0 * 3 * h * cfg["intermediate_size"] * tokens
            + 2.0 * h * vocab * (len(lens) + steps * rows))


def model_ops(cfg: Dict, counters: Dict[str, int]) -> float:
    """The model's operations for the tokens the counters of a window give."""
    h, heads, vocab = cfg["hidden_size"], cfg["num_attention_heads"], cfg["vocab_size"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, v = cfg["kv_lora_rank"], cfg["v_head_dim"]
    latent = r + cfg["qk_rope_head_dim"]
    dense, moe = layer_kinds(cfg)
    k = cfg["num_experts_per_tok"]
    ffn = (dense * 3 * h * cfg["intermediate_size"]
           + moe * (h * cfg["n_routed_experts"]
                    + expert_params(cfg) * (k + (cfg.get("n_shared_experts") or 0))))
    per_token = 2.0 * (cfg["num_hidden_layers"] * attn_params(cfg) + ffn)
    tokens = counters.get("gen.prefill_tokens", 0) + counters.get("gen.decode_positions", 0)
    heads_out = counters.get("gen.prompts", 0) + counters.get("gen.decode_positions", 0)
    attn = cfg["num_hidden_layers"] * 2.0 * heads * (
        (qk + v) * counters.get("gen.prefill_pairs", 0)
        + (latent + r) * counters.get("gen.cache_positions", 0))
    return per_token * tokens + 2.0 * h * vocab * heads_out + attn
