"""TinyLM, a byte-level decoder with KV-cached sampling: the counterpart of
``rag_uq_tpu/llm/tiny_lm.py``.

The decoder is flax's ``DecoderModel`` with flax's numerics
(``core/flax_nn.py``): byte vocabulary (256 bytes, BOS, EOS), learned
positions, pre-LayerNorm blocks, a float32 output layer. Generation keeps
the JAX sampler's contract:

- prompts are BOS-prefixed, trimmed to ``max_prompt_len - 1`` bytes as one
  quarter head and three quarters tail, and padded to a power-of-two width
  (at least 32); the batch is padded to a power of two with BOS-only rows,
  whose outputs are dropped;
- every row advances in lockstep over one shared position: a row still
  inside its prompt is fed its next prompt byte, and step ``i`` writes its
  sample to column ``i + 1 - plen[r]`` of row ``r``'s output, until EOS or
  ``max_tokens``;
- ``sample_top_p`` keeps the smallest prefix of the sorted distribution
  whose mass reaches ``top_p``, then every token whose probability is at
  least the smallest kept one (ties stay in), and samples by Gumbel-max;
- ``generate_batch_scored`` also returns the mean and min log-probability
  of the sampled tokens under the raw model over the generated span, EOS
  included, 0.0 for an empty generation.

Differences of form, not of result: the KV cache is one ``[B, max_total_len,
H, Dh]`` tensor per layer for keys and one for values, written at the
shared position, and each step attends over the written prefix (flax masks
the unwritten rest, whose softmax weight is exactly 0). The positions that
every row forces (up to the shortest prompt's last byte) run as one causal
prefill instead of one step each; their samples were never used. The loop
stops once every row has finished.

Deviation: sampling draws from a ``torch.Generator`` on the model's device
seeded with ``seed``; the same seed on the same device gives the same text,
but JAX's ``jax.random`` stream cannot be reproduced, so sampled text is
not comparable across the two packages (greedy decoding is).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.flax_nn import (
    Dense, Embed, FlaxLeaf, LayerNorm, MultiHeadAttention, flax_leaves, gelu, load_flax_tree,
    torch_dtype,
)

BOS = 256
EOS = 257
VOCAB = 258


@dataclass(frozen=True)
class TinyLMConfig:
    dim: int = 256
    num_layers: int = 4
    num_heads: int = 8
    mlp_dim: int = 1024
    max_prompt_len: int = 1024
    max_total_len: int = 1280
    dtype: str = "bfloat16"


class KVCache:
    """Per-layer keys and values ``[B, max_total_len, H, Dh]``; ``index`` is
    the next position to write, shared by every row."""

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor]):
        self.keys, self.values, self.index = keys, values, 0


class DecoderLayer(nn.Module):
    def __init__(self, config: TinyLMConfig, gen: Optional[torch.Generator]):
        super().__init__()
        dt = torch_dtype(config.dtype)
        self.ln_attn = LayerNorm(config.dim, dt)
        self.attn = MultiHeadAttention(config.dim, config.num_heads, dt, gen)
        self.ln_mlp = LayerNorm(config.dim, dt)
        self.mlp_in = Dense(config.dim, config.mlp_dim, dt, gen)
        self.mlp_out = Dense(config.mlp_dim, config.dim, dt, gen)


class DecoderModel(nn.Module):
    """tok [B, S] at positions ``cache.index .. + S - 1`` -> logits [B, S, VOCAB]
    f32, writing keys and values into ``cache`` and advancing its index.

    Without a cache it is the training forward (``rag_uq_tpu/llm/train.py::
    _TrainableDecoder``, the same parameter tree): positions ``0 .. S - 1``
    under a causal mask that masks no padding (the loss mask does that)."""

    def __init__(self, config: TinyLMConfig, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        dt = torch_dtype(config.dtype)
        self.tok = Embed(VOCAB, config.dim, dt, gen)
        self.pos = Embed(config.max_total_len, config.dim, dt, gen)
        self.layers = nn.ModuleList(DecoderLayer(config, gen) for _ in range(config.num_layers))
        self.ln_out = LayerNorm(config.dim, dt)
        self.head = Dense(config.dim, VOCAB, torch.float32, gen)

    def flax_params(self) -> List[FlaxLeaf]:
        """The leaves of the flax tree. Its keys sort as strings (``Dense_10``
        before ``Dense_2``), so every layer is named by its number: layer
        ``i`` owns ``LayerNorm_{2i}``, ``MultiHeadDotProductAttention_{i}``,
        ``LayerNorm_{2i+1}``, ``Dense_{2i}`` and ``Dense_{2i+1}``."""
        n = self.config.num_layers
        leaves = flax_leaves(self.tok, ("Embed_0",)) + flax_leaves(self.pos, ("Embed_1",))
        for i, layer in enumerate(self.layers):
            leaves += (flax_leaves(layer.ln_attn, (f"LayerNorm_{2 * i}",))
                       + flax_leaves(layer.attn, (f"MultiHeadDotProductAttention_{i}",))
                       + flax_leaves(layer.ln_mlp, (f"LayerNorm_{2 * i + 1}",))
                       + flax_leaves(layer.mlp_in, (f"Dense_{2 * i}",))
                       + flax_leaves(layer.mlp_out, (f"Dense_{2 * i + 1}",)))
        return (leaves + flax_leaves(self.ln_out, (f"LayerNorm_{2 * n}",))
                + flax_leaves(self.head, (f"Dense_{2 * n}",)))

    def init_cache(self, batch: int) -> KVCache:
        cfg = self.config
        heads = cfg.num_heads
        shape = (batch, cfg.max_total_len, heads, cfg.dim // heads)
        dev, dt = self.tok.embedding.device, self.tok.dtype
        zeros = lambda: [torch.zeros(shape, dtype=dt, device=dev) for _ in self.layers]
        return KVCache(zeros(), zeros())

    def forward(self, tok: torch.Tensor, cache: Optional[KVCache] = None, logits: bool = True):
        start = 0 if cache is None else cache.index
        steps = tok.shape[1]
        end = start + steps
        if end > self.config.max_total_len:
            raise ValueError(f"position {end - 1} past max_total_len {self.config.max_total_len}")
        positions = torch.arange(start, end, device=tok.device)
        x = self.tok(tok) + self.pos(positions)[None]
        mask = None
        if steps > 1:  # causal over the new positions; every cached one is visible
            keys_pos = torch.arange(end, device=tok.device)
            mask = (keys_pos[None, :] <= positions[:, None])[None, None]
        for i, layer in enumerate(self.layers):
            q, k, v = layer.attn.qkv(layer.ln_attn(x))
            if cache is not None:
                kc, vc = cache.keys[i], cache.values[i]
                kc[:, start:end] = k
                vc[:, start:end] = v
                k, v = kc[:, :end], vc[:, :end]
            x = x + layer.attn.attend(q, k, v, mask)
            x = x + layer.mlp_out(gelu(layer.mlp_in(layer.ln_mlp(x))))
        if cache is not None:
            cache.index = end
        if not logits:
            return None
        return self.head(self.ln_out(x))


def top_p_support(
    logits: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(temperature-scaled logits [B, V], kept tokens [B, V] bool): the
    smallest prefix whose mass reaches top_p (at least one token), then
    every token at least as likely as the least likely one kept."""
    scaled = logits / temperature.clamp(min=1e-4)[:, None]
    probs = torch.softmax(scaled, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < top_p[:, None]
    inf = torch.full_like(sorted_probs, float("inf"))
    thresh = torch.where(keep_sorted, sorted_probs, inf).amin(dim=-1, keepdim=True)
    return scaled, probs >= thresh


def sample_top_p(
    logits: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor,
    generator: torch.Generator,
) -> torch.Tensor:
    """Temperature + nucleus sampling by Gumbel-max. logits [B, V];
    temperature and top_p [B]. Returns [B] int64 token ids."""
    scaled, keep = top_p_support(logits, temperature, top_p)
    masked = torch.where(keep, scaled, torch.full_like(scaled, float("-inf")))
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(masked + gumbel, dim=-1)


class TinyLM:
    """Batched sampler over the decoder, on ``device``."""

    def __init__(self, config: Optional[TinyLMConfig] = None, seed: int = 0,
                 device: DeviceLike = "cuda"):
        self.config = config or TinyLMConfig()
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.model = DecoderModel(self.config, gen).to(self.device).eval()
        # Counts of the last generate call: rows (padded), prefill positions,
        # decode steps run, and tokens generated by the caller's rows.
        self.last_stats = {"rows": 0, "prefill": 0, "steps": 0, "tokens": 0}

    def load_params(self, params) -> None:
        load_flax_tree(self.model.flax_params(), params)

    # -- encoding ---------------------------------------------------------------

    def _encode_prompts(self, prompts: Sequence[str]):
        cfg = self.config
        max_bytes = cfg.max_prompt_len - 1
        keep_tail = max_bytes * 3 // 4
        keep_head = max_bytes - keep_tail
        encoded = []
        for p in prompts:
            raw = p.encode("utf-8")
            if len(raw) > max_bytes:
                raw = raw[:keep_head] + raw[-keep_tail:]
            encoded.append(list(raw))
        longest = max(len(e) for e in encoded) + 1
        plen = min(1 << max(longest - 1, 31).bit_length(), cfg.max_prompt_len)
        batch = np.zeros((len(prompts), plen), dtype=np.int32)
        lens = np.zeros((len(prompts),), dtype=np.int32)
        for i, e in enumerate(encoded):
            batch[i, 0] = BOS
            batch[i, 1 : 1 + len(e)] = e
            lens[i] = 1 + len(e)
        return batch, lens, plen

    @staticmethod
    def _pad_batch(batch_tok: np.ndarray, lens: np.ndarray, temps: np.ndarray,
                   tops: np.ndarray):
        """Pad the batch to a power of two with BOS-only rows (temperature
        and top-p 1), as the JAX sampler does."""
        batch, plen = batch_tok.shape
        padded = 1 << max(batch - 1, 0).bit_length()
        if padded == batch:
            return batch_tok, lens, temps, tops
        pad = padded - batch
        batch_tok = np.concatenate([batch_tok, np.zeros((pad, plen), dtype=np.int32)], axis=0)
        batch_tok[batch:, 0] = BOS
        lens = np.concatenate([lens, np.ones((pad,), dtype=np.int32)])
        temps = np.concatenate([temps, np.ones((pad,), dtype=np.float32)])
        tops = np.concatenate([tops, np.ones((pad,), dtype=np.float32)])
        return batch_tok, lens, temps, tops

    @staticmethod
    def _decode(tokens: np.ndarray) -> str:
        raw = []
        for t in tokens:
            if t == EOS or t == 0:
                break
            if t < 256:
                raw.append(int(t))
        return bytes(raw).decode("utf-8", errors="replace").strip()

    # -- sampling ---------------------------------------------------------------

    @torch.no_grad()
    def _sample(self, batch_tok, lens, plen, temps, tops, max_tokens, seed, n_real):
        """The lockstep loop: (out [B, max_tokens], lp_sum, lp_min, n_gen)."""
        if plen + max_tokens - 1 > self.config.max_total_len:
            raise ValueError(
                f"prompt_len {plen} + max_tokens {max_tokens} exceeds "
                f"max_total_len {self.config.max_total_len} (positions/cache)")
        dev = self.device
        batch = batch_tok.shape[0]
        prompts = torch.from_numpy(batch_tok).long().to(dev)
        plens = torch.from_numpy(lens).long().to(dev)
        temps_t = torch.from_numpy(temps).to(dev)
        tops_t = torch.from_numpy(tops).to(dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        rows = torch.arange(batch, device=dev)
        out = torch.zeros((batch, max_tokens), dtype=torch.long, device=dev)
        lp_sum = torch.zeros((batch,), dtype=torch.float32, device=dev)
        lp_min = torch.full((batch,), float("inf"), dtype=torch.float32, device=dev)
        n_gen = torch.zeros((batch,), dtype=torch.long, device=dev)
        done = torch.zeros((batch,), dtype=torch.bool, device=dev)

        cache = self.model.init_cache(batch)
        # The positions every real row forces run as one prefill; the BOS-only
        # pad rows get prompt zeros there, and their outputs are dropped.
        first = int(lens[:n_real].min()) - 1
        if first > 0:
            self.model(prompts[:, :first], cache, logits=False)
        tok = prompts[:, first : first + 1]
        last = int(lens[:n_real].max()) + max_tokens - 1
        i = first - 1
        for i in range(first, last):
            logits = self.model(tok, cache)[:, -1]
            sampled = sample_top_p(logits, temps_t, tops_t, gen)
            in_prompt = (i + 1) < plens
            forced = prompts[:, min(i + 1, plen - 1)]
            col = i + 1 - plens
            active = ~in_prompt & ~done & (col < max_tokens)
            safe_col = col.clamp(0, max_tokens - 1)
            cur = out[rows, safe_col]
            out[rows, safe_col] = torch.where(active, sampled, cur)
            lp_tok = torch.log_softmax(logits, dim=-1)[rows, sampled]
            lp_sum += torch.where(active, lp_tok, torch.zeros_like(lp_tok))
            lp_min = torch.minimum(lp_min, torch.where(active, lp_tok, torch.full_like(lp_tok, float("inf"))))
            n_gen += active.long()
            done |= active & (sampled == EOS)
            tok = torch.where(in_prompt, forced, sampled)[:, None]
            if (i - first) % 8 == 7:
                pending = ~done[:n_real] & (i + 2 - plens[:n_real] < max_tokens)
                if not bool(pending.any()):
                    break
        self.last_stats = {"rows": batch, "prefill": max(first, 0), "steps": i + 1 - first,
                           "tokens": int(n_gen[:n_real].sum())}
        return out, lp_sum, lp_min, n_gen

    # -- Generator interface ----------------------------------------------------

    def generate_batch(
        self,
        prompts: Sequence[str],
        temperatures: Sequence[float],
        top_ps: Sequence[float],
        max_tokens: int = 100,
        seed: Optional[int] = None,
    ) -> List[str]:
        return self.generate_batch_scored(prompts, temperatures, top_ps, max_tokens, seed)[0]

    def generate_batch_scored(
        self,
        prompts: Sequence[str],
        temperatures: Sequence[float],
        top_ps: Sequence[float],
        max_tokens: int = 100,
        seed: Optional[int] = None,
    ):
        """(texts, mean_logprob [B], min_logprob [B]): the log-probabilities
        of the sampled tokens under the raw (T = 1) model over the generated
        span including EOS, 0.0 for an empty generation."""
        batch_tok, lens, plen = self._encode_prompts(prompts)
        batch = len(prompts)
        temps = np.asarray(temperatures, dtype=np.float32)
        tops = np.asarray(top_ps, dtype=np.float32)
        batch_tok, lens, temps, tops = self._pad_batch(batch_tok, lens, temps, tops)
        out, lp_sum, lp_min, n_gen = self._sample(
            batch_tok, lens, plen, temps, tops, max_tokens,
            seed if seed is not None else 0, batch)
        out = out[:batch].cpu().numpy()
        lp_sum = lp_sum[:batch].cpu().numpy()
        lp_min = lp_min[:batch].cpu().numpy()
        n_gen = n_gen[:batch].cpu().numpy()
        texts = [self._decode(out[i]) for i in range(batch)]
        has = n_gen > 0
        mean_lp = np.where(has, lp_sum / np.maximum(n_gen, 1), 0.0)
        min_lp = np.where(has, lp_min, 0.0)
        return texts, mean_lp.astype(np.float64), min_lp.astype(np.float64)

    def generate(
        self,
        prompt: str,
        temperature: float = 0.1,
        top_p: float = 0.9,
        max_tokens: int = 100,
        seed: Optional[int] = None,
    ) -> str:
        return self.generate_batch([prompt], [temperature], [top_p], max_tokens, seed)[0]
