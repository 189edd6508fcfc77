"""The plain DeepSeek-V2 reference (``deepseek_v2.py``) driven one layer at a
time, so that a float32 forward pass of the whole model fits on one card.

For each layer it draws that layer's tensors from their seeds, runs every
sequence through it, and frees them before the next; the embedding table and
the output head are drawn the same way, one at a time. Each ``variant`` is a
precision the weights and cached latents are rounded through (None: as
stored), run side by side on the same layer's draw. The arithmetic is the
reference's own; this file only orders it. Plain ``torch``, float32, TF32
off; it imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import deepseek_v2 as ref


def run(cfg: Dict, seeds: Dict[str, int], std: float, seqs: Sequence[torch.Tensor],
        judged_from: Sequence[int], told: Optional[List[List[torch.Tensor]]], tie_tol: float,
        device, variants: Sequence[Optional[torch.dtype]] = (None,),
        storage: torch.dtype = torch.bfloat16,
        attn_in: Optional[List[List[torch.Tensor]]] = None) -> List[Dict]:
    """Per variant: ``logits`` (per sequence, [L - judged_from, vocab] f32 on
    the host: the positions from ``judged_from`` on), and per expert layer and
    sequence the chosen experts (``routes``) and the ambiguous tokens
    (``ambiguous``). ``told[layer][seq]`` [L, k] is the program's expert set,
    used where the reference's gate is within ``tie_tol`` of a tie. The
    weights are drawn in ``storage``, the configuration's precision. With
    ``attn_in[layer][seq]`` [L, hidden] (a layer's normed input, given),
    ``attn`` holds per layer and sequence the layer's attention over it, f32
    on the host."""
    n_layers = cfg["num_hidden_layers"]
    seqs = [s.to(device) for s in seqs]
    outer = ref.outer_shapes(cfg)
    emb = ref.weights({"model.embed_tokens.weight": outer["model.embed_tokens.weight"]},
                      seeds, std, device, storage)["model.embed_tokens.weight"]
    xs = [[ref.lowered(emb, low)[s] for s in seqs] for low in variants]
    del emb
    out = [{"routes": [], "ambiguous": [], "attn": []} for _ in variants]
    moe_i = 0
    for i in range(n_layers):
        stored = ref.weights(ref.layer_shapes(cfg, i), seeds, std, device, storage)
        moe = ref.is_moe(cfg, i)
        for v, low in enumerate(variants):
            w = stored if low is None else {k: ref.lowered(t, low) for k, t in stored.items()}
            routes, amb = [], []
            for j, x in enumerate(xs[v]):
                t = told[moe_i][j] if (moe and told is not None) else None
                xs[v][j], idx, a = ref.layer(w, i, x, cfg, t, tie_tol, low)
                if moe:
                    routes.append(idx.cpu())
                    amb.append(a.cpu())
            if moe:
                out[v]["routes"].append(routes)
                out[v]["ambiguous"].append(amb)
            if attn_in is not None:
                out[v]["attn"].append([
                    ref.attention(w, f"model.layers.{i}.self_attn.", x.to(device).float(), cfg,
                                  low).cpu() for x in attn_in[i]])
            del w
        moe_i += int(moe)
        del stored
    rest = ref.weights({k: outer[k] for k in ("model.norm.weight", "lm_head.weight")}, seeds,
                       std, device, storage)
    for v, low in enumerate(variants):
        w = {k: ref.lowered(t, low) for k, t in rest.items()}
        out[v]["logits"] = [ref.head(w, x[f:], cfg).cpu() for x, f in zip(xs[v], judged_from)]
    return out
