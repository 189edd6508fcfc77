"""The plain Kimi Linear reference (``kimi_linear.py``) driven one layer at a
time, so that a float32 forward pass of the whole model fits on one card.

For each layer it draws that layer's tensors from their seeds, runs every
sequence through it (the KDA layers' recurrence over all sequences as one
padded batch), and frees them before the next; the embedding table and the
output head are drawn the same way, one at a time. Each ``variant`` is a
precision the weights, cached latents and KDA states are rounded through
(None: as stored), run side by side on the same layer's draw. The
arithmetic is the reference's own; this file only orders it. Plain
``torch``, float32, TF32 off; it imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import kimi_linear as ref


def run(cfg: Dict, seeds: Dict[str, int], std: float, bias_std: float,
        seqs: Sequence[torch.Tensor], judged_from: Sequence[int],
        told: Optional[List[List[torch.Tensor]]], tie_tol: float, device,
        variants: Sequence[Optional[torch.dtype]] = (None,),
        storage: torch.dtype = torch.bfloat16,
        attn_in: Optional[List[List[torch.Tensor]]] = None) -> List[Dict]:
    """Per variant: ``logits`` (per sequence, [L - judged_from, vocab] f32 on
    the host: the positions from ``judged_from`` on), and per expert layer and
    sequence the chosen experts (``routes``) and the ambiguous tokens
    (``ambiguous``). ``told[layer][seq]`` [L, k] is the program's expert set,
    used where the reference's choice is within ``tie_tol`` of a tie. The
    weights are drawn in ``storage``, the configuration's precision. With
    ``attn_in[layer][seq]`` [L, hidden] (a layer's normed input, given),
    ``attn`` holds per layer and sequence the layer's attention block over
    it, f32 on the host."""
    seqs = [s.to(device) for s in seqs]
    outer = ref.outer_shapes(cfg)
    name = "model.embed_tokens.weight"
    emb = ref.weights({name: outer[name]}, seeds, std, bias_std, device, storage)[name]
    xs = [[ref.lowered(emb, low)[s] for s in seqs] for low in variants]
    del emb
    out = [{"routes": [], "ambiguous": [], "attn": []} for _ in variants]
    moe_i = 0
    for i in range(cfg["num_hidden_layers"]):
        stored = ref.weights(ref.layer_shapes(cfg, i), seeds, std, bias_std, device, storage)
        moe = ref.is_moe(cfg, i)
        t = told[moe_i] if (moe and told is not None) else None
        for v, low in enumerate(variants):
            w = stored if low is None else {k: ref.lowered(x, low) for k, x in stored.items()}
            xs[v], routes, amb = ref.layer(w, i, xs[v], cfg, t, tie_tol, low)
            if moe:
                out[v]["routes"].append([r.cpu() for r in routes])
                out[v]["ambiguous"].append([a.cpu() for a in amb])
            if attn_in is not None:
                ins = [x.to(device).float() for x in attn_in[i]]
                out[v]["attn"].append([a.cpu() for a in ref.attention(w, i, ins, cfg, low)])
            del w
        moe_i += int(moe)
        del stored
    rest = ref.weights({k: outer[k] for k in ("model.norm.weight", "lm_head.weight")}, seeds,
                       std, bias_std, device, storage)
    for v, low in enumerate(variants):
        w = {k: ref.lowered(x, low) for k, x in rest.items()}
        out[v]["logits"] = [ref.head(w, x[f:], cfg).cpu() for x, f in zip(xs[v], judged_from)]
    return out
