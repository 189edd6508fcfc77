"""The ``kimi_linear_generator`` kind: the port's Kimi Linear generator
answering retrieved FiQA questions through MC confidence, and its judge.

A configuration of this kind holds the published model's keys at its top
level (``rag_uq_tpu_torch/llm/kimi_linear.py::KimiLinearConfig`` takes
them), ``expert_parallel`` (the expert share this chip holds),
``dtype``, ``weights`` (the normal's std and the router bias's),
``retrieval`` (the ``synthetic_hybrid`` configuration whose deployment
retrieves the contexts) and ``check`` (the judge's tolerance and limits).

- ``make_inputs``: imports the port's generator first, so that a checkout
  without it stops at once; then the retrieval deployment's inputs and the
  reference's weight recipe (a seed per published tensor name, the stds).
- ``build``: the retrieval deployment and the generator, which draws every
  weight from the run's seed on the device.
- ``judge``: ``mc_generator``'s comparison (``compare``), against the plain
  reference (``reference/kimi_linear.py``, driven a layer at a time by
  ``reference/kimi_linear_blocks.py``) run in float32 on each judged row's
  prompt and generated ids: ``logit_err``, ``lp_err``,
  ``route_mismatch_share`` (the reference told the program's expert set
  where its k-th and (k+1)-th choice values, score + bias, lie within
  ``tie_tol``), ``attn_err`` (every layer's attention block, KDA and MLA,
  at every judged position of the prefill and the decode, the reference run
  on the program's layer input) and ``unanswered``.

With ``control``, the reference with weights, cached latents and KDA
states rounded through float8 e4m3 (the precision below the
configuration's bfloat16) is put in the program's place on the same ids,
and its numbers are returned as ``control.<name>``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import torch

from benchmark import deploy
from benchmark.kinds.mc_generator import CONTROL_DTYPE, compare
from benchmark.reference import kimi_linear as ref
from benchmark.reference import kimi_linear_blocks as blocks

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _port():
    """The port's generator module; raises ImportError in a checkout without it."""
    from rag_uq_tpu_torch.llm import kimi_linear

    return kimi_linear


def make_inputs(cfg: Dict, seed: int, device: str) -> Dict:
    _port()
    ret = json.loads((CONFIGS / f"{cfg['retrieval']}.json").read_text())
    inputs = deploy.make_inputs(ret, seed, device)
    inputs["retrieval_cfg"] = ret
    w = cfg["weights"]
    inputs["weights"] = {"std": float(w["std"]), "router_bias_std": float(w["router_bias_std"]),
                         "seeds": ref.tensor_seeds(cfg, seed)}
    return inputs


def build(cfg: Dict, inputs: Dict, seed: int, device: str):
    kimi = _port()
    dep = deploy.build(inputs["retrieval_cfg"], inputs, seed, device)
    w = inputs["weights"]
    config = kimi.KimiLinearConfig.from_dict(
        {**cfg, "initializer_range": w["std"], "router_bias_std": w["router_bias_std"]})
    dep.lm = kimi.KimiLinearLM(config, seed=seed, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return dep


def judge(cfg: Dict, inputs: Dict, judged: Dict, device: str,
          control: bool) -> Tuple[Dict, Dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chk = cfg["check"]
    rows = judged["rows"]
    seqs = [torch.tensor(r["prompt"] + r["generated"][:-1], dtype=torch.long) for r in rows]
    judged_from = [len(r["prompt"]) - 1 for r in rows]
    tokens = [torch.tensor(r["generated"], dtype=torch.long) for r in rows]
    n_moe = len(rows[0]["routes"]) if rows else 0
    routes = [[r["routes"][m] for r in rows] for m in range(n_moe)]
    n_layers = cfg["num_hidden_layers"]
    attn_in = [[r["attn_in"][i] for r in rows] for i in range(n_layers)]
    attn_out = [[r["attn_out"][i] for r in rows] for i in range(n_layers)]
    # The reference is told the program's sets only where they are sets of k.
    k = cfg["num_experts_per_token"]
    told = routes if all(t.shape[-1] == k for layer in routes for t in layer) else None
    variants = [None] + ([getattr(torch, CONTROL_DTYPE)] if control else [])
    w = inputs["weights"]
    outs = blocks.run(cfg, w["seeds"], w["std"], w["router_bias_std"], seqs, judged_from, told,
                      chk["tie_tol"], device, variants, storage=getattr(torch, cfg["dtype"]),
                      attn_in=attn_in)
    numbers = compare([r["logits"] for r in rows], routes, outs[0], tokens, attn_out)
    numbers["unanswered"] = float(judged["unanswered"])
    extra = {"judged_rows": len(rows), "judged_positions": sum(len(t) for t in tokens),
             "ambiguous_share": numbers.pop("ambiguous_share")}
    if control:
        low = outs[1]
        for name, value in compare(low["logits"], low["routes"], outs[0], tokens,
                                   low["attn"]).items():
            extra[f"control.{name}"] = value
    limits = chk["limits"]
    checks = {name: {"value": float(v), "limit": float(limits[name])}
              for name, v in numbers.items() if name in limits}
    extra.update({name: v for name, v in numbers.items() if name not in limits})
    return checks, extra
