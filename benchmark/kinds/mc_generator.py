"""The ``mc_generator`` kind: the port's DeepSeek-V2 generator answering
retrieved FiQA questions through MC confidence, and its judge.

A configuration of this kind holds the published model's keys at its top
level (``rag_uq_tpu_torch/llm/deepseek_v2.py::DeepseekV2Config`` takes them),
``dtype`` (the port's precision), ``weights`` (how the weights are drawn),
``retrieval`` (the name of the ``synthetic_hybrid`` configuration whose
deployment retrieves the contexts) and ``check`` (the judge's tolerances and
limits).

- ``make_inputs``: the retrieval deployment's inputs (``deploy.make_inputs``)
  and the reference's weight recipe: a seed per published tensor name and
  the normal's std. Not the weights: both sides draw them on the device.
- ``build``: imports the port's generator first, so that a checkout without
  it stops at once; then the retrieval deployment (``deploy.build``) and the
  generator, which draws every weight from the run's seed on the device.
- ``judge``: with the program's state freed, the plain reference
  (``reference/deepseek_v2.py``, driven a layer at a time by
  ``reference/deepseek_v2_blocks.py``) runs each judged row's prompt and
  generated ids in float32 and is held against the program's float32 logits
  at the prompt's last position and at every generated position:

  - ``logit_err``: the widest |program - reference| logit at a judged
    position, over that position's reference logit RMS;
  - ``lp_err``: the widest gap between the two log-probabilities of a
    sampled token;
  - ``route_mismatch_share``: the share of token-layer pairs, among those
    whose reference gate is not within ``tie_tol`` of a tie, whose expert
    set differs from the program's (where it is within, the reference is
    told the program's set);
  - ``attn_err``: the widest |program - reference| of a layer's attention
    output at a judged row's position (the prompt's, through the prefill;
    the generated inputs', through the absorbed decode), over that
    position's reference RMS. The reference's attention runs on the input
    the program's layer had, so the number sees the attention alone, which
    at random init adds too little to the residual stream for the logits
    to show a fault in it;
  - ``unanswered``: rows with no generated token, and questions without
    all their samples, over the window and the judged call.

With ``control``, the reference with weights and cached latents rounded
through float8 e4m3 (the precision below the configuration's bfloat16) is
put in the program's place on the same ids (its attention on the inputs the
program's layers had), and its numbers are returned as ``control.<name>``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from benchmark import deploy
from benchmark.reference import deepseek_v2 as ref
from benchmark.reference import deepseek_v2_blocks as blocks

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CONTROL_DTYPE = "float8_e4m3fn"


def _port():
    """The port's generator module; raises ImportError in a checkout without it."""
    from rag_uq_tpu_torch.llm import deepseek_v2

    return deepseek_v2


def retrieval_config(cfg: Dict) -> Dict:
    return json.loads((CONFIGS / f"{cfg['retrieval']}.json").read_text())


def make_inputs(cfg: Dict, seed: int, device: str) -> Dict:
    _port()
    ret = retrieval_config(cfg)
    inputs = deploy.make_inputs(ret, seed, device)
    inputs["retrieval_cfg"] = ret
    inputs["weights"] = {"std": float(cfg["weights"]["std"]),
                         "seeds": ref.tensor_seeds(cfg, seed)}
    return inputs


def build(cfg: Dict, inputs: Dict, seed: int, device: str):
    dsv2 = _port()
    dep = deploy.build(inputs["retrieval_cfg"], inputs, seed, device)
    config = dsv2.DeepseekV2Config.from_dict(
        {**cfg, "initializer_range": inputs["weights"]["std"]})
    dep.lm = dsv2.DeepseekV2LM(config, seed=seed, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return dep


def _widest(acc: float, x: torch.Tensor) -> float:
    """The larger of ``acc`` and the largest of ``x``, NaN read as infinite."""
    return max(acc, float(torch.nan_to_num(x, nan=float("inf")).max()))


def _rel(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per position, the widest |a - r| over r's RMS."""
    a, r = a.float(), r.float()
    return (a - r).abs().amax(-1) / r.pow(2).mean(-1).sqrt()


def compare(logits: List[torch.Tensor], routes: List[List[torch.Tensor]], reference: Dict,
            tokens: List[torch.Tensor], attn: List[List[torch.Tensor]]) -> Dict[str, float]:
    """The compared numbers of one side (``logits`` per row [n, vocab],
    ``routes`` per expert layer and row, ``attn`` per layer and row)
    against the reference's output."""
    logit_err, lp_err = 0.0, 0.0
    for a, r, tok in zip(logits, reference["logits"], tokens):
        logit_err = _widest(logit_err, _rel(a, r))
        idx = torch.arange(len(tok))
        lp_a = torch.log_softmax(a.float(), -1)[idx, tok]
        lp_r = torch.log_softmax(r.float(), -1)[idx, tok]
        lp_err = _widest(lp_err, (lp_a - lp_r).abs())
    attn_err = 0.0
    for mine, theirs in zip(attn, reference["attn"]):
        for a, r in zip(mine, theirs):
            attn_err = _widest(attn_err, _rel(a, r))
    clear, differ, pairs = 0, 0, 0
    for mine, theirs, amb in zip(routes, reference["routes"], reference["ambiguous"]):
        for m, t, a in zip(mine, theirs, amb):
            if m.shape != t.shape:  # another number of experts a token
                same = torch.zeros(len(a), dtype=torch.bool)
            else:
                same = (m.sort(-1).values == t.to(m).sort(-1).values).all(-1)
            clear += int((~a).sum())
            differ += int((~same & ~a).sum())
            pairs += len(a)
    return {"logit_err": logit_err, "lp_err": lp_err, "attn_err": attn_err,
            "route_mismatch_share": differ / clear if clear else 1.0,
            "ambiguous_share": 1.0 - clear / pairs if pairs else 0.0}


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
    k = cfg["num_experts_per_tok"]
    told = routes if all(t.shape[-1] == k for layer in routes for t in layer) else None
    variants = [None] + ([getattr(torch, CONTROL_DTYPE)] if control else [])
    w = inputs["weights"]
    outs = blocks.run(cfg, w["seeds"], w["std"], seqs, judged_from, told, chk["tie_tol"],
                      device, variants, storage=getattr(torch, cfg["dtype"]), attn_in=attn_in)
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
