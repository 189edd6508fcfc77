"""optax's clip + AdamW and learning-rate schedules on torch parameters.

The JAX trainers update with ``optax.chain(clip_by_global_norm(c),
adamw(lr, weight_decay=wd))``. Term for term:

- ``clip_by_global_norm`` scales every gradient by ``c / g_norm`` only when
  the global norm ``g_norm`` reaches ``c``, as ``(g / g_norm) * c``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``g_norm + 1e-6`` and so
  scales every step);
- ``adamw`` (b1 0.9, b2 0.999, eps 1e-8 added outside the square root after
  bias correction) decays every leaf, biases, LayerNorm scales and
  embeddings included: ``torch.optim.AdamW`` over one parameter group does
  the same arithmetic, with ``exp_avg``, ``exp_avg_sq`` and ``step`` for
  optax's ``mu``, ``nu`` and ``count``;
- a schedule is read at the count *before* the update, so a warmup from 0
  makes the first step's learning rate 0.

The schedules return float32 values computed as optax computes them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from rag_uq_tpu_torch.core.flax_nn import FlaxLeaf, flax_tree, load_flax_tree

Schedule = Callable[[int], float]
B1, B2, EPS = 0.9, 0.999, 1e-8


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` (constant ``init_value`` for no steps)."""
    if transition_steps <= 0:
        return lambda count: float(np.float32(init_value))

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c / np.float32(decay_steps)))
        decayed = np.float32(1 - alpha) * cosine + np.float32(alpha)
        return float(np.float32(init_value) * decayed)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value`` at
    ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warmup(count) if count < warmup_steps else cosine(count - warmup_steps)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place, without a host sync; returns
    the global norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(list(grads), torch.where(keep, one, norm))
    torch._foreach_mul_(list(grads), torch.where(keep, one, one * max_norm))
    return norm


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(learning_rate,
    weight_decay))`` over ``params``; ``learning_rate`` is a number (set it
    anew through ``lr``, as ``inject_hyperparams`` does) or a schedule of
    the step count."""

    def __init__(self, params: Iterable[nn.Parameter],
                 learning_rate: Union[float, Schedule], weight_decay: float, max_norm: float):
        self.params: List[nn.Parameter] = list(params)
        self.schedule: Optional[Schedule] = learning_rate if callable(learning_rate) else None
        self.lr = 0.0 if self.schedule else float(learning_rate)
        self.max_norm = max_norm
        self.count = 0  # updates applied (optax's count)
        self.opt = torch.optim.AdamW(self.params, lr=self.lr, betas=(B1, B2), eps=EPS,
                                     weight_decay=weight_decay)

    def step(self) -> torch.Tensor:
        """Clip the gradients, apply one update and clear them; returns the
        global gradient norm before clipping (a device scalar)."""
        for p in self.params:
            if p.grad is None:  # optax updates every leaf, with a zero gradient here
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params], self.max_norm)
        lr = self.schedule(self.count) if self.schedule else self.lr
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1
        return norm

    # -- optax's state as a flax tree -------------------------------------------

    def adam_state(self, leaves: Sequence[FlaxLeaf], root: Sequence[str] = ()) -> Dict:
        """``ScaleByAdamState`` as flax writes it: ``{count, mu, nu}`` with the
        moments in the parameters' flax layout under ``root``."""
        def moment(name):
            tree = flax_tree(leaves, lambda p: self.opt.state[p][name] if self.opt.state.get(p)
                             else torch.zeros_like(p))
            for key in reversed(root):
                tree = {key: tree}
            return tree

        return {"count": np.asarray(self.count, np.int32), "mu": moment("exp_avg"),
                "nu": moment("exp_avg_sq")}

    def load_adam_state(self, leaves: Sequence[FlaxLeaf], state: Dict,
                        root: Sequence[str] = ()) -> None:
        """Restore ``{count, mu, nu}`` written by ``adam_state`` or by optax."""
        self.count = int(np.asarray(state["count"]))
        step_dtype = torch.get_default_dtype()
        for p in self.params:
            self.opt.state[p] = {"step": torch.tensor(float(self.count), dtype=step_dtype),
                                 "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                                 "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        for name, key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            tree = state[key]
            for k in root:
                tree = tree[k]
            load_flax_tree(leaves, tree, lambda p: self.opt.state[p][name])


def schedule_opt_state(optimizer: ClipAdamW, leaves: Sequence[FlaxLeaf],
                       root: Sequence[str] = ()) -> Dict:
    """The state of optax's ``chain(clip_by_global_norm, adamw(schedule))``
    as flax writes it: ``{"0": {}, "1": {"0": {count, mu, nu}, "1": {},
    "2": {count}}}``."""
    count = np.asarray(optimizer.count, np.int32)
    return {"0": {}, "1": {"0": optimizer.adam_state(leaves, root), "1": {}, "2": {"count": count}}}


def load_schedule_opt_state(optimizer: ClipAdamW, leaves: Sequence[FlaxLeaf], state: Dict,
                            root: Sequence[str] = ()) -> None:
    """The inverse of ``schedule_opt_state``."""
    optimizer.load_adam_state(leaves, state["1"]["0"], root)
    optimizer.count = int(np.asarray(state["1"]["2"]["count"]))
