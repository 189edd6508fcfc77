"""TinyLM training: the counterpart of ``rag_uq_tpu/llm/train.py``.

``TinyLMTrainer`` trains the decoder's full-sequence causal forward
(``DecoderModel`` without a cache, the parameter tree the sampler loads) on
next-byte cross-entropy, masked to the answer span for QA fine-tuning, with
optax's clip + AdamW under ``warmup_cosine_decay_schedule(0, lr, warmup,
max(total, 1))`` and the warmup clipped to ``total_steps - 1``
(``utils/optim.py``). The prompt and QA-row encoders
(``build_qa_prompt``, ``encode_qa_examples``, ``encode_corpus``) and
``LMTrainConfig`` are copies (numpy), held to the originals by
``tests/test_torch_train_lm.py``; ``fit`` and ``fit_qa`` draw their
batches from the same numpy generators as the JAX trainer. Random init
draws from a ``torch.Generator``, so a seed gives other initial weights
than JAX's.

Checkpoints are the JAX trainer's files: ``save_checkpoint`` writes the
parameter tree and a ``.json`` of configs, last losses and the step count;
``save_state`` writes the resumable ``{"params", "opt_state"}`` (optax's
``chain(clip, adamw(schedule))`` state) through a temporary file, with the
lifetime step counter in its ``.json``. Either package restores the
other's. The data-parallel step waits for the multi-device slice.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rag_uq_tpu_torch.convert import load_tiny_lm, tiny_lm_to_flax
from rag_uq_tpu_torch.core.device import DeviceLike, resolve_device
from rag_uq_tpu_torch.core.flax_nn import load_flax_tree
from rag_uq_tpu_torch.llm.tiny_lm import BOS, EOS, DecoderModel, TinyLM, TinyLMConfig
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint, save_flax_checkpoint
from rag_uq_tpu_torch.utils.optim import (
    ClipAdamW, load_schedule_opt_state, schedule_opt_state, warmup_cosine_decay_schedule,
)

logger = logging.getLogger(__name__)


# Instruction headers matching the three production prompt templates the
# sampler will see, so QA fine-tuning covers all of them:
# cli/evaluate.py::generate_answer (reference run_evaluation.py:67-92),
# uq/conformal.py::_build_prompt (reference confidence.py:378-403), and
# uq/mc.py::build_prompt (reference confidence.py:141-147).
QA_HEADERS = (
    "Answer the question based on the context. Be concise.\n\n",
    "Answer the following question based on the provided context.\n"
    "Be concise and precise.\n\n",
    "Answer the question.\n\n",
)


def build_qa_prompt(question: str, context: str, header: str) -> str:
    return f"{header}Context: {context}\n\nQuestion: {question}\n\nAnswer:"


def encode_qa_examples(
    samples: Sequence[Dict],
    seq_len: int,
    seed: int = 0,
    distractor_texts: Optional[Sequence[str]] = None,
    max_distractors: int = 2,
    min_distractors: int = 0,
    hard_distractors: Optional[Sequence[Sequence[str]]] = None,
    hard_fraction: float = 0.5,
    fit_budget: bool = False,
    gold_first_prob: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """QA fine-tuning rows: [n, seq_len+1] byte ids + [n, seq_len] loss mask.

    Each row is BOS + prompt + " answer" + EOS (0-padded); the mask covers
    only the answer+EOS target positions, so the loss teaches answering,
    not context modeling. With `distractor_texts`,
    min_distractors..max_distractors random passages are shuffled into the
    context around the gold one — matching the evaluation-time
    top-3-passage context distribution so the model learns to SELECT the
    relevant fact, not just copy the only passage.

    Round-3 curriculum knobs (VERDICT r2 next #4 — the eval-time failure
    mode is copying from the WRONG passage):
    - `hard_distractors[i]`: a per-sample pool of confusable passages
      (e.g. same-entity-kind articles, whose sentences share the gold's
      templates and differ only in names/values); each drawn distractor
      comes from it with probability `hard_fraction`. Retrieved passages
      at eval time are similar-looking by construction, so training on
      look-alikes is the distribution match random distractors miss.
    - `fit_budget=True`: add distractors only while the full prompt still
      fits `seq_len`, so the gold passage is never truncated away (a
      middle-trimmed gold makes the example unanswerable label noise).
    - `gold_first_prob`: after the shuffle, move the gold passage to the
      FRONT with this probability — the serving-time context is ordered by
      retrieval score, where the gold leads ~recall@1 of the time. A
      uniformly shuffled curriculum denies the model that position prior,
      which is the ONLY disambiguator on alias (semantic-slice) questions:
      the query entity name appears in no passage, so same-kind confusable
      distractors are content-indistinguishable from the gold (round-4
      extraction-gap decomposition). Keeping it < 1 preserves the
      content-based selection skill on the examples where content does
      disambiguate.
    """
    rng = np.random.default_rng(seed)
    rows: List[np.ndarray] = []
    masks: List[np.ndarray] = []
    for si, s in enumerate(samples):
        question = s["question"]
        answers = s.get("answers") or [s.get("answer", "")]
        answer = answers[0] if answers else ""
        gold_ctx = s.get("context", "") or ""
        if not question or not answer:
            continue
        parts = [gold_ctx]
        if distractor_texts or hard_distractors:
            hard_pool = (
                hard_distractors[si]
                if hard_distractors is not None and len(hard_distractors[si])
                else None
            )
            n_d = int(rng.integers(min_distractors, max_distractors + 1))
            budget = None
            if fit_budget:
                base = len(
                    build_qa_prompt(question, gold_ctx, QA_HEADERS[1]).encode()
                )
                budget = seq_len - len((" " + answer).encode()) - 2 - base
            for _ in range(n_d):
                if hard_pool is not None and rng.random() < hard_fraction:
                    pool = hard_pool
                elif distractor_texts:
                    pool = distractor_texts
                elif hard_pool is not None:
                    pool = hard_pool
                else:
                    break
                # Same-kind pools are built from ALL world articles, so the
                # gold itself is a member: reject it at draw time (a gold
                # duplicate is not a distractor — it makes the example
                # easier, the opposite of the curriculum's point).
                cand = None
                for _attempt in range(4):
                    c = pool[int(rng.integers(len(pool)))]
                    if c != gold_ctx:
                        cand = c
                        break
                if cand is None:
                    continue
                if budget is not None:
                    cost = len(cand.encode()) + 1
                    if cost > budget:
                        continue
                    budget -= cost
                parts.append(cand)
            rng.shuffle(parts)
            if gold_first_prob > 0.0 and rng.random() < gold_first_prob:
                parts.insert(0, parts.pop(parts.index(gold_ctx)))
        header = QA_HEADERS[int(rng.integers(len(QA_HEADERS)))]
        target = (" " + answer).encode("utf-8")
        prompt = build_qa_prompt(question, " ".join(parts), header)
        p_bytes = list(prompt.encode("utf-8"))
        # Budget: BOS + prompt + target + EOS must fit in seq_len + 1.
        room = seq_len - len(target) - 1
        if room <= 0:
            continue
        if len(p_bytes) > room:
            # Trim context bytes from the middle-left: keep the header's
            # start and the "...Question: ... Answer:" tail intact.
            keep_tail = min(len(p_bytes), room * 3 // 4)
            keep_head = room - keep_tail
            p_bytes = p_bytes[:keep_head] + p_bytes[-keep_tail:]
        row = np.zeros(seq_len + 1, dtype=np.int32)
        row[0] = BOS
        row[1 : 1 + len(p_bytes)] = p_bytes
        a_start = 1 + len(p_bytes)
        row[a_start : a_start + len(target)] = list(target)
        row[a_start + len(target)] = EOS
        mask = np.zeros(seq_len, dtype=np.float32)
        # Targets are row[1:]; answer bytes + EOS sit at target positions
        # [a_start - 1, a_start - 1 + len(target)].
        mask[a_start - 1 : a_start + len(target)] = 1.0
        rows.append(row)
        masks.append(mask)
    if not rows:
        return (np.zeros((0, seq_len + 1), np.int32),
                np.zeros((0, seq_len), np.float32))
    return np.stack(rows), np.stack(masks)


def encode_corpus(texts: Sequence[str], seq_len: int) -> np.ndarray:
    """Pack texts into [n, seq_len+1] BOS-prefixed byte windows (0-padded)."""
    rows: List[np.ndarray] = []
    for text in texts:
        data = list(text.encode("utf-8"))
        for start in range(0, max(len(data), 1), seq_len):
            window = data[start : start + seq_len]
            row = np.zeros(seq_len + 1, dtype=np.int32)
            row[0] = BOS
            row[1 : 1 + len(window)] = window
            if 1 + len(window) <= seq_len:
                row[1 + len(window)] = EOS
            rows.append(row)
    return np.stack(rows) if rows else np.zeros((0, seq_len + 1), np.int32)


@dataclass
class LMTrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    batch_size: int = 32
    seq_len: int = 128
    seed: int = 0


class TinyLMTrainer:
    """Next-byte LM trainer on ``device``."""

    def __init__(
        self,
        model_config: Optional[TinyLMConfig] = None,
        config: Optional[LMTrainConfig] = None,
        device: DeviceLike = "cuda",
    ):
        self.model_config = model_config or TinyLMConfig()
        self.config = config or LMTrainConfig()
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(self.config.seed)
        self.model = DecoderModel(self.model_config, gen).to(self.device)
        # The warmup is clipped so the cosine decay span stays positive
        # (optax rejects decay_steps=0; a 1-step fine-tune hits it).
        warmup = min(self.config.warmup_steps, max(self.config.total_steps - 1, 0))
        self.schedule = warmup_cosine_decay_schedule(
            0.0, self.config.learning_rate, warmup, max(self.config.total_steps, 1))
        self.optimizer = ClipAdamW(self.model.parameters(), self.schedule,
                                   self.config.weight_decay, self.config.grad_clip_norm)
        self.losses: List[float] = []
        # The lifetime step count; it survives restore_state, which keeps
        # only a 50-entry tail of the losses.
        self.step = 0

    def load_params(self, params) -> None:
        """Take a flax parameter tree (a warm start); the optimizer state
        and the schedule stay where they are."""
        load_flax_tree(self.model.flax_params(), params)

    def loss(self, batch: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Masked mean next-byte cross-entropy of batch [B, L+1] under mask [B, L]."""
        inputs, targets = batch[:, :-1], batch[:, 1:]
        logits = self.model(inputs)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long(),
                             reduction="none").reshape(targets.shape)
        return (ce * mask).sum() / mask.sum().clamp(min=1.0)

    def train_step(self, batch: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
        if mask is None:
            mask = (batch[:, 1:] != 0).astype(np.float32)
        loss = self.loss(torch.from_numpy(np.asarray(batch)).to(self.device),
                         torch.from_numpy(np.asarray(mask, dtype=np.float32)).to(self.device))
        loss.backward()
        self.optimizer.step()
        loss = loss.item()
        self.losses.append(loss)
        self.step += 1
        return loss

    def fit(self, texts: Sequence[str], steps: Optional[int] = None) -> List[float]:
        data = encode_corpus(texts, self.config.seq_len)
        rng = np.random.default_rng(self.config.seed)
        steps = steps or self.config.total_steps
        for _ in range(steps):
            idx = rng.integers(0, data.shape[0], size=self.config.batch_size)
            self.train_step(data[idx])
        return self.losses

    def fit_qa(
        self,
        samples: Sequence[Dict],
        steps: Optional[int] = None,
        seq_len: Optional[int] = None,
        distractor_texts: Optional[Sequence[str]] = None,
    ) -> List[float]:
        """Fine-tune on QA samples ({question, answers, context}) with the
        loss masked to the answer span (see encode_qa_examples)."""
        seq_len = seq_len or self.config.seq_len
        if seq_len > self.model_config.max_total_len:
            raise ValueError(
                f"seq_len {seq_len} exceeds position table "
                f"max_total_len {self.model_config.max_total_len}"
            )
        data, masks = encode_qa_examples(
            samples, seq_len, seed=self.config.seed, distractor_texts=distractor_texts,
        )
        if data.shape[0] == 0:
            raise ValueError("no usable QA samples (need question+answer)")
        rng = np.random.default_rng(self.config.seed)
        steps = steps or self.config.total_steps
        for _ in range(steps):
            idx = rng.integers(0, data.shape[0], size=self.config.batch_size)
            self.train_step(data[idx], masks[idx])
        return self.losses

    def export_sampler(self, seed: int = 0) -> TinyLM:
        """A sampling TinyLM on the trainer's device with the trained params."""
        lm = TinyLM(self.model_config, seed=seed, device=self.device)
        lm.model.load_state_dict(self.model.state_dict())
        return lm

    # -- checkpointing ---------------------------------------------------------------

    def params_tree(self) -> Dict:
        """The parameters as the JAX trainer's flax tree (numpy float32)."""
        return tiny_lm_to_flax(self)

    def opt_state_tree(self) -> Dict:
        return schedule_opt_state(self.optimizer, self.model.flax_params())

    def save_state(self, path: str) -> None:
        """Full resumable training state: params + opt_state + step count,
        written through a temporary file."""
        tmp = str(path) + ".tmp"
        save_flax_checkpoint(tmp, {"params": self.params_tree(), "opt_state": self.opt_state_tree()})
        os.replace(tmp, path)
        with open(str(path) + ".json", "w") as f:
            json.dump({
                "model_config": vars(self.model_config),
                "train_config": vars(self.config),
                "n_steps": self.step,
                "losses_tail": self.losses[-50:],
            }, f)

    def restore_state(self, path: str) -> int:
        """Restore params and opt_state saved by ``save_state`` (either
        package's); returns the step count to resume from (0 if there is no
        checkpoint)."""
        if not os.path.exists(path):
            return 0
        with open(str(path) + ".json") as f:
            meta = json.load(f)
        tree = load_flax_checkpoint(str(path))
        self.load_params(tree["params"])
        load_schedule_opt_state(self.optimizer, self.model.flax_params(), tree["opt_state"])
        self.losses = list(meta.get("losses_tail", []))
        self.step = int(meta["n_steps"])
        logger.info("Restored training state from %s at step %d", path, self.step)
        return self.step

    def save_checkpoint(self, path: str) -> None:
        """Trained params + model/train config (msgpack + json sidecar)."""
        save_flax_checkpoint(path, self.params_tree())
        meta = {
            "model_config": vars(self.model_config),
            "train_config": vars(self.config),
            "losses": self.losses[-20:],
            "n_steps": self.step,
        }
        with open(str(path) + ".json", "w") as f:
            json.dump(meta, f, indent=2)
        logger.info("Saved TinyLM checkpoint to %s", path)


def load_lm_checkpoint(path: str, seed: int = 0, device: DeviceLike = "cuda") -> TinyLM:
    """Rebuild a sampling TinyLM from a saved trainer checkpoint."""
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    lm = TinyLM(TinyLMConfig(**meta["model_config"]), seed=seed, device=device)
    load_tiny_lm(lm, load_flax_checkpoint(str(path)))
    logger.info("Loaded TinyLM checkpoint from %s", path)
    return lm
