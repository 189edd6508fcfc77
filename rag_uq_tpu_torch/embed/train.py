"""Contrastive training for the TransformerEmbedder: the counterpart of
``rag_uq_tpu/embed/train.py``.

``ContrastiveTrainer`` is the JAX trainer's symmetric in-batch-negatives
InfoNCE: queries and passages go through one forward of the shared tower
(one ``[2B, L]`` batch), the ``[B, B]`` similarity logits are scaled by
1/temperature (20), and the loss is the mean of the query->passage and
passage->query cross-entropies. Updates are optax's clip + AdamW under
``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))``
(``utils/optim.py``), so the first step's learning rate is 0. ``fit``
draws batches as the JAX trainer does (a numpy generator seeded with the
config's seed, one pair per passage a batch), so both packages see the
same batches. ``EncoderTrainConfig``, ``synthesize_pairs`` and
``augment_registers`` are copies (numpy), held to the originals by
``tests/test_torch_train_encoder.py``. Random init draws from a
``torch.Generator``, so a seed gives other initial weights than JAX's.

A checkpoint is ``<path>`` (flax msgpack of ``{"params": ...}``) and
``<path>.json`` (encoder and train configs, the last losses, the step
count), the files the JAX trainer writes; either package loads the
other's. ``make_train_step(mesh)`` gives the data-parallel step: each rank
runs the tower on its slice of the pairs, the embeddings are all-gathered
with autograd for the global ``[B, B]`` logits (global negatives), and the
gradients are summed over the mesh before the clip and AdamW, so the update
is the single-device one.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F

from rag_uq_tpu_torch.convert import encoder_to_flax, load_encoder
from rag_uq_tpu_torch.core.device import DeviceLike
from rag_uq_tpu_torch.core.mesh import mesh_rank
from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder
from rag_uq_tpu_torch.text.tokenize import hash_texts, tokenize
from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint, save_flax_checkpoint
from rag_uq_tpu_torch.utils.optim import ClipAdamW, schedule_opt_state, warmup_cosine_decay_schedule

logger = logging.getLogger(__name__)


@dataclass
class EncoderTrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip_norm: float = 1.0
    warmup_steps: int = 50
    total_steps: int = 1000
    batch_size: int = 256
    temperature: float = 0.05  # InfoNCE logit scale (1/tau = 20)
    seed: int = 0


def synthesize_pairs(
    texts: Sequence[str],
    n_pairs: int,
    seed: int = 0,
    min_words: int = 2,
    max_words: int = 6,
    drop_prob: float = 0.2,
) -> Tuple[List[str], List[int]]:
    """Pseudo-queries from raw corpus text: a random word span of the source
    passage with random word dropout. Returns (queries, source indices)."""
    rng = np.random.default_rng(seed)
    queries: List[str] = []
    sources: List[int] = []
    n_texts = len(texts)
    while len(queries) < n_pairs:
        i = int(rng.integers(n_texts))
        words = tokenize(texts[i])
        if len(words) < min_words:
            continue
        span = int(rng.integers(min_words, max_words + 1))
        start = int(rng.integers(0, max(len(words) - span, 0) + 1))
        picked = [
            w for w in words[start : start + span] if rng.random() > drop_prob
        ]
        if not picked:
            picked = [words[start]]
        queries.append(" ".join(picked))
        sources.append(i)
    return queries, sources


# Function words dropped by the "clipped" register; the list matters only
# insofar as it removes template scaffolding, so a small closed set is enough.
_STOPWORDS = frozenset(
    "a an the is are was were be been do does did what which who whom whose "
    "when where why how of in on at by for with from to as that this those "
    "these it its their there here can could would should will shall may "
    "might must and or not no nor so if then than about into over under "
    "out up down off again once".split()
)


def augment_registers(
    queries: Sequence[str],
    seed: int = 0,
    variants_per_query: int = 2,
) -> Tuple[List[str], List[int]]:
    """Surface-register variants of training queries (VERDICT r4 next #4).

    The contrastive pool is synth_wiki template questions, so the encoder
    learns the templates' surface scaffolding along with the content words —
    measured as handwritten dense_only MRR 0.351 vs 0.725 synthetic (the
    reference avoids this by using a general pretrained encoder,
    reference rag_uq/streaming_index.py:276-279). These variants keep the
    content words and perturb exactly the scaffolding axis:

    - "clipped": stopwords removed (the search-query register),
    - "dropout": each word kept with p=0.85 (omission/typo robustness),
    - "shuffled": adjacent-pair swaps (passive/word-order robustness),
    - "keyword": the 3 longest words only (the tersest register).

    Returns (variant_texts, source_indices); pair each variant with its
    source query's positive passage and extend the fit() pool — the
    group-by-passage batch logic already prevents a variant and its source
    landing in one batch as mutual false negatives.
    """
    rng = np.random.default_rng(seed)
    kinds = ("clipped", "dropout", "shuffled", "keyword")
    out_q: List[str] = []
    out_src: List[int] = []
    for i, q in enumerate(queries):
        words = q.split()
        if len(words) < 3:
            continue
        picks = rng.choice(len(kinds), size=min(variants_per_query, len(kinds)),
                           replace=False)
        for k in picks:
            kind = kinds[int(k)]
            if kind == "clipped":
                kept = [w for w in words
                        if w.lower().strip("?.,!'\"") not in _STOPWORDS]
            elif kind == "dropout":
                kept = [w for w in words if rng.random() < 0.85]
            elif kind == "shuffled":
                kept = list(words)
                for j in range(0, len(kept) - 1, 2):
                    if rng.random() < 0.5:
                        kept[j], kept[j + 1] = kept[j + 1], kept[j]
            else:  # keyword
                kept = sorted(words, key=len, reverse=True)[:3]
            if len(kept) >= 2 and kept != words:
                out_q.append(" ".join(kept))
                out_src.append(i)
    return out_q, out_src


class ContrastiveTrainer:
    """Symmetric InfoNCE dual-encoder trainer (shared tower)."""

    def __init__(
        self,
        encoder: Optional[TransformerEmbedder] = None,
        config: Optional[EncoderTrainConfig] = None,
        encoder_config: Optional[EncoderConfig] = None,
        device: DeviceLike = "cuda",
    ):
        self.config = config or EncoderTrainConfig()
        self.encoder = encoder or TransformerEmbedder(
            encoder_config, seed=self.config.seed, device=device
        )
        self.device = self.encoder.device
        self.model = self.encoder.model
        self.schedule = warmup_cosine_decay_schedule(
            0.0, self.config.learning_rate, self.config.warmup_steps,
            max(self.config.total_steps, self.config.warmup_steps + 1),
        )
        self.optimizer = ClipAdamW(self.model.parameters(), self.schedule,
                                   self.config.weight_decay, self.config.grad_clip_norm)
        self.losses: List[float] = []

    def loss(self, q_ids, q_len, p_ids, p_len) -> torch.Tensor:
        """The symmetric InfoNCE loss of one batch of aligned pairs."""
        bsz = q_ids.shape[0]
        emb = self.model(torch.cat([q_ids, p_ids]), torch.cat([q_len, p_len]))  # [2B, D]
        logits = (emb[:bsz] @ emb[bsz:].T) * (1.0 / self.config.temperature)  # [B, B]
        labels = torch.arange(bsz, device=logits.device)
        return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0

    def train_step(self, q_ids, q_len, p_ids, p_len) -> float:
        dev = self.device
        batch = [torch.as_tensor(np.asarray(a)).to(dev) for a in (q_ids, q_len, p_ids, p_len)]
        loss = self.loss(*batch)
        loss.backward()
        self.optimizer.step()
        loss = loss.item()
        self.losses.append(loss)
        return loss

    def backward_on_mesh(self, q_ids, q_len, p_ids, p_len, mesh) -> float:
        """The global loss of one batch, its gradient left in every
        parameter's ``.grad`` on every rank, computed data-parallel.

        Each rank runs the tower on its ``B / S`` rows of the queries and of
        the passages; ``torch.distributed.nn``'s all-gather brings every
        rank's embeddings to every rank with autograd, and each rank takes
        only its own rows of the two cross-entropies over the global
        ``[B, B]`` logits (the negatives stay global). The all-gather's
        backward sums every rank's loss into each rank's slice, and summing
        the parameter gradients over the mesh then gives the gradient of
        the whole loss: no rank counts another's rows. B must divide by S.
        """
        n_ranks, r = mesh.size(), mesh_rank(mesh)
        bsz = len(q_ids)
        if bsz % n_ranks:
            raise ValueError(f"batch {bsz} does not divide into {n_ranks} ranks")
        per = bsz // n_ranks
        rows = slice(r * per, (r + 1) * per)
        local = [torch.as_tensor(np.asarray(a)[rows]).to(self.device)
                 for a in (q_ids, q_len, p_ids, p_len)]
        emb = self.model(torch.cat([local[0], local[2]]), torch.cat([local[1], local[3]]))
        group = mesh.get_group()
        q_all = torch.cat(dist_nn.all_gather(emb[:per].contiguous(), group=group))  # [B, D]
        p_all = torch.cat(dist_nn.all_gather(emb[per:].contiguous(), group=group))
        inv_tau = 1.0 / self.config.temperature
        labels = torch.arange(r * per, (r + 1) * per, device=emb.device)
        l_qp = F.cross_entropy((emb[:per] @ p_all.T) * inv_tau, labels, reduction="sum")
        l_pq = F.cross_entropy((emb[per:] @ q_all.T) * inv_tau, labels, reduction="sum")
        loss = (l_qp + l_pq) / (2.0 * bsz)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.optimizer.params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        for p, g in zip(self.optimizer.params, flat.split([g.numel() for g in grads])):
            p.grad = g.view_as(p)
        total = loss.detach().reshape(1)
        dist.all_reduce(total, group=group)
        return float(total.item())

    def make_train_step(self, mesh=None) -> Callable:
        """The train step ``(q_ids, q_len, p_ids, p_len) -> loss``: the
        single-device ``train_step``, or with ``mesh`` the data-parallel step
        (``backward_on_mesh``, then the clip and AdamW on every rank alike,
        so the replicated parameters stay equal)."""
        if mesh is None:
            return self.train_step

        def step(q_ids, q_len, p_ids, p_len) -> float:
            loss = self.backward_on_mesh(q_ids, q_len, p_ids, p_len, mesh)
            self.optimizer.step()
            self.losses.append(loss)
            return loss

        return step

    # -- data + loop ---------------------------------------------------------------

    def encode_pairs(
        self, queries: Sequence[str], passages: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        cfg = self.encoder.config
        q_ids, q_len = hash_texts(queries, cfg.vocab_buckets, cfg.max_seq_len)
        p_ids, p_len = hash_texts(passages, cfg.vocab_buckets, cfg.max_seq_len)
        return q_ids, q_len, p_ids, p_len

    def fit(
        self,
        queries: Sequence[str],
        passages: Sequence[str],
        steps: Optional[int] = None,
        log_every: int = 50,
        on_step: Optional[Callable[[int, float], None]] = None,
    ) -> List[float]:
        """Train on aligned (query, positive passage) pairs.

        Each step samples batch_size pairs without replacement within an
        epoch-style shuffled order; in-batch others are the negatives. A
        batch takes one pair per passage (first come, first served), since
        duplicate positives would be false negatives for InfoNCE.
        """
        if not queries or len(queries) != len(passages):
            raise ValueError(f"{len(queries)} queries for {len(passages)} passages")
        q_ids, q_len, p_ids, p_len = self.encode_pairs(queries, passages)
        steps = steps or self.config.total_steps
        bsz = min(self.config.batch_size, len(queries))
        rng = np.random.default_rng(self.config.seed)

        p_key: dict = {}
        group_of = np.zeros(len(passages), dtype=np.int64)
        for i, p in enumerate(passages):
            group_of[i] = p_key.setdefault(p, len(p_key))

        order = rng.permutation(len(queries))
        cursor = 0
        for s in range(steps):
            picked: List[int] = []
            seen_groups: set = set()
            attempts = 0
            while len(picked) < bsz and attempts < 4 * bsz:
                if cursor >= len(order):
                    order = rng.permutation(len(queries))
                    cursor = 0
                i = int(order[cursor])
                cursor += 1
                attempts += 1
                g = int(group_of[i])
                if g in seen_groups:
                    continue
                seen_groups.add(g)
                picked.append(i)
            idx = np.asarray(picked, dtype=np.int64)
            loss = self.train_step(q_ids[idx], q_len[idx], p_ids[idx], p_len[idx])
            if on_step is not None:
                on_step(s, loss)
            if log_every and (s + 1) % log_every == 0:
                logger.info("step %d/%d loss %.4f", s + 1, steps, loss)
        return self.losses

    # -- export / checkpointing --------------------------------------------------

    def export_embedder(self) -> TransformerEmbedder:
        """The encoder with the trained parameters (its layers refresh their
        compute-dtype copies when they next run without autograd)."""
        return self.encoder

    def opt_state_tree(self) -> dict:
        """optax's state of ``chain(clip, adamw(schedule))`` over the
        ``{"params": ...}`` tree."""
        return schedule_opt_state(self.optimizer, self.model.flax_params(), ("params",))

    def save_checkpoint(self, path: str) -> None:
        """Trained params + encoder/train config (msgpack + json sidecar)."""
        save_flax_checkpoint(path, encoder_to_flax(self.encoder))
        meta = {
            "encoder_config": vars(self.encoder.config),
            "train_config": vars(self.config),
            "losses": self.losses[-20:],
            "n_steps": len(self.losses),
        }
        with open(str(path) + ".json", "w") as f:
            json.dump(meta, f, indent=2)
        logger.info("Saved encoder checkpoint to %s", path)


def load_encoder_checkpoint(path: str, device: DeviceLike = "cuda") -> TransformerEmbedder:
    """Rebuild a TransformerEmbedder from a saved checkpoint."""
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    embedder = TransformerEmbedder(EncoderConfig(**meta["encoder_config"]), device=device)
    load_encoder(embedder, load_flax_checkpoint(str(path)))
    logger.info("Loaded encoder checkpoint from %s", path)
    return embedder
