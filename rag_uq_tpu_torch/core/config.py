"""Configuration dataclasses: copies of ``rag_uq_tpu/core/config.py``.

The names, fields and defaults are those of the JAX package, so a
configuration means the same thing to both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class RouterConfig:
    """Router MLP architecture (reference: rag_uq/router.py:34-41)."""

    hidden_dim: int = 64
    dropout: float = 0.1
    temperature: float = 1.0  # for ApproxNDCG
    num_layers: int = 2
    use_batch_norm: bool = False
    ema_momentum: float = 0.1  # running score-stats EMA (reference router.py:123)
    # "reference3": the reference's per-passage features [bm25_norm,
    # dense_norm, dense_norm - bm25_norm] (router.py:67-68,164-167).
    # "pool7": adds within-pool z-scores per passage and each tower's
    # broadcast top1-top2 gap — scale-invariant pool-context signals a pure
    # per-passage gate cannot express (router/model.py docstring; added
    # after the hand-written out-of-family eval measured the reference3
    # gate misrouting rare-term "needle" queries to dense).
    feature_set: str = "reference3"
    # Tower-score normalization applied before the gate AND the hybrid fuse.
    # "none" is the reference's behavior (router.py:179-202 fuses RAW
    # scores) — measured to be a train/deploy trap: raw BM25 is O(10-30) vs
    # dense cosine O(1), so w*dense+(1-w)*bm25 is ranking-dominated by BM25
    # except at w≈1, and the per-passage gate can invert pool rankings
    # arbitrarily (r5 probe: deployed MRR 0.755 vs best fixed 0.822,
    # capture -0.89). "maxnorm" divides each tower by its per-query pool
    # max, making w=0/w=1 exactly recover the pure tower rankings
    # (same probe: MRR 0.866, capture +0.48).
    fuse_norm: str = "none"
    # How deployment turns gate weights into a ranking. "soft" is the
    # reference fuse w*dense+(1-w)*bm25; "binary" takes the per-query mean
    # gate as a routing DECISION and serves the pure better-arm ranking —
    # the r5 probe measured binary above soft on every family once towers
    # oppose (capture +0.74 vs +0.48 with the decision loss below).
    # Training always uses the soft fuse (differentiable).
    gate_policy: str = "soft"
    # Weight of an auxiliary per-query BCE on mean(gate) toward the
    # label-derived better arm (ties excluded). 0 = reference parity
    # (pure ApproxNDCG). 2.0 measured best on the balanced fit pool.
    decision_loss_weight: float = 0.0


def router_recipe_v2() -> "RouterConfig":
    """The TPU-first router training recipe (round 5): pool-context
    features, max-norm fuse, binary deployment, auxiliary decision loss,
    sharp ApproxNDCG temperature for [0,1]-scale normalized scores.

    Measured on the r4-pipeline synthetic test window (n=1000, balanced fit
    pool): MRR 0.887 vs best fixed arm 0.827 / oracle 0.908 — capture +0.74
    of the oracle's headroom, where the reference recipe measures -0.89
    (runs/demo_full_r4/results/router_balanced_probe.json and the r5
    recipe probe)."""
    return RouterConfig(
        feature_set="pool7",
        temperature=0.1,
        fuse_norm="maxnorm",
        gate_policy="binary",
        decision_loss_weight=2.0,
    )


@dataclass
class ChunkConfig:
    """Corpus chunking (reference: prepare_corpus.py:28-34)."""

    chunk_size: int = 200  # words
    overlap: int = 50  # words
    min_chunk_size: int = 50  # CHARACTERS (reference min_chunk_length)
    max_chunk_chars: int = 2000  # characters


@dataclass
class TrainConfig:
    """Router training loop (reference: router.py:346-365,419-426)."""

    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    num_epochs: int = 50
    batch_size: int = 16
    early_stopping_patience: int = 10
    grad_clip_norm: float = 1.0
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    checkpoint_dir: str = "models/router"
    seed: int = 0


@dataclass
class BM25Config:
    """Okapi BM25 parameters (reference: streaming_index.py:100-105)."""

    k1: float = 1.5
    b: float = 0.75
    # rank_bm25.BM25Okapi floors non-positive idf at epsilon * average_idf.
    idf_epsilon: float = 0.25
    # Device index capacities (static shapes; grown by watermark doubling).
    initial_doc_capacity: int = 4096
    initial_postings_capacity: int = 262_144
    initial_vocab_capacity: int = 65_536
    max_query_terms: int = 32
    # Two-tier scoring split: terms with df > threshold become rows of a
    # dense [T, N] per-doc impact matrix (scored by one MXU matmul for all
    # docs); terms with df <= threshold are scored from posting slices of
    # length `threshold` (fully covered => exact).
    dense_tier_threshold: int = 64
    # Upper bound on dense-tier rows: the impact matrix is [T, Ncap], so T is
    # capped and the threshold raised (beam widened) when more terms exceed
    # it — keeps memory bounded at any corpus size while staying exact.
    max_dense_tier_rows: int = 8192
    # Hard byte budget for the impact matrix; rows are reduced further when
    # rows * doc_capacity * itemsize would exceed it (keeps huge corpora
    # buildable on one chip; sharded deployments split the budget per shard).
    impact_budget_bytes: int = 2 << 30
    impact_dtype: str = "bfloat16"  # dense-tier impact matrix storage
    # Byte budget for the padded low-tier posting-block table
    # [n_low_terms, 2, beam] (built at sync when it fits): turns the low
    # tier's per-(query,term) dynamic_slice fetches — measured 25 ms/batch
    # at bench shape, the platform's ~1us scattered-fetch floor — into one
    # row gather. Beyond the budget (wide-beam budget-capped corpora) the
    # packed-slice layout is used instead.
    low_block_budget_bytes: int = 256 << 20
    # Approx-path low-tier candidate-pool truncation (ops/bm25.topk_twotier):
    # before the dense-tier gather, keep only the `lsel` largest low-tier
    # segment sums per query. Only applies together with approx top-k (the
    # exact path ignores it); 0 disables truncation even under approx.
    lsel: int = 4096
    # Main+delta incremental sync for live ingest: when > 0 and the docs
    # added since the last full sync stay under this fraction of the base,
    # only a small delta CSR is (re)built and uploaded — the base device
    # state (incl. the impact matrix) is reused with its idf/avgdl FROZEN
    # (bounded staleness; a full sync runs once the fraction is exceeded,
    # and exact-mode searches always force one). 0 disables (every dirty
    # search does a full sync).
    delta_sync_fraction: float = 0.0
    # A persisted index whose saved tokenizer version differs from the
    # current one is a correctness problem (queries tokenize differently
    # from the stored vocabulary and recall silently degrades), so loading
    # one RAISES by default; set True to downgrade to a warning (advisor
    # r4: the warning-only guard was missable).
    allow_tokenizer_mismatch: bool = False


@dataclass
class DenseIndexConfig:
    """Dense index over an HBM-resident embedding matrix."""

    embedding_dim: int = 768  # nomic-embed-text dim (reference wiki)
    initial_capacity: int = 4096
    dtype: str = "bfloat16"  # storage dtype for the corpus matrix
    score_block: int = 8192  # corpus rows scored per streaming chunk
    normalize: bool = True  # store L2-normalized rows => cosine via matmul
    # Same strict tokenizer-version guard as BM25Config (advisor r4).
    allow_tokenizer_mismatch: bool = False


@dataclass
class EmbedderConfig:
    """In-framework embedding configuration."""

    kind: str = "ngram_hash"  # "ngram_hash" | "sha256" | "encoder"
    dim: int = 768
    seed: int = 0
    vocab_hash_buckets: int = 1 << 18
    # encoder settings (flax transformer), used when kind == "encoder"
    encoder_layers: int = 4
    encoder_heads: int = 12
    encoder_mlp_dim: int = 1536
    max_seq_len: int = 128
    # Path to a trained encoder checkpoint (cli/train_encoder.py output);
    # when set with kind == "encoder", the checkpoint's own architecture
    # config wins over the fields above.
    checkpoint_path: Optional[str] = None


@dataclass
class UQConfig:
    """Uncertainty quantification (reference: confidence.py:101-114,302-307)."""

    n_samples: int = 10
    temperature_range: Tuple[float, float] = (0.5, 1.2)
    top_p_range: Tuple[float, float] = (0.8, 0.95)
    max_tokens: int = 100
    alpha: float = 0.1  # conformal miscoverage
    calibration_db_path: str = "data/calibration_scores.db"
    # Conformal nonconformity score function: "length_ratio" keeps the
    # reference's heuristic (calibrate on 1-ROUGE, estimate at inference
    # from the answer/context length ratio — confidence.py:533-539);
    # "mc_variance" uses the MC-sampling disagreement as the SAME score at
    # calibration and inference (exchangeable => the coverage guarantee
    # actually holds; see uq/conformal.py).
    nonconformity: str = "length_ratio"


@dataclass
class EvalConfig:
    """Evaluation protocol (reference: eval_protocol.py:149-166)."""

    output_dir: str = "results"
    n_bins: int = 10
    bootstrap_samples: int = 1000


@dataclass
class MeshConfig:
    """Device mesh layout for multi-chip corpus sharding."""

    corpus_axis: str = "corpus"
    data_axis: str = "data"
    num_corpus_shards: int = 1
    num_data_shards: int = 1


@dataclass
class Config:
    """Root config."""

    router: RouterConfig = field(default_factory=RouterConfig)
    bm25: BM25Config = field(default_factory=BM25Config)
    dense: DenseIndexConfig = field(default_factory=DenseIndexConfig)
    embedder: EmbedderConfig = field(default_factory=EmbedderConfig)
    uq: UQConfig = field(default_factory=UQConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    chunk: ChunkConfig = field(default_factory=ChunkConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def override(self, dotted: Dict[str, Any]) -> "Config":
        """Return a copy with `{"section.key": value}` overrides applied."""
        cfg = dataclasses.replace(self)
        for path, value in dotted.items():
            section, _, key = path.partition(".")
            if not key:
                raise KeyError(f"Override path must be 'section.key', got {path!r}")
            sub = getattr(cfg, section)
            if not hasattr(sub, key):
                raise KeyError(f"Unknown config key {path!r}")
            setattr(cfg, section, dataclasses.replace(sub, **{key: value}))
        return cfg
