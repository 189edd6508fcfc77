"""The port's router forward against the JAX router, with the parameters
carried across by ``convert.load_router``. Tolerance: gate weights and fused
scores within 1e-5 absolute (f32 MLP, sums in another order)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rag_uq_tpu.core.config import RouterConfig as JaxRouterConfig
from rag_uq_tpu.router.model import RetrievalRouter as JaxRouter
from rag_uq_tpu.router.model import fuse_hybrid as jax_fuse
from rag_uq_tpu_torch.convert import load_router
from rag_uq_tpu_torch.core.config import RouterConfig
from rag_uq_tpu_torch.router.model import RetrievalRouter, fuse_hybrid

CHECKPOINT = Path(__file__).resolve().parents[1] / "runs/demo_full/router/best_router.msgpack"


def _scores(seed, bsz=5, width=12):
    rng = np.random.default_rng(seed)
    bm25 = rng.uniform(0.0, 20.0, size=(bsz, width)).astype(np.float32)
    dense = rng.uniform(-0.3, 0.9, size=(bsz, width)).astype(np.float32)
    bm25[:, -3:] = 0.0  # dead union columns carry zeros
    dense[:, -3:] = 0.0
    bm25[0] = 0.0  # a query no BM25 term matched
    return bm25, dense


def _carry(ref: JaxRouter, cfg: RouterConfig) -> RetrievalRouter:
    ours = RetrievalRouter(cfg, device="cpu")
    params = jax.tree.map(np.asarray, ref.params)
    stats = jax.tree.map(np.asarray, ref.stats)
    return load_router(ours, params, stats)


def _check(ref: JaxRouter, ours: RetrievalRouter, seed: int):
    bm25, dense = _scores(seed)
    jw = np.asarray(ref.forward(jnp.asarray(bm25), jnp.asarray(dense)))
    tw = ours.forward(bm25, dense)
    np.testing.assert_allclose(tw.numpy(), jw, atol=1e-5, rtol=0)
    jf = np.asarray(jax_fuse(ref.config, jnp.asarray(jw), jnp.asarray(bm25), jnp.asarray(dense)))
    import torch

    tf = fuse_hybrid(ours.config, torch.from_numpy(jw), torch.from_numpy(bm25), torch.from_numpy(dense))
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-5, rtol=0)


@pytest.mark.parametrize("feature_set", ["reference3", "pool7"])
@pytest.mark.parametrize("gate_policy", ["soft", "binary"])
@pytest.mark.parametrize("fuse_norm", ["none", "maxnorm"])
@pytest.mark.parametrize("running_stats", [False, True])
def test_forward_matches_jax(feature_set, gate_policy, fuse_norm, running_stats):
    kw = dict(feature_set=feature_set, gate_policy=gate_policy, fuse_norm=fuse_norm)
    ref = JaxRouter(JaxRouterConfig(**kw), seed=3)
    if running_stats:
        ref.stats = {"bm25_mean": jnp.float32(0.4), "bm25_std": jnp.float32(0.3),
                     "dense_mean": jnp.float32(0.5), "dense_std": jnp.float32(0.2),
                     "initialized": jnp.float32(1.0)}
    _check(ref, _carry(ref, RouterConfig(**kw)), seed=7)


def test_recipe_v2_with_three_layers_matches_jax():
    from rag_uq_tpu.core.config import router_recipe_v2 as jax_recipe

    from rag_uq_tpu_torch.core.config import router_recipe_v2

    jcfg = dataclasses.replace(jax_recipe(), num_layers=3, hidden_dim=16)
    ref = JaxRouter(jcfg, seed=5)
    ours = _carry(ref, dataclasses.replace(router_recipe_v2(), num_layers=3, hidden_dim=16))
    _check(ref, ours, seed=8)


def test_in_repo_checkpoint_matches_jax():
    from rag_uq_tpu.router.train import RouterTrainer

    ref = JaxRouter()
    RouterTrainer(ref).load_checkpoint(str(CHECKPOINT))
    assert float(ref.stats["initialized"]) == 1.0  # trained EMA stats
    cfg = RouterConfig(**{f.name: getattr(ref.config, f.name)
                          for f in dataclasses.fields(JaxRouterConfig)})
    ours = _carry(ref, cfg)
    for seed in (1, 2):
        _check(ref, ours, seed)


def test_seeded_init_is_deterministic_and_on_device():
    a = RetrievalRouter(seed=4, device="cpu")
    b = RetrievalRouter(seed=4, device="cpu")
    bm25, dense = _scores(0)
    np.testing.assert_array_equal(a.forward(bm25, dense).numpy(), b.forward(bm25, dense).numpy())
    assert all(p.device.type == "cpu" for p in a.module.parameters())
