"""The port's router training against the JAX package's, on the CPU.

The same numpy inputs go through both packages, the JAX router's initial
parameters carried across with ``convert.load_router``, at ``dropout = 0``
(dropout masks come from ``jax.random`` on one side and a
``torch.Generator`` on the other). Tolerances: ApproxNDCG and its gradient
1e-6; the first step's gradients 1e-5 of the global gradient norm; every
step's loss 1e-4 (measured: below 1e-6); the EMA statistics 1e-6; the
plateau rule at the same epochs. Checkpoints cross bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_uq_tpu.cli import train_router as jax_cli
from rag_uq_tpu.core.config import RouterConfig as JaxRouterConfig
from rag_uq_tpu.core.config import TrainConfig as JaxTrainConfig
from rag_uq_tpu.data.loaders import synthetic_router_data
from rag_uq_tpu.router.loss import approx_ndcg_loss as jax_loss
from rag_uq_tpu.router.model import RetrievalRouter as JaxRouter
from rag_uq_tpu.router.model import normalize_towers as jax_normalize
from rag_uq_tpu.router.train import RouterTrainer as JaxTrainer
from rag_uq_tpu_torch.cli import train_router as port_cli
from rag_uq_tpu_torch.convert import load_router, router_to_flax
from rag_uq_tpu_torch.core.config import RouterConfig, TrainConfig
from rag_uq_tpu_torch.core.flax_nn import flax_tree
from rag_uq_tpu_torch.router.loss import ApproxNDCGLoss, approx_ndcg_loss
from rag_uq_tpu_torch.router.model import RetrievalRouter, dropout
from rag_uq_tpu_torch.router.train import RouterTrainer, load_router_checkpoint

CONFIGS = {
    "reference3": dict(dropout=0.0),
    "pool7_recipe": dict(dropout=0.0, feature_set="pool7", fuse_norm="maxnorm",
                         gate_policy="binary", decision_loss_weight=2.0, temperature=0.1),
    "batch_norm": dict(dropout=0.0, use_batch_norm=True, num_layers=3, hidden_dim=16),
}


def _pair(router_cfg, tmp_path, **train):
    jr = JaxRouter(JaxRouterConfig(**router_cfg), seed=0)
    pr = RetrievalRouter(RouterConfig(**router_cfg), device="cpu")
    load_router(pr, jax.tree.map(np.asarray, jr.params), jax.tree.map(np.asarray, jr.stats))
    cfg = dict(checkpoint_dir=str(tmp_path), **train)
    return (jr, JaxTrainer(jr, config=JaxTrainConfig(**cfg)),
            pr, RouterTrainer(pr, config=TrainConfig(**cfg)))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 0.1])
def test_approx_ndcg_and_its_gradient_match_jax(masked, temperature):
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(6, 12)).astype(np.float32)
    rels = rng.uniform(0, 1, size=(6, 12)).astype(np.float32)
    rels[:, ::4] = 0.0
    mask = rng.random((6, 12)) < 0.7 if masked else None
    mask_j = None if mask is None else jnp.asarray(mask)
    ref, ref_grad = jax.value_and_grad(
        lambda s: jax_loss(s, jnp.asarray(rels), mask_j, temperature))(jnp.asarray(scores))
    s = torch.tensor(scores, requires_grad=True)
    loss = approx_ndcg_loss(s, torch.from_numpy(rels),
                            None if mask is None else torch.from_numpy(mask), temperature)
    loss.backward()
    assert np.isfinite(loss.item())
    assert abs(loss.item() - float(ref)) <= 1e-6
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(ref_grad), atol=1e-6)
    wrapped = ApproxNDCGLoss(temperature)(scores, rels, mask)
    assert wrapped.item() == loss.item()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_twenty_steps_match_jax(name, tmp_path):
    cfg = CONFIGS[name]
    jr, jt, pr, pt = _pair(cfg, tmp_path)
    bm25, dense, rel = synthetic_router_data(320, 20, seed=42)
    if cfg.get("fuse_norm") == "maxnorm":  # tower scores are nonnegative in use
        bm25, dense = np.abs(bm25) * 10.0, np.abs(dense)
    batches = [(bm25[i : i + 16], dense[i : i + 16], rel[i : i + 16]) for i in range(0, 320, 16)]

    if not cfg.get("decision_loss_weight"):
        # The first step's gradients, against jax.grad of the same objective.
        b, d, r = (jnp.asarray(a) for a in batches[0])
        jax_cfg = JaxRouterConfig(**cfg)

        def loss_fn(params):
            weights, _ = jr.module.apply({"params": params, "stats": jr.stats, **jr.extra}, b, d,
                                         update_stats=True, train=True,
                                         rngs={"dropout": jax.random.PRNGKey(0)},
                                         mutable=["stats", *jr.extra])
            bn, dn = jax_normalize(jax_cfg, b, d)
            return jax_loss(weights * dn + (1 - weights) * bn, r, None, jax_cfg.temperature)

        ref_grads = _leaves(jax.grad(loss_fn)(jr.params))
        snapshot = {k: v.clone() for k, v in pr.module.state_dict().items()}
        tb, td, trel = pt._tensors(batches[0])
        pt.total_loss(pr.module(tb, td, update_stats=True, train=True), tb, td, trel).backward()
        ours = _leaves(flax_tree(pr.module.flax_params(), lambda p: p.grad))
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in ref_grads))
        assert max(float(np.abs(a - g).max()) for a, g in zip(ours, ref_grads)) <= 1e-5 * norm
        pr.module.load_state_dict(snapshot)  # the stats move back; the step below redoes it
        pt.optimizer.opt.zero_grad(set_to_none=True)

    losses = [(jt.train_epoch(batch), pt.train_epoch(batch)) for batch in batches]
    np.testing.assert_allclose([p for _, p in losses], [j for j, _ in losses], atol=1e-4)
    _, stats = router_to_flax(pr)
    for key, value in jr.stats.items():
        assert abs(float(stats[key]) - float(value)) <= 1e-6, key
    assert pr.stats_initialized and pt.optimizer.count == 20


def test_plateau_rule_cuts_the_rate_at_the_same_epochs(tmp_path):
    jr, jt, pr, pt = _pair(CONFIGS["reference3"], tmp_path, learning_rate=0.05,
                           plateau_patience=0, num_epochs=10, early_stopping_patience=100)
    rates = {"jax": [], "port": []}
    for name, trainer in (("jax", jt), ("port", pt)):
        step = trainer._plateau_step

        def record(val_loss, step=step, trainer=trainer, name=name):
            step(val_loss)
            rates[name].append(trainer._lr)

        trainer._plateau_step = record
    bm25, dense, rel = synthetic_router_data(160, 20, seed=1)
    train, val = (bm25[:128], dense[:128], rel[:128]), (bm25[128:], dense[128:], rel[128:])
    hj, hp = jt.fit(train, val), pt.fit(train, val)
    assert rates["port"] == rates["jax"] and min(rates["port"]) < 0.05
    np.testing.assert_allclose(hp["val_losses"], hj["val_losses"], atol=1e-4)
    assert pt.optimizer.lr == float(np.asarray(jt.opt_state.hyperparams["learning_rate"]))


def test_checkpoints_cross_between_packages(tmp_path):
    cfg = CONFIGS["pool7_recipe"]
    jr, jt, pr, pt = _pair(cfg, tmp_path)
    bm25, dense, rel = synthetic_router_data(96, 20, seed=5)
    bm25, dense = np.abs(bm25) * 10.0, np.abs(dense)
    for i in range(0, 96, 16):
        pt.train_epoch((bm25[i : i + 16], dense[i : i + 16], rel[i : i + 16]))
    pt._lr = 5e-4
    pt.optimizer.lr = float(np.float32(pt._lr))
    pt.train_losses = [0.5]
    path = str(tmp_path / "port_router.msgpack")
    pt.save_checkpoint(path)
    # Into a JAX trainer of the default architecture: it rebuilds, then
    # restores params, stats and the optimizer state.
    fresh = JaxTrainer(JaxRouter(), config=JaxTrainConfig(checkpoint_dir=str(tmp_path)))
    fresh.load_checkpoint(path)
    params, stats = router_to_flax(pr)
    mine = {"params": params, "stats": stats, "opt_state": pt.opt_state_tree()}
    theirs = {"params": fresh.router.params, "stats": fresh.router.stats,
              "opt_state": fresh.opt_state}
    assert len(_leaves(theirs)) == len(_leaves(mine))
    for a, b in zip(_leaves(theirs), _leaves(mine)):
        assert np.array_equal(a, b)
    assert fresh._lr == 5e-4 and fresh.train_losses == [0.5]

    # A JAX checkpoint into a default port trainer, and one more step each.
    jt.load_checkpoint(path)
    jt.train_epoch((bm25[:16], dense[:16], rel[:16]))
    jpath = str(tmp_path / "jax_router.msgpack")
    jt.save_checkpoint(jpath)
    other = RouterTrainer(RetrievalRouter(device="cpu"),
                          config=TrainConfig(checkpoint_dir=str(tmp_path)))
    other.load_checkpoint(jpath)
    assert other.router.config.feature_set == "pool7" and other.optimizer.count == 7
    for a, b in zip(_leaves({"params": jt.router.params, "stats": jt.router.stats,
                             "opt_state": jt.opt_state}),
                    _leaves({"params": router_to_flax(other.router)[0],
                             "stats": router_to_flax(other.router)[1],
                             "opt_state": other.opt_state_tree()})):
        assert np.array_equal(a, b)
    batch = (bm25[16:32], dense[16:32], rel[16:32])
    np.testing.assert_allclose(other.train_epoch(batch), jt.train_epoch(batch), atol=1e-5)


def test_synthetic_cli_end_to_end(tmp_path):
    out = tmp_path / "router"
    port_cli.main(["--synthetic", "--epochs", "4", "--output-dir", str(out), "--device", "cpu"])
    results = json.loads((out / "training_results.json").read_text())
    assert set(results) == {"final_train_loss", "final_val_loss", "epochs_trained",
                            "val_hit_at_1", "wall_clock_seconds", "num_parameters"}
    assert results["epochs_trained"] == 4 and results["num_parameters"] == JaxRouter().num_params()
    assert 0.0 <= results["val_hit_at_1"] <= 1.0
    # best_router.msgpack and final_router.msgpack load in both packages.
    for name in ("best_router.msgpack", "final_router.msgpack"):
        router = RetrievalRouter(device="cpu")
        meta = load_router_checkpoint(router, str(out / name))
        assert meta["trained_num_passages"] == 20
        jax_router = JaxTrainer(JaxRouter(), config=JaxTrainConfig(checkpoint_dir=str(tmp_path)))
        jax_router.load_checkpoint(str(out / name))
        for a, b in zip(_leaves(jax_router.router.params), _leaves(router_to_flax(router)[0])):
            assert np.array_equal(a, b)
    # The port's hit@1 of the final router equals the JAX function's.
    bm25, dense, rel = synthetic_router_data(500, 20, 42)
    val = (bm25[400:], dense[400:], rel[400:])
    assert port_cli.evaluate_hit_at_1(router, *val) == jax_cli.evaluate_hit_at_1(
        jax_router.router, *val) == pytest.approx(results["val_hit_at_1"])


def test_train_mode_dropout_and_stats():
    """Dropout keeps about 1 - rate of the units, scaled by 1 / (1 - rate);
    eval mode and update_stats=False leave the statistics alone."""
    router = RetrievalRouter(RouterConfig(dropout=0.5), device="cpu").train()
    bm25, dense, _ = synthetic_router_data(64, 20, seed=2)
    a = router(bm25, dense, update_stats=False)
    assert not router.stats_initialized
    b = router(bm25, dense)
    assert router.stats_initialized and not torch.equal(a, b)
    before = {k: float(v) for k, v in router_to_flax(router)[1].items()}
    router.eval()
    c, d = router(bm25, dense), router(bm25, dense)
    assert torch.equal(c, d)
    assert {k: float(v) for k, v in router_to_flax(router)[1].items()} == before
    y = dropout(torch.ones(10_000), 0.5, torch.Generator().manual_seed(0))
    assert 0.45 < (y != 0).float().mean() < 0.55 and set(y.unique().tolist()) == {0.0, 2.0}
