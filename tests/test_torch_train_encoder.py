"""The port's contrastive encoder trainer against the JAX package's, on the CPU.

The same hashed pairs go through ``rag_uq_tpu.embed.train.ContrastiveTrainer``
and the port's, the JAX trainer's initial parameters carried across.
Tolerances: in float32 the loss within 1e-6 relative, the gradients within
1e-5 of the global gradient norm and five steps' losses within 1e-5
relative (summation order only); at bf16 the jitted XLA step rounds in
another order than eager PyTorch, so five steps' losses are held within
1e-2 relative. Checkpoints cross bit for bit; the numpy pair generators are
the JAX functions' copies.

The data-parallel step (``make_train_step(mesh)``, four spawned gloo ranks,
``tests/test_torch_spawn.py::train_program``) against the single-device
step from the same initial weights, in float32 (in bf16 each rank's partial
weight gradients round apart, about 1% here): the summed gradients within 1e-5 of
the global gradient norm (a gradient counted once a rank, S times over,
fails this; Adam's update alone would not show it), the loss within 1e-6
relative, and after two steps at the peak learning rate the losses within
1e-6 relative and every parameter whose gradient is more than rounding
noise within 1e-4, every rank's parameters equal (JAX holds its DP step to
the loss within 1e-3 and the first parameter leaf within 1e-4,
``tests/test_encoder_train.py:137-169``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from rag_uq_tpu.cli import train_encoder as jax_cli
from rag_uq_tpu.embed import train as jax_train
from rag_uq_tpu.embed.encoder import EncoderConfig as JaxEncoderConfig
from rag_uq_tpu_torch.cli import train_encoder as port_cli
from rag_uq_tpu_torch.convert import encoder_to_flax, load_encoder
from rag_uq_tpu_torch.core.mesh import _spawn_ranks
from rag_uq_tpu_torch.core.flax_nn import flax_tree
from rag_uq_tpu_torch.data.synth_wiki import generate_world
from rag_uq_tpu_torch.embed import train as port_train
from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder
from rag_uq_tpu_torch.utils.checkpoint import write_msgpack

from tests.test_torch_spawn import dp_trainer, train_program

TINY = dict(dim=32, num_layers=1, num_heads=2, mlp_dim=64, max_seq_len=32, vocab_buckets=2048)
TRAIN = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10, batch_size=16, seed=0)


@pytest.fixture(scope="module")
def world():
    return generate_world(60, seed=0)


def _pair(dtype):
    jt = jax_train.ContrastiveTrainer(config=jax_train.EncoderTrainConfig(**TRAIN),
                                      encoder_config=JaxEncoderConfig(**TINY, dtype=dtype))
    pt = port_train.ContrastiveTrainer(config=port_train.EncoderTrainConfig(**TRAIN),
                                       encoder_config=EncoderConfig(**TINY, dtype=dtype),
                                       device="cpu")
    load_encoder(pt.encoder, jax.tree.map(np.asarray, jt.params))
    return jt, pt


def _pairs(world, n=16, offset=0):
    rows = world.qa_rows()[offset : offset + n]
    return [r["question"] for r in rows], [r["context"] for r in rows]


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_step_one_loss_and_gradients_match_jax(world):
    jt, pt = _pair("float32")
    q_ids, q_len, p_ids, p_len = pt.encode_pairs(*_pairs(world))
    model = jt.encoder.model

    def loss_fn(params):
        emb = model.apply(params, jnp.concatenate([q_ids, p_ids]), jnp.concatenate([q_len, p_len]))
        logits = (emb[:16] @ emb[16:].T) * (1.0 / 0.05)
        labels = jnp.arange(16)
        return (optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
                + optax.softmax_cross_entropy_with_integer_labels(logits.T, labels).mean()) / 2

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jt.params)
    loss = pt.loss(*(torch.from_numpy(a) for a in (q_ids, q_len, p_ids, p_len)))
    loss.backward()
    ours = _leaves({"params": flax_tree(pt.model.flax_params(), lambda p: p.grad)})
    ref = _leaves(ref_grads)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in ref))
    assert abs(loss.item() - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    assert max(float(np.abs(a - b).max()) for a, b in zip(ref, ours)) <= 1e-5 * norm


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_five_steps_match_jax(world, dtype, rtol):
    jt, pt = _pair(dtype)
    before = [p.detach().clone() for p in pt.model.parameters()]
    ref, ours = [], []
    for s in range(5):
        batch = pt.encode_pairs(*_pairs(world, offset=16 * s))
        ref.append(jt.train_step(*batch))
        ours.append(pt.train_step(*batch))
        if s == 0:  # warmup from 0: the first step moves nothing
            assert all(torch.equal(a, b) for a, b in zip(before, pt.model.parameters()))
    np.testing.assert_allclose(ours, ref, rtol=rtol)


def test_fit_draws_the_jax_batches(world):
    """fit's numpy-seeded batching (one pair per passage) gives both
    packages the same batches, so the same losses."""
    jt, pt = _pair("float32")
    rows = world.qa_rows()
    queries, passages = [r["question"] for r in rows], [r["context"] for r in rows]
    ref = jt.fit(queries, passages, steps=4)
    ours = pt.fit(queries, passages, steps=4)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def test_pair_generators_are_the_jax_copies(world):
    texts = [r["text"] for r in world.corpus_rows()]
    questions = [r["question"] for r in world.qa_rows()]
    for seed in (0, 3):
        assert port_train.synthesize_pairs(texts, 200, seed=seed) == jax_train.synthesize_pairs(
            texts, 200, seed=seed)
        for variants in (1, 2, 4):
            assert port_train.augment_registers(questions, seed, variants) == \
                jax_train.augment_registers(questions, seed, variants)
    assert vars(port_train.EncoderTrainConfig()) == vars(jax_train.EncoderTrainConfig())


def test_checkpoints_and_optimizer_state_cross_between_packages(world, tmp_path):
    jt, pt = _pair("float32")
    for s in range(3):
        batch = pt.encode_pairs(*_pairs(world, offset=16 * s))
        jt.train_step(*batch)
        pt.train_step(*batch)
    path = str(tmp_path / "enc.msgpack")
    pt.save_checkpoint(path)
    loaded = jax_train.load_encoder_checkpoint(path)
    assert all(np.array_equal(a, b) for a, b in
               zip(_leaves(loaded.params), _leaves(encoder_to_flax(pt.encoder))))
    texts = [r["text"] for r in world.corpus_rows()[:8]]
    np.testing.assert_allclose(port_train.load_encoder_checkpoint(path, device="cpu").encode(texts),
                               loaded.encode(texts), atol=1e-5)
    # The optimizer state restores into the JAX trainer's optax state.
    restored = serialization.from_bytes(jt.opt_state, write_msgpack(pt.opt_state_tree()))
    assert len(_leaves(restored)) == len(_leaves(jt.opt_state))
    assert int(restored[1][0].count) == int(restored[1][2].count) == 3
    for a, b in zip(_leaves(restored), _leaves(pt.opt_state_tree())):
        assert np.array_equal(a, b)
    # A JAX checkpoint into the port, bit for bit.
    jpath = str(tmp_path / "jax_enc.msgpack")
    jt.save_checkpoint(jpath)
    ours = port_train.load_encoder_checkpoint(jpath, device="cpu")
    assert all(np.array_equal(a, b) for a, b in
               zip(_leaves(jax.tree.map(np.asarray, jt.params)), _leaves(encoder_to_flax(ours))))


def test_recall_and_split_match_jax(world):
    jt, pt = _pair("float32")
    corpus, qa = world.corpus_rows(), world.qa_rows()
    train_q, held_q = port_cli.split_by_entity(qa, 0.2)
    assert (train_q, held_q) == jax_cli.split_by_entity(qa, 0.2)
    ours = port_cli.dense_recall_at_k(pt.encoder, corpus, held_q, k=5, device="cpu")
    ref = jax_cli.dense_recall_at_k(jt.encoder, corpus, held_q, k=5)
    assert ours == ref and 0.0 < ours <= 1.0


def test_cli_end_to_end(tmp_path):
    out = tmp_path / "encoder"
    port_cli.main(["--articles", "40", "--steps", "3", "--batch-size", "8", "--dim", "32",
                   "--layers", "1", "--output-dir", str(out), "--device", "cpu"])
    results = json.loads((out / "encoder_results.json").read_text())
    assert results["steps"] == 3 and set(results["dense_recall@10"]) == {
        "trained_encoder", "untrained_encoder", "ngram_hash", "sha256_reference_fallback"}
    meta = json.loads((out / "encoder.msgpack.json").read_text())
    assert meta["n_steps"] == 3 and meta["encoder_config"]["dim"] == 32
    again = port_train.load_encoder_checkpoint(str(out / "encoder.msgpack"), device="cpu")
    assert isinstance(again, TransformerEmbedder) and again.encode(["a b"]).shape == (1, 32)


DP_RANKS = 4


def test_data_parallel_step_equals_the_single_device_step(world, tmp_path):
    trainer = dp_trainer()
    batches = [trainer.encode_pairs(*_pairs(world, n=16, offset=o)) for o in (0, 16)]
    _spawn_ranks(train_program, DP_RANKS, (batches, str(tmp_path)))
    ranks = [dict(np.load(tmp_path / f"train_{r}.npz")) for r in range(DP_RANKS)]

    loss = trainer.loss(*(torch.from_numpy(a) for a in batches[0]))
    loss.backward()
    grads = [p.grad.numpy().copy() for p in trainer.optimizer.params]
    trainer.optimizer.opt.zero_grad(set_to_none=True)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    losses = [trainer.train_step(*b) for b in batches]
    params = [p.detach().numpy() for p in trainer.optimizer.params]
    # Leaves whose gradient is more than rounding noise: the attention key
    # bias has none in exact arithmetic, and Adam moves a leaf by about the
    # learning rate whatever the sign of its noise.
    moved = [j for j, g in enumerate(grads) if np.abs(g).max() > 1e-4 * norm]
    assert 0 in moved and len(moved) >= len(grads) - 2
    for got in ranks:
        assert abs(float(got["loss0"]) - loss.item()) <= 1e-6 * loss.item()
        for j, g in enumerate(grads):
            assert np.abs(got[f"grad_{j}"] - g).max() <= 1e-5 * norm, j
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
        for j in moved:
            np.testing.assert_allclose(got[f"param_{j}"], params[j], atol=1e-4, rtol=0)
        for j in range(len(grads)):
            np.testing.assert_array_equal(got[f"param_{j}"], ranks[0][f"param_{j}"])
