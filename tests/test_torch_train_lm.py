"""The port's TinyLM trainer against the JAX package's, on the CPU.

The same numpy batches go through ``rag_uq_tpu.llm.train.TinyLMTrainer``
and ``rag_uq_tpu_torch.llm.train.TinyLMTrainer``, the JAX trainer's initial
parameters carried across. Tolerances: in float32 the two differ only in
summation order (logits 1e-4, loss 1e-6 relative, gradients 1e-5 of the
global gradient norm, five steps' losses 1e-5 relative); at bf16 XLA fuses
the jitted step and rounds in another order than eager PyTorch, so the
five losses are held within 5e-3 relative (measured: 8e-4 at most).
Checkpoints cross in both directions bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rag_uq_tpu.llm import train as jax_train
from rag_uq_tpu.llm.tiny_lm import TinyLMConfig as JaxTinyLMConfig
from rag_uq_tpu_torch.core.flax_nn import flax_tree
from rag_uq_tpu_torch.data.synth_wiki import generate_world
from rag_uq_tpu_torch.llm import train as port_train
from rag_uq_tpu_torch.llm.tiny_lm import BOS, TinyLMConfig
from rag_uq_tpu_torch.utils.optim import warmup_cosine_decay_schedule

SMALL = dict(dim=64, num_layers=2, num_heads=4, mlp_dim=128, max_prompt_len=64, max_total_len=96)
TRAIN = dict(learning_rate=3e-3, warmup_steps=2, total_steps=8, batch_size=4, seq_len=32, seed=0)


def _pair(dtype, **train):
    cfg = {**TRAIN, **train}
    jt = jax_train.TinyLMTrainer(JaxTinyLMConfig(**SMALL, dtype=dtype),
                                 jax_train.LMTrainConfig(**cfg))
    pt = port_train.TinyLMTrainer(TinyLMConfig(**SMALL, dtype=dtype),
                                  port_train.LMTrainConfig(**cfg), device="cpu")
    pt.load_params(jax.tree.map(np.asarray, jt.params))
    return jt, pt


def _batch(seed=1, rows=4, length=33):
    rng = np.random.default_rng(seed)
    batch = rng.integers(1, 256, size=(rows, length)).astype(np.int32)
    batch[:, 0] = BOS
    mask = (rng.random((rows, length - 1)) < 0.7).astype(np.float32)
    return batch, mask


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_sequence_logits_match_jax_and_the_cached_decode(dtype):
    jt, pt = _pair(dtype)
    tok = _batch()[0][:, :24]
    ref = np.asarray(jax.jit(jt.module.apply)({"params": jt.params}, jnp.asarray(tok)))
    with torch.no_grad():
        ours = pt.model(torch.from_numpy(tok)).numpy()
        lm = pt.export_sampler()
        cache = lm.model.init_cache(tok.shape[0])
        steps = torch.stack([lm.model(torch.from_numpy(tok[:, i : i + 1]), cache)[:, -1]
                             for i in range(tok.shape[1])], dim=1).numpy()
    assert ours.shape == ref.shape == (4, 24, 258)
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, atol=1e-4)
        np.testing.assert_allclose(steps, ours, atol=1e-5)
    else:  # the bound of tests/test_torch_tiny_lm.py at bf16
        for other in (ref, steps):
            assert np.abs(ours - other).mean() < 2e-2
            assert (ours.argmax(-1) == other.argmax(-1)).mean() >= 0.9


def test_step_one_loss_and_gradients_match_jax():
    jt, pt = _pair("float32")
    batch, mask = _batch()

    def loss_fn(params):
        logits = jt.module.apply({"params": params}, jnp.asarray(batch[:, :-1]))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(batch[:, 1:]))
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jt.params)
    loss = pt.loss(torch.from_numpy(batch), torch.from_numpy(mask))
    loss.backward()
    grads = flax_tree(pt.model.flax_params(), lambda p: p.grad)
    ref_leaves, our_leaves = _leaves(ref_grads), _leaves(grads)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in ref_leaves))
    assert abs(loss.item() - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    assert max(float(np.abs(a - b).max()) for a, b in zip(ref_leaves, our_leaves)) <= 1e-5 * norm


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_five_steps_match_jax(dtype, rtol):
    jt, pt = _pair(dtype)
    before = [p.detach().clone() for p in pt.model.parameters()]
    ref, ours = [], []
    for s in range(5):
        batch, mask = _batch(seed=10 + s)
        ref.append(jt.train_step(batch, mask))
        ours.append(pt.train_step(batch, mask))
        if s == 0:  # the schedule's first rate is 0: nothing moves
            assert all(torch.equal(a, b) for a, b in zip(before, pt.model.parameters()))
    np.testing.assert_allclose(ours, ref, rtol=rtol)
    assert pt.step == jt.step == 5 and pt.optimizer.count == 5


@pytest.mark.parametrize("init,peak,warmup,total", [
    (0.0, 3e-4, 50, 1000), (0.0, 2e-4, 1, 30), (0.0, 5e-4, 0, 7), (0.0, 3e-4, 50, 51),
])
def test_schedules_match_optax(init, peak, warmup, total):
    ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, total)
    ours = warmup_cosine_decay_schedule(init, peak, warmup, total)
    for count in range(total + 6):
        want = float(ref(jnp.asarray(count, jnp.int32)))
        assert abs(ours(count) - want) <= 1e-7 * peak, (count, ours(count), want)


def test_trainer_clips_its_warmup_as_jax_does():
    """warmup 100 over 2 steps runs as warmup 1: the second step's rate is
    the peak, and the second losses agree."""
    jt, pt = _pair("float32", warmup_steps=100, total_steps=2)
    assert pt.schedule(0) == 0.0 and pt.schedule(1) == pytest.approx(TRAIN["learning_rate"])
    for s in range(2):
        batch, mask = _batch(seed=s)
        np.testing.assert_allclose(pt.train_step(batch, mask), jt.train_step(batch, mask),
                                   rtol=1e-5)
    batch, mask = _batch(seed=2)
    np.testing.assert_allclose(pt.train_step(batch, mask), jt.train_step(batch, mask), rtol=1e-5)


def test_qa_encoders_are_the_jax_copies():
    world = generate_world(60, seed=4)
    rows = world.qa_rows()
    texts = [r["text"] for r in world.corpus_rows()]
    pools = [texts[i % 7 :: 7] for i in range(len(rows))]
    assert port_train.QA_HEADERS == jax_train.QA_HEADERS
    assert vars(port_train.LMTrainConfig()) == vars(jax_train.LMTrainConfig())
    assert port_train.build_qa_prompt("q?", "c.", "h\n") == jax_train.build_qa_prompt("q?", "c.", "h\n")
    for kwargs in (dict(), dict(distractor_texts=texts),
                   dict(distractor_texts=texts, min_distractors=1, max_distractors=3,
                        hard_distractors=pools, hard_fraction=0.5, fit_budget=True,
                        gold_first_prob=0.3)):
        for seq_len in (96, 512):
            a = port_train.encode_qa_examples(rows, seq_len, seed=5, **kwargs)
            b = jax_train.encode_qa_examples(rows, seq_len, seed=5, **kwargs)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    np.testing.assert_array_equal(port_train.encode_corpus(texts[:20], 64),
                                  jax_train.encode_corpus(texts[:20], 64))


def test_checkpoints_cross_between_packages(tmp_path):
    jt, pt = _pair("float32")
    for s in range(3):
        pt.train_step(*_batch(seed=s))
    # The port's inference checkpoint through the JAX loader.
    pt.save_checkpoint(str(tmp_path / "lm.msgpack"))
    lm = jax_train.load_lm_checkpoint(str(tmp_path / "lm.msgpack"))
    for a, b in zip(_leaves(lm.params), _leaves(pt.params_tree())):
        assert np.array_equal(a, b)
    # The port's resumable state through the JAX trainer, opt_state included.
    pt.save_state(str(tmp_path / "state.msgpack"))
    assert jt.restore_state(str(tmp_path / "state.msgpack")) == 3
    for a, b in zip(_leaves((jt.params, jt.opt_state)),
                    _leaves((pt.params_tree(), pt.opt_state_tree()))):
        assert np.array_equal(a, b)
    # And a JAX-written state back into a fresh port trainer: the next step
    # of each then agrees.
    jt.train_step(*_batch(seed=7))
    jt.save_state(str(tmp_path / "jax_state.msgpack"))
    fresh = port_train.TinyLMTrainer(TinyLMConfig(**SMALL, dtype="float32"),
                                     port_train.LMTrainConfig(**TRAIN),
                                     device="cpu")
    assert fresh.restore_state(str(tmp_path / "jax_state.msgpack")) == 4
    for a, b in zip(_leaves((jt.params, jt.opt_state)),
                    _leaves((fresh.params_tree(), fresh.opt_state_tree()))):
        assert np.array_equal(a, b)
    assert fresh.optimizer.count == 4 and len(fresh.losses) == 4
    batch, mask = _batch(seed=8)
    np.testing.assert_allclose(fresh.train_step(batch, mask), jt.train_step(batch, mask),
                               rtol=1e-5)


def test_fit_qa_then_the_sampler_answers(tmp_path):
    world = generate_world(30, seed=2)
    cfg = TinyLMConfig(dim=32, num_layers=1, num_heads=2, mlp_dim=64, max_prompt_len=256,
                       max_total_len=320)
    trainer = port_train.TinyLMTrainer(
        cfg, port_train.LMTrainConfig(seq_len=256, batch_size=4, total_steps=6,
                                      warmup_steps=1, learning_rate=3e-3),
        device="cpu")
    losses = trainer.fit_qa(world.qa_rows())
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[1]
    lm = trainer.export_sampler()
    out = lm.generate_batch(["Question: x\n\nAnswer:"] * 2, [0.1] * 2, [0.9] * 2, max_tokens=4)
    assert len(out) == 2 and all(isinstance(o, str) for o in out)
    trainer.save_checkpoint(str(tmp_path / "lm.msgpack"))
    again = port_train.load_lm_checkpoint(str(tmp_path / "lm.msgpack"), device="cpu")
    for a, b in zip(again.model.state_dict().values(), lm.model.state_dict().values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="max_total_len"):
        trainer.fit_qa(world.qa_rows(), seq_len=400)


def test_compute_copies_follow_the_masters():
    """Without autograd the layers read cached bf16 copies of the float32
    masters: reused while the masters stand still, made again after an
    optimizer step, so the no-grad forward always sees the trained weights."""
    _, pt = _pair("bfloat16")
    tok = torch.from_numpy(_batch()[0][:, :16])
    with torch.no_grad():
        before = pt.model(tok)
        cached = pt.model.layers[0].mlp_in._at_dtype("weight")
        assert cached.dtype == torch.bfloat16
        assert pt.model.layers[0].mlp_in._at_dtype("weight") is cached
    for s in range(2):
        pt.train_step(*_batch(seed=s))
    fresh = port_train.TinyLMTrainer(TinyLMConfig(**SMALL), port_train.LMTrainConfig(**TRAIN),
                                     device="cpu")
    fresh.load_params(pt.params_tree())
    with torch.no_grad():
        after = pt.model(tok)
        assert pt.model.layers[0].mlp_in._at_dtype("weight") is not cached
        assert torch.equal(after, fresh.model(tok)) and not torch.equal(after, before)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in pt.model.parameters())
