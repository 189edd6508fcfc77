"""The port's TinyLM against the JAX package's, on the CPU.

Teacher-forced logits go through the KV-cached decoder one position at a
time on both sides (JAX: ``DecoderModel.apply(..., mutable=["cache"])``),
with the same weights (a JAX init carried across with
``convert.load_tiny_lm``, or the shipped checkpoint through both loaders).
Tolerances: float32 differs only in summation order (1e-4 on logits of
order 1); at bf16 each layer rounds its outputs in another order than XLA,
so logits are held by their mean absolute difference and argmax agreement.
Sampled text is never compared across the packages (their random streams
differ); greedy decoding (top-p 1e-6 keeps only the most likely token) is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_uq_tpu.llm.tiny_lm import TinyLM as JaxTinyLM
from rag_uq_tpu.llm.tiny_lm import TinyLMConfig as JaxTinyLMConfig
from rag_uq_tpu.llm.tiny_lm import sample_top_p as jax_sample_top_p
from rag_uq_tpu.llm.train import load_lm_checkpoint as jax_load_lm
from rag_uq_tpu_torch.cli.evaluate import build_qa_prompt
from rag_uq_tpu_torch.convert import load_tiny_lm
from rag_uq_tpu_torch.llm.tiny_lm import BOS, EOS, TinyLM, TinyLMConfig, sample_top_p, top_p_support
from rag_uq_tpu_torch.llm.train import load_lm_checkpoint

SMALL = dict(dim=64, num_layers=2, num_heads=4, mlp_dim=128, max_prompt_len=64, max_total_len=96)
R5 = "models/tiny_lm_r5/tiny_lm.msgpack"


def _jax_step_logits(model, params, batch_tok):
    """Teacher-forced logits [B, T, V] through the JAX decode-mode cache."""
    b, t = batch_tok.shape
    cache = model.init(jax.random.PRNGKey(0), jnp.zeros((b, model.config.max_total_len), jnp.int32),
                       jnp.zeros((b, model.config.max_total_len), jnp.int32))["cache"]
    cache = jax.tree.map(jnp.zeros_like, cache)
    step = jax.jit(lambda p, c, tok, pos: model.apply({"params": p, "cache": c}, tok, pos,
                                                       mutable=["cache"]))
    out = []
    for i in range(t):
        logits, upd = step(params, cache, jnp.asarray(batch_tok[:, i : i + 1]),
                           jnp.full((b, 1), i, jnp.int32))
        cache = upd["cache"]
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


def _port_step_logits(lm, batch_tok):
    cache = lm.model.init_cache(batch_tok.shape[0])
    with torch.no_grad():
        out = [lm.model(torch.from_numpy(batch_tok[:, i : i + 1]), cache)[:, -1]
               for i in range(batch_tok.shape[1])]
    return torch.stack(out, dim=1).numpy()


def _small_pair(dtype):
    jcfg = JaxTinyLMConfig(**SMALL, dtype=dtype)
    jlm = JaxTinyLM(jcfg, seed=3)
    lm = load_tiny_lm(TinyLM(TinyLMConfig(**SMALL, dtype=dtype), device="cpu"),
                      jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


def _tokens(batch=3, length=20, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 256, size=(batch, length)).astype(np.int32)
    tok[:, 0] = BOS
    return tok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_decoder_cached_logits_match_jax(dtype):
    jlm, lm = _small_pair(dtype)
    tok = _tokens()
    ref = _jax_step_logits(jlm.model, jlm.params, tok)
    ours = _port_step_logits(lm, tok)
    assert ours.shape == ref.shape == (3, 20, 258) and ours.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, atol=1e-4)
    else:  # bf16 activations: a few ulps of drift a layer
        assert np.abs(ours - ref).mean() < 2e-2
        assert (ours.argmax(-1) == ref.argmax(-1)).mean() >= 0.9


def test_shipped_decoder_cached_logits_match_jax():
    """models/tiny_lm_r5 on a 200-byte prompt, position by position."""
    prompt = build_qa_prompt("Where does Drialjaeth lie?",
                             "Drialjaeth lies in the heart of Breingrothjaes. It was founded "
                             "around 1478 and has a population of about 3114000.")
    raw = prompt.encode()[:199]
    tok = np.asarray([[BOS, *raw]], dtype=np.int32)
    assert tok.shape[1] == 200
    ref = _jax_step_logits(jax_load_lm(R5).model, jax_load_lm(R5).params, tok)
    ours = _port_step_logits(load_lm_checkpoint(R5, device="cpu"), tok)
    diff = np.abs(ours - ref)
    # Logits of order 10; bf16 rounding drift through 6 layers.
    assert diff.mean() < 0.1, diff.mean()
    assert (ours.argmax(-1) == ref.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_prefill_matches_the_step_loop(dtype, atol):
    """The causal prefill writes the same cache and gives the same logits
    as feeding one position at a time."""
    _, lm = _small_pair(dtype)
    tok = _tokens(length=24)
    steps = _port_step_logits(lm, tok)
    cache = lm.model.init_cache(tok.shape[0])
    with torch.no_grad():
        first = lm.model(torch.from_numpy(tok[:, :17]), cache)
        rest = [lm.model(torch.from_numpy(tok[:, i : i + 1]), cache)[:, -1] for i in range(17, 24)]
    pre = torch.cat([first, torch.stack(rest, 1)], dim=1).numpy()
    np.testing.assert_allclose(pre, steps, atol=atol)
    assert (pre.argmax(-1) == steps.argmax(-1)).all()


def test_encode_decode_and_batch_padding_match_jax(monkeypatch):
    jlm, lm = _small_pair("float32")
    prompts = ["", "héllo", "x" * 40, "y" * 70, "z" * 200]  # trims at 63 bytes
    for group in (prompts[:1], prompts[:3], prompts):
        jb, jl, jp = jlm._encode_prompts(group)
        tb, tl, tp = lm._encode_prompts(group)
        assert jp == tp
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tl, jl)
    for toks in ([72, 105, EOS, 65], [72, 0, 65], [BOS, 32, 72, 32], [0xC3, 0xA9, EOS], []):
        assert lm._decode(np.asarray(toks)) == JaxTinyLM._decode(np.asarray(toks))

    seen = {}

    def fake_sampler(batch, max_tokens, prompt_len):
        def run(params, cache, prompts, plens, temps, tops, rng):
            seen.update(prompts=np.asarray(prompts), plens=np.asarray(plens),
                        temps=np.asarray(temps), tops=np.asarray(tops))
            z = jnp.zeros((batch,), jnp.float32)
            return jnp.zeros((batch, max_tokens), jnp.int32), z, z, jnp.zeros((batch,), jnp.int32)
        return run

    monkeypatch.setattr(jlm, "_get_sampler", fake_sampler)
    monkeypatch.setattr(jlm, "_init_cache", lambda b: None)
    for n in (1, 3, 5, 8):
        group = [prompts[i % len(prompts)] for i in range(n)]
        temps, tops = [0.3 + 0.1 * i for i in range(n)], [0.8] * n
        jlm.generate_batch(group, temps, tops, max_tokens=4)
        tb, tl, _ = lm._encode_prompts(group)
        pb, pl, pt, pp = lm._pad_batch(tb, tl, np.asarray(temps, np.float32),
                                       np.asarray(tops, np.float32))
        for ours, key in ((pb, "prompts"), (pl, "plens"), (pt, "temps"), (pp, "tops")):
            np.testing.assert_array_equal(ours, seen[key], err_msg=f"n={n} {key}")


def test_sample_top_p_support():
    """Every sample lies in the kept set, on both sides, and the kept set
    is what the JAX rule keeps (ties included)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 12)).astype(np.float32) * 3
    logits[0, :4] = 5.0  # four tied maxima: all stay in
    logits[1] = 0.0  # a flat row
    temps = np.asarray([1.0, 1.0, 0.5, 1e-6, 2.0, 1.0], np.float32)
    tops = np.asarray([0.3, 0.5, 0.9, 0.9, 0.99, 1e-6], np.float32)
    _, keep = top_p_support(torch.from_numpy(logits), torch.from_numpy(temps),
                            torch.from_numpy(tops))
    keep = keep.numpy()
    assert keep[0, :4].all()  # tied maxima stay in together
    assert keep[1].all()
    assert keep[3].sum() == 1 and keep[5].sum() == 1
    gen = torch.Generator().manual_seed(0)
    jax_seen = np.zeros_like(keep)
    for s in range(200):
        t = sample_top_p(torch.from_numpy(logits), torch.from_numpy(temps),
                         torch.from_numpy(tops), gen).numpy()
        j = np.asarray(jax_sample_top_p(jax.random.PRNGKey(s), jnp.asarray(logits),
                                        jnp.asarray(temps), jnp.asarray(tops)))
        assert keep[np.arange(6), t].all() and keep[np.arange(6), j].all()
        jax_seen[np.arange(6), j] = True
    np.testing.assert_array_equal(jax_seen[[0, 3, 5]], keep[[0, 3, 5]])


def _greedy_prompts():
    facts = [("Where is the Rirknesh observatory?", "The Rirknesh observatory is in Drialjaeth."),
             ("When was Drialjaeth founded?", "Drialjaeth was founded around 1478."),
             ("What river flows through Hontis?", "The river Maelchein flows through Hontis."),
             ("What does the lynx eat?", "The lynx eats small rodents and birds.")]
    return [build_qa_prompt(q, c) for q, c in facts]


def test_greedy_decodes_match_jax():
    """Four short QA prompts through models/tiny_lm_r5, greedy, on both."""
    prompts = _greedy_prompts()
    n = len(prompts)
    ref = jax_load_lm(R5).generate_batch_scored(prompts, [0.1] * n, [1e-6] * n, max_tokens=24)
    lm = load_lm_checkpoint(R5, device="cpu")
    ours = lm.generate_batch_scored(prompts, [0.1] * n, [1e-6] * n, max_tokens=24)
    assert ours[0] == ref[0]
    # Log-probabilities of the same tokens: the bf16 logit drift (see the
    # cached-logits tests) moves a prompt's mean by up to 12% of itself
    # (0.022 at a mean of -0.19) and its min by up to 10%. In float32 the
    # two agree to 1e-5 (test_greedy_log_probabilities_match_jax_in_float32).
    np.testing.assert_allclose(ours[1], ref[1], rtol=0.2, atol=5e-3)  # mean
    np.testing.assert_allclose(ours[2], ref[2], rtol=0.2, atol=5e-3)  # min: one token
    # Sampling is reproducible on one device for one seed.
    a = lm.generate_batch(prompts, [0.8] * n, [0.9] * n, max_tokens=24, seed=11)
    assert a == lm.generate_batch(prompts, [0.8] * n, [0.9] * n, max_tokens=24, seed=11)
    assert lm.generate(prompts[0], temperature=0.1, top_p=1e-6, max_tokens=24) == ref[0][0]


def test_greedy_log_probabilities_match_jax_in_float32():
    """models/tiny_lm_r5's weights run in float32 on both sides: the greedy
    texts are equal and their mean and min log-probabilities agree to 1e-5.
    The scores are the raw model's: greedy decoding at temperature 0.1 and
    at 1.0 picks the same tokens and scores them the same, where scores
    taken under the temperature-scaled logits would move toward 0 at 0.1."""
    import dataclasses
    import json

    from rag_uq_tpu.llm.tiny_lm import TinyLM as JaxTinyLM
    from rag_uq_tpu_torch.utils.checkpoint import load_flax_checkpoint

    prompts = _greedy_prompts()
    n = len(prompts)
    saved = jax_load_lm(R5)
    jax_lm = JaxTinyLM(dataclasses.replace(saved.config, dtype="float32"))
    jax_lm.load_params(saved.params)
    ref = jax_lm.generate_batch_scored(prompts, [0.1] * n, [1e-6] * n, max_tokens=24)
    with open(R5 + ".json") as f:
        config = TinyLMConfig(**{**json.load(f)["model_config"], "dtype": "float32"})
    lm = load_tiny_lm(TinyLM(config, device="cpu"), load_flax_checkpoint(R5))
    ours = lm.generate_batch_scored(prompts, [0.1] * n, [1e-6] * n, max_tokens=24)
    assert ours[0] == ref[0]
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-5)
    hot = lm.generate_batch_scored(prompts, [1.0] * n, [1e-6] * n, max_tokens=24)
    assert hot[0] == ours[0]
    np.testing.assert_allclose(hot[1], ours[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(hot[2], ours[2], rtol=0, atol=1e-6)
    assert min(ours[1]) < -0.05  # far from 0: one prompt's greedy tokens are uncertain
