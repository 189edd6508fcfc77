"""The port's DeepSeek-V2 generator (``rag_uq_tpu_torch/llm/deepseek_v2.py``)
against the plain reference (``tests/deepseek_v2_reference.py``) at a tiny
configuration on the CPU, with weights drawn from seeds by name.

In float32 the port's prefill and its cached, absorbed decode agree with the
reference's full forward pass to float32 rounding (the absorption and the
padding change only the order of sums): 2e-5 of the logits' largest value.
In bfloat16 (the configuration's precision) they agree to 5% of it: the
bfloat16 rounding of weights is shared, that of activations is not.
"""

import ast
import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rag_uq_tpu_torch.llm import deepseek_v2 as dsv2
from rag_uq_tpu_torch.llm.deepseek_v2 import Capture, DeepseekV2Config, DeepseekV2LM
from rag_uq_tpu_torch.llm.word_tokenizer import WordTokenizer
from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence
from rag_uq_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
REF_PATH = REPO / "tests" / "deepseek_v2_reference.py"
_spec = importlib.util.spec_from_file_location("deepseek_v2_reference", REF_PATH)
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=4, num_attention_heads=2, num_key_value_heads=2,
            n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
            qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16)
SEED = 2**31 + 17
# Float32 rounding, relative to the logits' largest magnitude.
F32_TOL = 2e-5


def _lm(dtype="float32", **over):
    return DeepseekV2LM(DeepseekV2Config(**{**TINY, **over}, dtype=dtype), seed=SEED,
                        device="cpu")


@pytest.fixture(scope="module")
def lm32():
    return _lm()


@pytest.fixture(scope="module")
def ref_weights(lm32):
    cfg = lm32.config.to_dict()
    return cfg, ref.weights(ref.published_shapes(cfg), ref.tensor_seeds(cfg, SEED), 0.02, "cpu",
                            storage=torch.float32)


def _ids(n, seed=0):
    return torch.randint(0, 510, (n,), generator=torch.Generator().manual_seed(seed))


def test_the_drawn_weights_are_the_references_by_published_name(lm32, ref_weights):
    cfg, w = ref_weights
    names = [n for n, _ in lm32.model.published()]
    assert sorted(names) == sorted(w) and len(names) == len(set(names))
    for name, t in lm32.model.published():
        assert torch.equal(t, w[name]), name
    assert lm32.model.num_params() == sum(t.numel() for t in w.values())


def test_load_state_dict_takes_the_published_tensors(ref_weights):
    cfg, w = ref_weights
    lm = _lm()
    lm.model.load_state_dict({k: v * 0.5 for k, v in w.items()})
    for name, t in lm.model.published():
        assert torch.equal(t, w[name] * 0.5), name
    assert torch.equal(lm.model.layers[1].gate_f32, w["model.layers.1.mlp.gate.weight"] * 0.5)


def test_prefill_then_absorbed_decode_matches_the_reference(lm32, ref_weights):
    cfg, w = ref_weights
    ids = _ids(24)
    want, _ = ref.forward(w, ids, cfg)
    scale = float(want.abs().max())
    logits, cache = lm32.model.prefill([ids[:15]])
    assert (logits[0] - want[14]).abs().max() / scale < F32_TOL
    cache.fork(1, 9)
    for t in range(9):
        got = lm32.model.decode_step(ids[15 + t : 16 + t], torch.tensor([15 + t]), cache, t)
        assert (got[0] - want[15 + t]).abs().max() / scale < F32_TOL, t


def test_the_prefill_path_and_the_decode_path_agree_on_the_same_positions(lm32):
    ids = _ids(12, seed=1)
    full, _ = lm32.model.prefill([ids])
    logits, cache = lm32.model.prefill([ids[:1]])
    cache.fork(1, 11)
    for t in range(11):
        logits = lm32.model.decode_step(ids[t + 1 : t + 2], torch.tensor([t + 1]), cache, t)
    assert torch.allclose(logits[0], full[0], rtol=0, atol=F32_TOL * float(full.abs().max()))


def test_bfloat16_stays_near_the_float32_reference(ref_weights):
    cfg, _ = ref_weights
    lm = _lm("bfloat16")
    w = ref.weights(ref.published_shapes(cfg), ref.tensor_seeds(cfg, SEED), 0.02, "cpu")
    ids = _ids(20, seed=2)
    want, _ = ref.forward(w, ids, cfg)
    logits, cache = lm.model.prefill([ids[:14]])
    cache.fork(1, 6)
    got = [logits[0]]
    for t in range(5):
        got.append(lm.model.decode_step(ids[14 + t : 15 + t], torch.tensor([14 + t]), cache,
                                        t)[0])
    err = (torch.stack(got) - want[13:19]).abs().max() / want.abs().max()
    assert 0 < err < 0.05


def test_yarn_frequencies_and_scales_follow_the_published_formulas():
    cfg = DeepseekV2Config()
    # mscale(40, 0.707) = 0.1 * 0.707 * ln 40 + 1.
    m = 0.1 * 0.707 * math.log(40) + 1
    assert dsv2.yarn_mscale(40, 0.707) == pytest.approx(m)
    assert dsv2.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m)
    assert dsv2.rope_mscale(cfg) == pytest.approx(1.0)
    inv = dsv2.yarn_inv_freq(cfg).double()
    # The correction range: floor(64 ln(4096 / (32 * 2 pi)) / (2 ln 1e4)) = 10
    # and ceil(64 ln(4096 / (2 pi)) / (2 ln 1e4)) = 23.
    i = torch.arange(32, dtype=torch.float64)
    extra = 1e4 ** (-2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    assert torch.allclose(inv, want, rtol=1e-6)
    assert torch.allclose(inv[:10], extra[:10], rtol=1e-6)
    assert torch.allclose(inv[23:], extra[23:] / 40, rtol=1e-6)
    assert torch.equal(dsv2.yarn_inv_freq(cfg), ref.yarn_inv_freq(cfg.to_dict()))
    plain = DeepseekV2Config(rope_scaling=None)
    assert dsv2.softmax_scale(plain) == pytest.approx(192 ** -0.5)
    assert torch.allclose(dsv2.yarn_inv_freq(plain).double(), extra, rtol=1e-6)


def test_rope_is_the_interleaved_rotate_half_of_the_published_code():
    x = torch.randn(5, 3, 16)
    pos = torch.arange(5)
    inv = torch.rand(8)
    freqs = pos.float()[:, None] * inv
    emb = torch.cat([freqs, freqs], -1)[:, None]
    xi = x.view(5, 3, 8, 2).transpose(-1, -2).reshape(5, 3, 16)
    want = xi * emb.cos() + ref.rotate_half(xi) * emb.sin()
    got = dsv2.apply_rope(x, freqs.cos()[:, None], freqs.sin()[:, None])
    assert torch.allclose(got, want, atol=1e-6)


def test_gating_is_a_float32_softmax_greedy_top_k_not_renormalised(lm32):
    layer = lm32.model.layers[2]
    h = torch.randn(7, 64)
    weight, idx = lm32.model.route(layer, h)
    probs = torch.softmax(h @ layer.gate.T, -1)
    assert weight.dtype == torch.float32
    assert torch.equal(idx.sort(-1).values, torch.topk(probs, 2).indices.sort(-1).values)
    assert torch.allclose(weight, torch.gather(probs, 1, idx))
    assert float(weight.sum(-1).max()) < 1.0


def test_the_expert_layer_is_the_routed_sum_plus_the_shared_expert(lm32):
    model, layer = lm32.model, lm32.model.layers[3]
    h = torch.randn(40, 64)
    weight, idx = model.route(layer, h)
    want = model.shared_experts(layer, h)
    for t in range(40):
        for j in range(2):
            e = int(idx[t, j])
            up = h[t] @ layer.w13[e]
            want[t] += weight[t, j] * (torch.nn.functional.silu(up[:32]) * up[32:]) @ layer.w2[e]
    assert torch.allclose(model._moe(layer, h), want, atol=1e-6)
    # Chunked as the prefill runs it, the same.
    real = dsv2.MOE_CHUNK
    try:
        dsv2.MOE_CHUNK = 7
        assert torch.allclose(model._moe(layer, h), want, atol=1e-6)
    finally:
        dsv2.MOE_CHUNK = real


def _scored(lm, prompts, seed=5, max_tokens=8, rows=None):
    n = len(prompts)
    if rows is not None:
        lm.capture = Capture(rows)
    try:
        out = lm.generate_batch_scored(prompts, [0.8] * n, [0.9] * n, max_tokens, seed)
    finally:
        cap, lm.capture = lm.capture, None
    return out, cap


def test_a_deduplicated_prefill_equals_one_prefill_a_row(lm32):
    # The same ids under three texts: three prompts, one slot each.
    shared, cap_a = _scored(lm32, ["10 20 30 40 hello"] * 3, rows=[0, 1, 2])
    apart, cap_b = _scored(lm32, ["10 20 30 40 hello", " 10 20 30 40 hello",
                                  "10  20 30 40 hello"], rows=[0, 1, 2])
    assert lm32.last_stats["prompts"] == 3 and lm32.last_stats["group"] == 1
    assert shared[0] == apart[0]
    assert np.allclose(shared[1], apart[1], atol=1e-5)
    for a, b in zip(cap_a.out["rows"], cap_b.out["rows"]):
        assert torch.allclose(a["logits"], b["logits"], atol=1e-5)


def test_ragged_prompts_decode_as_they_would_alone(lm32):
    prompts = ["1 2 3", "4 5 6 7 8 9 10 11 12", "13 14 15 16 17"]
    _, together = _scored(lm32, prompts, rows=[0, 1, 2])
    assert lm32.last_stats["prompt_lens"] == [4, 10, 6]
    for i, p in enumerate(prompts):
        _, alone = _scored(lm32, [p], rows=[0])
        a, b = together.out["rows"][i], alone.out["rows"][0]
        assert a["prompt"] == b["prompt"] and len(a["routes"]) == 3
        n = min(len(a["generated"]), len(b["generated"]))
        # Sampling draws differ with the batch; the first token's logits do not.
        assert torch.allclose(a["logits"][0], b["logits"][0], atol=1e-5)
        assert n >= 1


def test_the_capture_keeps_routes_for_every_fed_position(lm32):
    _, cap = _scored(lm32, ["7 8 9", "7 8 9", "1 2"], rows=[1, 2], max_tokens=5)
    for row in cap.out["rows"]:
        n = len(row["generated"])
        assert row["logits"].shape == (n, 512)
        assert all(r.shape == (len(row["prompt"]) + n - 1, 2) for r in row["routes"])
        fed = (len(row["prompt"]) + n - 1, 64)
        assert len(row["attn_in"]) == len(row["attn_out"]) == 4
        assert all(t.shape == fed for t in row["attn_in"] + row["attn_out"])
    assert lm32.model.attn_log is None and lm32.model.route_log is None


def test_the_captured_attention_is_the_references_on_the_captured_input(lm32, ref_weights):
    """Each layer's attention output, kept through the prefill and the
    absorbed decode, is the reference's causal attention over the layer's
    kept input, to float32 rounding; rows that share a prompt included."""
    cfg, w = ref_weights
    _, cap = _scored(lm32, ["3 1 4 1 5 9", "2 6", "3 1 4 1 5 9"], rows=[2, 0, 1],
                     max_tokens=7)
    for row in cap.out["rows"]:
        for i, (x, got) in enumerate(zip(row["attn_in"], row["attn_out"])):
            want = ref.attention(w, f"model.layers.{i}.self_attn.", x, cfg)
            err = (got - want).abs().amax(-1) / want.pow(2).mean(-1).sqrt()
            assert float(err.max()) < 1e-4, (i, float(err.max()))


def test_mc_confidence_runs_end_to_end_on_the_generator(lm32):
    mc = MCDropoutConfidence(lm32, n_samples=4, max_tokens=6, seed=3, device="cpu")
    res = mc.get_confidence_batch("Answer the question.", ["1 2 3 4", "5 6 7"],
                                  ["what 1", "why 5"])
    assert len(res) == 2
    assert lm32.last_stats["rows"] == 8 and lm32.last_stats["prompts"] == 2
    for r in res:
        assert len(r.answers) == 4 and 0.0 <= r.confidence <= 1.0
        assert r.metadata["sample_lp_mean"] < 0


def test_the_word_tokenizer_round_trips_decimal_words():
    tok = WordTokenizer()
    text = "0 7 42 99999 12345"
    ids = tok.encode(text)
    assert ids[0] == tok.bos == 100000 and ids[1:] == [0, 7, 42, 99999, 12345]
    assert tok.decode(ids + [tok.eos, 5]) == text
    other = tok.encode("hello 100000 007 world")[1:]
    assert all(0 <= i < 100000 for i in other) and other[2] == 7
    assert other == WordTokenizer().encode("hello 100000 007 world")[1:]
    assert other != WordTokenizer(seed=1).encode("hello 100000 007 world")[1:]
    assert WordTokenizer(510).encode("509 510")[1:] == [509, WordTokenizer(510).word_id("510")]


def test_the_reference_imports_neither_the_port_nor_jax_and_its_copies_match():
    tree = ast.parse(REF_PATH.read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "math", "zlib", "typing", "torch"}, names
    assert REF_PATH.read_bytes() == (REPO / "benchmark/reference/deepseek_v2.py").read_bytes()
    code = (f"import importlib.util, sys\n"
            f"s = importlib.util.spec_from_file_location('r', {str(REF_PATH)!r})\n"
            "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rag_uq_tpu', 'rag_uq_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


# -- tracing ------------------------------------------------------------------------

GEN_TREE = {"generate": None, "generate.encode": "generate", "generate.prefill": "generate",
            "generate.fork": "generate", "generate.decode": "generate",
            "generate.readback": "generate"}


@pytest.fixture
def tracer():
    profiling.take()
    profiling.enable()
    yield
    profiling.disable()
    profiling.take()


def test_the_spans_nest_under_generate_and_the_counters_count_by_hand(lm32, tracer):
    prompts = ["1 2 3"] * 2 + ["4 5 6 7 8"] * 2
    lm32.generate_batch_scored(prompts, [0.8] * 4, [0.9] * 4, max_tokens=6, seed=1)
    seen = profiling.counters()
    rec = profiling.take()
    # ``counters`` reads them and leaves them; ``take`` clears them.
    assert seen == rec["counters"] and profiling.counters() == {}
    by_id = {s.id: s for s in rec["spans"]}
    names = {s.name: s for s in rec["spans"]}
    assert set(names) == set(GEN_TREE)
    for s in rec["spans"]:
        parent = GEN_TREE[s.name]
        assert (by_id[s.parent].name if s.parent else None) == parent
        assert s.root == names["generate"].id and s.cuda_ms is None
    assert names["generate"].n == 4 and names["generate.prefill"].n == 4 + 6
    assert names["generate.decode"].n == 5
    # Two prompts of 4 and 6 ids (BOS and the words), two rows each, 5 steps:
    # decode step t attends over the prompt and t + 1 own positions.
    cache = 5 * (2 * 4 + 2 * 6) + 4 * (1 + 2 + 3 + 4 + 5)
    assert rec["counters"] == {
        "gen.rows": 4, "gen.prompts": 2, "gen.prefill_tokens": 10,
        "gen.prefill_pairs": 4 * 5 // 2 + 6 * 7 // 2, "gen.decode_steps": 5,
        "gen.decode_positions": 20, "gen.cache_positions": cache,
        "gen.tokens": lm32.last_stats["tokens"],
        # 3 expert layers, top-2: the prefill's 10 tokens and 5 steps of 4 slots.
        "moe.pairs": 3 * 2 * (10 + 5 * 4)}
    assert rec["dropped"] == 0


def test_off_the_generator_records_nothing(lm32, monkeypatch):
    profiling.disable()
    profiling.take()

    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened while the tracer was off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    lm32.generate_batch_scored(["1 2"], [0.8], [0.9], max_tokens=3, seed=1)
    rec = profiling.take()
    assert rec["spans"] == [] and rec["counters"] == {} and rec["dropped"] == 0


def test_layer_ranges_open_only_while_a_profiler_records(lm32, tracer):
    opened = []
    real = torch.profiler.record_function

    class Seen(real):
        def __init__(self, name, *args):
            opened.append(name)
            super().__init__(name, *args)

    torch.profiler.record_function = Seen
    try:
        lm32.generate_batch_scored(["1 2 3"], [0.8], [0.9], max_tokens=3, seed=1)
        assert "mla" not in opened and "moe" not in opened
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            lm32.generate_batch_scored(["1 2 3"], [0.8], [0.9], max_tokens=3, seed=1)
    finally:
        torch.profiler.record_function = real
    # 4 layers in the prefill and in each of 2 decode steps.
    assert opened.count("mla") == 12 and opened.count("moe") == 9 and opened.count("mlp") == 3
    assert {"mla", "moe", "generate.decode"} <= {e.name for e in prof.events()}


def test_a_traced_window_of_calls_drops_no_span(lm32, tracer):
    for i in range(20):
        lm32.generate_batch_scored(["1 2 3"] * 3, [0.8] * 3, [0.9] * 3, max_tokens=4, seed=i)
    rec = profiling.take()
    assert rec["dropped"] == 0 and len(rec["spans"]) == 20 * len(GEN_TREE)
