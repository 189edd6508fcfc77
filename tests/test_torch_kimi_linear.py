"""The port's Kimi Linear generator (``rag_uq_tpu_torch/llm/kimi_linear.py``)
and its KDA operations (``ops/kda.py``) against the plain reference
(``tests/kimi_linear_reference.py``) at a tiny configuration on the CPU:
one dense KDA layer, KDA and MLA layers, 32 routed experts of which the
chip holds 8 (rank 1 of four), with weights drawn from seeds by name.

In float32 the port's chunked prefill and its cached decode (the KDA
states forked to each slot, the latents shared) agree with the reference's
token-by-token forward pass to float32 rounding: the chunked form, the
absorbed latent attention and the padding change only the order of sums,
2e-5 of the logits' largest value. Each operation's own tolerance is stated
beside it.

On a card (marked ``chip``, skipped without one; the file imports no JAX,
so it runs there with ``python3 -m pytest tests/test_torch_kimi_linear.py
--noconftest -m chip``): the KDA decode kernel against its twin and float64
at the cell's shape and at edges, the KDA prefill kernel against the
recurrence in float64 and the chunked form in float32 at the cell's shape
and at edges, the latent-attention kernel at 32 heads, and a small model on
the card against the reference.
"""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from rag_uq_tpu_torch.llm import kimi_linear as kl
from rag_uq_tpu_torch.llm.deepseek_v2 import Capture
from rag_uq_tpu_torch.llm.kimi_linear import KimiLinearConfig, KimiLinearLM
from rag_uq_tpu_torch.ops import kda
from rag_uq_tpu_torch.uq.mc import MCDropoutConfidence
from rag_uq_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
REF_PATH = REPO / "tests" / "kimi_linear_reference.py"
_spec = importlib.util.spec_from_file_location("kimi_linear_reference", REF_PATH)
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

LINEAR = {"kda_layers": [1, 2, 3, 5], "full_attn_layers": [4], "head_dim": 16, "num_heads": 2,
          "short_conv_kernel_size": 4}
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=5, num_attention_heads=2, num_experts=8,
            num_experts_per_token=2, kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=16,
            v_head_dim=16, linear_attn_config=LINEAR,
            expert_parallel={"experts": 32, "ranks": 4, "rank": 1})
SEED = 2**31 + 23
STD, BIAS_STD = 0.02, 0.05
# Float32 rounding, relative to the logits' largest magnitude.
F32_TOL = 2e-5


def _lm(dtype="float32", **over):
    return KimiLinearLM(KimiLinearConfig(**{**TINY, **over}, dtype=dtype), seed=SEED,
                        device="cpu")


@pytest.fixture(scope="module")
def lm32():
    return _lm()


@pytest.fixture(scope="module")
def ref_weights(lm32):
    cfg = lm32.config.to_dict()
    return cfg, ref.weights(ref.published_shapes(cfg), ref.tensor_seeds(cfg, SEED), STD,
                            BIAS_STD, "cpu", storage=torch.float32)


def _ids(n, seed=0):
    return torch.randint(0, 510, (n,), generator=torch.Generator().manual_seed(seed))


def test_the_drawn_weights_are_the_references_by_published_name(lm32, ref_weights):
    cfg, w = ref_weights
    names = [n for n, _ in lm32.model.published()]
    assert sorted(names) == sorted(w) and len(names) == len(set(names))
    for name, t in lm32.model.published():
        assert torch.equal(t.float(), w[name]), name
    assert lm32.model.num_params() == sum(t.numel() for t in w.values())
    # Rank 1 holds experts 8-15 of the 32 the router scores.
    assert "model.layers.1.block_sparse_moe.experts.8.w1.weight" in w
    assert "model.layers.1.block_sparse_moe.experts.7.w1.weight" not in w
    assert w["model.layers.1.block_sparse_moe.gate.weight"].shape == (32, 64)
    assert lm32.model.held == (8, 8)


def test_the_published_config_is_the_catalogs():
    cfg = KimiLinearConfig()
    assert [cfg.is_kda(i) for i in range(27)].count(True) == 20
    assert [i + 1 for i in range(27) if not cfg.is_kda(i)] == [4, 8, 12, 16, 20, 24, 27]
    assert not cfg.is_moe(0) and all(cfg.is_moe(i) for i in range(1, 27))
    assert cfg.routed_experts == 256 and cfg.latent_dim == 576 and cfg.qk_head_dim == 192
    assert kl.KimiLinearModel.LAYER is kl._KimiLayer
    with pytest.raises(NotImplementedError):
        KimiLinearConfig(mla_use_nope=False)
    with pytest.raises(ValueError):
        KimiLinearConfig(num_experts=48, expert_parallel={"experts": 256, "ranks": 4, "rank": 0})


def test_prefill_then_decode_through_both_caches_matches_the_reference(lm32, ref_weights):
    cfg, w = ref_weights
    ids = _ids(40)
    want, _ = ref.forward(w, ids, cfg)
    scale = float(want.abs().max())
    # Two prompts of different lengths, the judged one padded to neither.
    logits, cache = lm32.model.prefill([ids[:25], ids[:9]])
    assert float((logits[0] - want[24]).abs().max()) / scale < F32_TOL
    cache.fork(1, 15)
    for t in range(15):
        tok = torch.stack([ids[25 + t], ids[9 + t]])
        got = lm32.model.decode_step(tok, None, cache, t)
        assert float((got[0] - want[25 + t]).abs().max()) / scale < F32_TOL, t
        assert float((got[1] - want[9 + t]).abs().max()) / scale < F32_TOL, t


def test_bfloat16_stays_near_the_float32_reference(ref_weights):
    cfg, _ = ref_weights
    lm = _lm("bfloat16")
    w = ref.weights(ref.published_shapes(cfg), ref.tensor_seeds(cfg, SEED), STD, BIAS_STD, "cpu")
    ids = _ids(24, seed=2)
    want, _ = ref.forward(w, ids, cfg)
    logits, cache = lm.model.prefill([ids[:16]])
    cache.fork(1, 8)
    got = [logits[0]]
    for t in range(7):
        got.append(lm.model.decode_step(ids[16 + t : 17 + t], None, cache, t)[0])
    # bf16 rounding of activations, shared weights: a few percent of the largest logit.
    err = (torch.stack(got) - want[15:23]).abs().max() / want.abs().max()
    assert 0 < err < 0.05


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_the_chunked_recurrence_is_the_token_recurrence(chunk):
    g = torch.Generator().manual_seed(chunk)
    b, t, k, v = 3, 37, 16, 8
    q = kda.l2norm(torch.randn(b, t, k, generator=g)) * k ** -0.5
    kk = kda.l2norm(torch.randn(b, t, k, generator=g))
    vv = torch.randn(b, t, v, generator=g)
    # Decays from none to strong (exp(-8) a token), as the initialisers allow.
    gate = -torch.rand(b, t, k, generator=g) * 8
    beta = torch.rand(b, t, generator=g)
    want, s_want = kda.kda_recurrent(q, kk, vv, gate, beta)
    got, s_got = kda.kda_chunked(q, kk, vv, gate, beta, chunk=chunk)
    # Float32 sums in another order: 1e-5 of values of order 1.
    assert torch.allclose(got, want, atol=1e-5) and torch.allclose(s_got, s_want, atol=1e-5)
    # Padding with g = 0 and beta = 0 leaves the end state where it was,
    # whatever q, k and v the padded positions hold.
    pad = lambda x, value: torch.cat([x, torch.full_like(x[:, :7], value)], 1)
    _, s_pad = kda.kda_chunked(pad(q, 0.2), pad(kk, 0.3), pad(vv, 1.0), pad(gate, 0.0),
                               pad(beta, 0.0), chunk=chunk)
    assert torch.allclose(s_pad, s_want, atol=1e-5)


def _prefill_args(b=3, t=37, kd=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = kda.l2norm(torch.randn(b, t, kd, generator=g)) * kd ** -0.5
    k = kda.l2norm(torch.randn(b, t, kd, generator=g))
    return (q, k, torch.randn(b, t, kd, generator=g), -torch.rand(b, t, kd, generator=g) * 8,
            torch.rand(b, t, generator=g))


@pytest.mark.parametrize("chunk", [5, kda.CHUNK])
def test_the_prefill_dispatch_on_the_cpu_is_the_chunked_form_bit_for_bit(chunk):
    args = _prefill_args(t=70, seed=chunk)
    launches = kda.cuda_kda_prefill.launches
    got, s_got = kda.kda_chunked(*args, chunk=chunk)
    want, s_want = kda.kda_chunked_plain(*args, chunk=chunk)
    assert torch.equal(got, want) and torch.equal(s_got, s_want)
    assert kda.cuda_kda_prefill.launches == launches


def test_the_token_recurrence_runs_in_float64_for_float64_inputs():
    args = _prefill_args(seed=3)
    o64, s64 = kda.kda_recurrent(*(x.double() for x in args))
    o32, s32 = kda.kda_recurrent(*args)
    assert o64.dtype == s64.dtype == torch.float64 and o32.dtype == torch.float32
    assert torch.allclose(o32.double(), o64, atol=1e-5) and not torch.equal(o32.double(), o64)


def _prefill_fault(name, args):
    q, k, v, g, beta = args
    if name == "float64":
        return q.double(), k, v, g, beta
    if name == "bfloat16_v":
        return q, k, v.bfloat16(), g, beta
    if name == "head_64":
        return tuple(x[..., :64].contiguous() for x in args[:4]) + (beta,)
    if name == "not_contiguous":
        return q, k.transpose(0, 1).contiguous().transpose(0, 1), v, g, beta
    if name == "v_shape":
        return q, k, v[:, :-1], g, beta
    if name == "beta_shape":
        return q, k, v, g, beta[:, :-1]
    return args  # "cpu": every check passes but the device's


@pytest.mark.parametrize("fault,error", [
    ("cpu", ValueError), ("float64", TypeError), ("bfloat16_v", TypeError),
    ("head_64", ValueError), ("not_contiguous", ValueError), ("v_shape", ValueError),
    ("beta_shape", ValueError)])
def test_the_prefill_kernel_wrapper_refuses_before_any_launch(fault, error):
    """The kernel takes float32, contiguous q, k, v, g [B, T, 128] and beta
    [B, T] on a CUDA device; anything else raises before a launch."""
    args = _prefill_fault(fault, _prefill_args(b=2, t=9, kd=kda.HEAD, seed=1))
    launches = kda.cuda_kda_prefill.launches
    profiling.take()
    profiling.enable()
    try:
        with pytest.raises(error):
            kda.cuda_kda_prefill(*args)
    finally:
        profiling.disable()
    assert kda.cuda_kda_prefill.launches == launches
    assert "kda.prefill_kernel" not in profiling.take()["counters"]


def _decode_inputs(rows, heads, kd, seed):
    g = torch.Generator().manual_seed(seed)
    hk = heads * kd
    return dict(conv_w=torch.rand(3 * hk, kda.TAPS, generator=g) - 0.5,
                f=torch.randn(rows, hk, generator=g) * 0.3,
                a_log=torch.log(torch.rand(heads, generator=g) * 15 + 1),
                dt_bias=torch.randn(hk, generator=g) - 4,
                beta=torch.randn(rows, heads, generator=g), gate=torch.randn(rows, hk, generator=g),
                norm_w=1 + 0.1 * torch.randn(kd, generator=g))


def test_the_decode_twin_steps_the_recurrence_of_the_convolved_sequence():
    """Steps of ``kda_decode_plain`` from a zero state and tail are the
    convolution over the whole sequence, the norms and gates, then
    ``kda_recurrent`` and the gated norm; and the float64 step agrees."""
    rows, heads, kd, steps = 2, 2, 16, 9
    a = _decode_inputs(rows, heads, kd, 4)
    xs = torch.randn(steps, rows, 3 * heads * kd, generator=torch.Generator().manual_seed(5))
    tail = torch.zeros(rows, kda.TAPS - 1, 3 * heads * kd)
    state = torch.zeros(rows, heads, kd, kd)
    outs = []
    for t in range(steps):
        f64_out, f64_state = kda.kda_decode_f64(xs[t], tail, a["conv_w"], a["f"], a["a_log"],
                                                a["dt_bias"], a["beta"], a["gate"], a["norm_w"],
                                                state, 1e-5)
        outs.append(kda.kda_decode_plain(xs[t], tail, a["conv_w"], a["f"], a["a_log"],
                                         a["dt_bias"], a["beta"], a["gate"], a["norm_w"], state,
                                         1e-5))
        assert torch.allclose(outs[-1].double(), f64_out, atol=1e-5)
        assert torch.allclose(state.double(), f64_state, atol=1e-6)
    assert torch.equal(tail, xs[-(kda.TAPS - 1):].transpose(0, 1))
    # The same sequence at once.
    xpad = F.pad(xs.transpose(0, 1), (0, 0, kda.TAPS - 1, 0))
    c = kda.conv_prefill(xpad, a["conv_w"]).view(rows, steps, 3, heads, kd)
    by_head = lambda z: z.transpose(1, 2).reshape(rows * heads, steps, -1)
    g = kda.kda_gate(a["f"].view(rows, 1, heads, kd).expand(rows, steps, heads, kd), a["a_log"],
                     a["dt_bias"].view(heads, kd))
    beta = torch.sigmoid(a["beta"])[:, None, :, None].expand(rows, steps, heads, 1)
    o, s = kda.kda_recurrent(by_head(kda.l2norm(c[:, :, 0]) * kd ** -0.5),
                             by_head(kda.l2norm(c[:, :, 1])), by_head(c[:, :, 2]), by_head(g),
                             by_head(beta).squeeze(-1))
    o = o.view(rows, heads, steps, kd).transpose(1, 2)
    y = kda.gated_norm(o, a["norm_w"], a["gate"].view(rows, 1, heads, kd), 1e-5)
    assert torch.allclose(torch.stack(outs, 1), y.reshape(rows, steps, -1), atol=1e-5)
    assert torch.allclose(state, s.view(rows, heads, kd, kd), atol=1e-6)


def test_the_kernel_wrapper_refuses_a_cpu_tensor_and_the_dispatch_counts_bytes():
    a = _decode_inputs(1, 1, kda.HEAD, 0)
    x = torch.zeros(1, 3 * kda.HEAD)
    state = torch.zeros(1, 1, kda.HEAD, kda.HEAD)
    args = (x, torch.zeros(1, kda.TAPS - 1, 3 * kda.HEAD), a["conv_w"], a["f"], a["a_log"],
            a["dt_bias"], a["beta"], a["gate"], a["norm_w"], state, 1e-5)
    with pytest.raises(ValueError):
        kda.cuda_kda_decode(*args)
    profiling.take()
    profiling.enable()
    try:
        kda.kda_decode(*args)
    finally:
        profiling.disable()
    assert profiling.take()["counters"] == {"kda.state_bytes": 2 * 4 * kda.HEAD * kda.HEAD}


def _scored(lm, prompts, seed=5, max_tokens=8, rows=None):
    n = len(prompts)
    if rows is not None:
        lm.capture = Capture(rows)
    try:
        out = lm.generate_batch_scored(prompts, [0.8] * n, [0.9] * n, max_tokens, seed)
    finally:
        cap, lm.capture = lm.capture, None
    return out, cap


def test_forked_slots_decode_as_they_would_alone(lm32):
    """Three slots of one prompt, fed different tokens, each as a one-slot
    call fed the same: the states are copied, not shared."""
    ids = _ids(12, seed=3)
    feeds = _ids(3 * 6, seed=4).view(6, 3)
    _, cache = lm32.model.prefill([ids])
    cache.fork(3, 6)
    assert len({c.data_ptr() for c in cache.state}) == len(cache.state)
    together = [lm32.model.decode_step(feeds[t], None, cache, t) for t in range(6)]
    for s in range(3):
        _, alone = lm32.model.prefill([ids])
        alone.fork(1, 6)
        for t in range(6):
            got = lm32.model.decode_step(feeds[t, s : s + 1], None, alone, t)
            assert torch.allclose(got[0], together[t][s], atol=1e-5), (s, t)


def test_the_sigmoid_gate_chooses_by_score_plus_bias_and_weighs_by_score(lm32):
    model, layer = lm32.model, lm32.model.layers[2]
    h = torch.randn(64, 64, generator=torch.Generator().manual_seed(7))
    weight, idx = model.route(layer, h)
    scores = torch.sigmoid(h @ layer.gate.T)
    want = torch.topk(scores + layer.score_bias, 2).indices
    assert weight.dtype == torch.float32 and idx.shape == (64, 2)
    assert torch.equal(idx.sort(-1).values, want.sort(-1).values)
    raw = torch.gather(scores, 1, idx)
    assert torch.allclose(weight, raw / raw.sum(-1, keepdim=True) * 2.446, rtol=1e-6)
    # The bias moves the choice: by score alone, other sets.
    alone = torch.topk(scores, 2).indices.sort(-1).values
    assert (alone != idx.sort(-1).values).any(-1).float().mean() > 0.3


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Each of four ranks computes its own experts' pairs; their results,
    with the shared expert counted once, are the uncut reference layer's."""
    ranks = [KimiLinearLM(KimiLinearConfig(**{**TINY, "expert_parallel": {
        "experts": 32, "ranks": 4, "rank": r}}, dtype="float32"), seed=SEED, device="cpu")
        for r in range(4)]
    uncut = {**TINY, "num_experts": 32, "expert_parallel": None}
    cfg = KimiLinearConfig(**uncut).to_dict()
    p = "model.layers.3.block_sparse_moe."
    shapes = {k: v for k, v in ref.layer_shapes(cfg, 3).items() if k.startswith(p)}
    w = ref.weights(shapes, ref.tensor_seeds(cfg, SEED), STD, BIAS_STD, "cpu",
                    storage=torch.float32)
    h = torch.randn(50, 64, generator=torch.Generator().manual_seed(8))
    want, idx, _ = ref.moe(w, p, h, cfg)
    parts = [lm.model._moe(lm.model.layers[3], h) for lm in ranks]
    shared = ranks[0].model.shared_experts(ranks[0].model.layers[3], h)
    assert torch.allclose(sum(parts) - 3 * shared, want, atol=1e-6)
    # Each rank's routed part is its own experts' alone.
    routed = [part - shared for part in parts]
    assert all(float(r.abs().max()) > 0 for r in routed)
    assert sorted(int(e) for e in idx.unique()) != list(range(8))  # spread over the ranks


def test_mc_confidence_runs_end_to_end_on_the_generator(lm32):
    mc = MCDropoutConfidence(lm32, n_samples=4, max_tokens=6, seed=3, device="cpu")
    res = mc.get_confidence_batch("Answer the question.", ["1 2 3 4", "5 6 7"],
                                  ["what 1", "why 5"])
    assert len(res) == 2
    assert lm32.last_stats["rows"] == 8 and lm32.last_stats["prompts"] == 2
    for r in res:
        assert len(r.answers) == 4 and 0.0 <= r.confidence <= 1.0


def test_the_captured_attention_of_both_kinds_is_the_references(lm32, ref_weights):
    """Every layer's attention block, kept through the prefill and the
    decode (KDA states forked, latents shared), is the reference's over the
    layer's kept input, to float32 rounding; rows that share a prompt included."""
    cfg, w = ref_weights
    _, cap = _scored(lm32, ["3 1 4 1 5 9", "2 6", "3 1 4 1 5 9"], rows=[2, 0, 1],
                     max_tokens=7)
    for row in cap.out["rows"]:
        assert len(row["attn_in"]) == 5
        for i, (x, got) in enumerate(zip(row["attn_in"], row["attn_out"])):
            want = ref.attention(w, i, [x], cfg)[0]
            err = (got - want).abs().amax(-1) / want.pow(2).mean(-1).sqrt()
            assert float(err.max()) < 1e-4, (i, float(err.max()))


def test_the_reference_imports_neither_the_port_nor_jax_and_its_copies_match():
    tree = ast.parse(REF_PATH.read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "math", "zlib", "typing", "torch"}, names
    assert REF_PATH.read_bytes() == (REPO / "benchmark/reference/kimi_linear.py").read_bytes()
    code = (f"import importlib.util, sys\n"
            f"s = importlib.util.spec_from_file_location('r', {str(REF_PATH)!r})\n"
            "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rag_uq_tpu', 'rag_uq_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


# -- tracing ------------------------------------------------------------------------

@pytest.fixture
def tracer():
    profiling.take()
    profiling.enable()
    yield
    profiling.disable()
    profiling.take()


def test_the_kda_and_share_counters_count_by_hand(lm32, tracer):
    model = lm32.model
    model.route_log = []
    try:
        lm32.generate_batch_scored(["1 2 3"] * 2 + ["4 5 6 7 8"] * 2, [0.8] * 4, [0.9] * 4,
                                   max_tokens=6, seed=1)
        routes = model.route_log
    finally:
        model.route_log = None
    rec = profiling.take()
    c = rec["counters"]
    steps = lm32.last_stats["steps"]
    # Two prompts of 4 and 6 ids; 4 slots of 2 heads x 16 x 16 f32 states.
    assert c["kda.prefill_tokens"] == 10 and c["gen.decode_steps"] == steps == 5
    assert c["kda.state_bytes"] == 4 * steps * 2 * 4 * (2 * 16 * 16 * 4)
    assert "kda.decode_kernel" not in c  # the CPU runs the twin
    assert "kda.prefill_kernel" not in c  # and the chunked form
    # Every logged expert set of the 4 expert layers, prefill and steps:
    # the pairs in rank 1's experts 8-15.
    assert len(routes) == 4 * (1 + steps)
    assert c["moe.local_pairs"] == sum(int(((r >= 8) & (r < 16)).sum()) for r in routes)
    assert c["moe.pairs"] == 4 * 2 * (10 + steps * 4)
    names = {s.name for s in rec["spans"]}
    assert {"generate", "generate.prefill", "generate.fork", "generate.decode"} <= names


def test_the_kda_range_opens_only_while_a_profiler_records(lm32, tracer):
    opened = []
    real = torch.profiler.record_function

    class Seen(real):
        def __init__(self, name, *args):
            opened.append(name)
            super().__init__(name, *args)

    torch.profiler.record_function = Seen
    try:
        lm32.generate_batch_scored(["1 2 3"], [0.8], [0.9], max_tokens=3, seed=1)
        assert "kda" not in opened
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            lm32.generate_batch_scored(["1 2 3"], [0.8], [0.9], max_tokens=3, seed=1)
    finally:
        torch.profiler.record_function = real
    # 4 KDA and 1 MLA layer in the prefill and in each of 2 decode steps.
    assert opened.count("kda") == 12 and opened.count("mla") == 3
    assert opened.count("moe") == 12 and opened.count("mlp") == 3


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kda.build()
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("rows,heads", [(320, 32), (1, 32), (7, 2)])
def test_the_kda_kernel_matches_its_twin_and_float64(card, rows, heads):
    from rag_uq_tpu_torch.cli import profile_kda_decode as pk

    err = pk.errors(pk.inputs(rows, heads, rows + heads, card))
    # Both round the output to bf16 once: the kernel within 1.25x of the
    # twin's error, whose widest is one bf16 rounding (2^-8 of a value).
    assert err["kernel_err"] <= 1.25 * err["plain_err"] + 1e-6, err
    assert err["kernel_state_err"] < 1e-5 and err["tail_equal"], err


@pytest.mark.chip
@pytest.mark.parametrize("shape", ["cell", "one_sequence", "two_heads"])
def test_the_kda_prefill_kernel_matches_float64_and_the_chunked_form(card, shape):
    """At the cell's prefill (32 prompts of 1,100-1,400 positions padded to
    the longest, 32 heads: 1,024 sequences) and at edges: one sequence of 77
    positions, and 3 prompts x 2 heads of 45, 333 and 1,000 positions, both
    with decays up to exp(-8) a position. Then a padded tail (g = 0, beta =
    0) leaves the outputs and the end states bit for bit as they were."""
    from rag_uq_tpu_torch.cli import profile_kda_prefill as pp

    args = pp.case_inputs(shape, 11, card)
    launches = kda.cuda_kda_prefill.launches
    err = pp.errors(args)
    print(shape, err)
    assert kda.cuda_kda_prefill.launches == launches + 1
    assert err["kernel_err"] < kda.PREFILL_TOL and err["kernel_state_err"] < kda.PREFILL_TOL, err
    assert err["vs_plain_err"] < kda.PREFILL_TOL and err["vs_plain_state_err"] < kda.PREFILL_TOL
    assert pp.padded_tail_equal(args)


@pytest.mark.chip
def test_the_latent_attention_kernel_at_32_heads(card):
    from rag_uq_tpu_torch.cli import profile_mla_decode as pm
    from rag_uq_tpu_torch.ops import mla_decode as mla

    lens = pm.cell_lens(32, 3)
    for t in (0, 49, 98):
        args = (*pm.inputs(lens, 10, 32, 100, 3 + t, card), t, 10, 192 ** -0.5, mla.RANK)
        err = pm.errors(args)
        assert err["kernel_err"] <= mla.ERR_MARGIN * err["plain_err"], (t, err)


@pytest.mark.chip
def test_a_small_model_on_the_card_matches_the_reference(card):
    """Both kernels' widths (KDA heads of 128, latents of 512 + 64) and the
    share on the card, bf16."""
    over = dict(linear_attn_config={**LINEAR, "head_dim": 128}, hidden_size=256,
                kv_lora_rank=512, qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128)
    lm = KimiLinearLM(KimiLinearConfig(**{**TINY, **over}), seed=SEED, device=card)
    cfg = lm.config.to_dict()
    w = ref.weights(ref.published_shapes(cfg), ref.tensor_seeds(cfg, SEED), STD, BIAS_STD, card)
    ids = _ids(40, seed=9).to(card)
    want, _ = ref.forward(w, ids, cfg)
    logits, cache = lm.model.prefill([ids[:30]])
    cache.fork(2, 10)
    got = [logits[0]]
    launches = kda.cuda_kda_decode.launches
    for t in range(9):
        got.append(lm.model.decode_step(ids[30 + t : 31 + t].repeat(2), None, cache, t)[0])
    assert kda.cuda_kda_decode.launches - launches == 9 * 4
    prefills = kda.cuda_kda_prefill.launches
    lm.model.prefill([ids[:30], ids[:7]])
    assert kda.cuda_kda_prefill.launches - prefills == 4  # one a KDA layer
    err = (torch.stack(got) - want[29:39]).abs().max() / want.abs().max()
    assert err < 0.05, float(err)
