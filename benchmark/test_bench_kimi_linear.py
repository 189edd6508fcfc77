"""The ``kimilinear.mc_answer`` cell at toy widths on the CPU: a sound run is
correct, the control and each planted fault in the port's generator fail
its judge; the KDA rooflines' counts by hand. On a card (``chip``): the
cell's judge at the published widths, sound and under each planted fault,
on one deployment.

Each fault is planted in the port as a context manager over the generator
module, so that it acts on a model already drawn (the card's test draws
the published model once for all of them):

- ``decay_after_update``: the KDA state decayed after the delta update;
- ``beta_one``: beta = 1, whatever the gate;
- ``shared_state``: the slots of a prompt share slot 0's state;
- ``conv_shifted``: the prefill's convolution one input late;
- ``rope_in_mla``: rope applied to MLA's rope columns;
- ``bias_ignored``: the router chooses by score alone.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import run
from benchmark.metrics import _kda_roofline as kr
from benchmark.test_bench_cells import _small_root

ROOT = Path(__file__).resolve().parent.parent
CELL = "kimilinear.mc_answer"
CONFIG = "benchmark/configs/kimi-linear-48b-a3b.json"
TOY_WIDTHS = dict(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                  num_hidden_layers=5, num_attention_heads=2, num_experts=8,
                  num_experts_per_token=2, kv_lora_rank=32, qk_rope_head_dim=16,
                  qk_nope_head_dim=16, v_head_dim=16,
                  linear_attn_config={"kda_layers": [1, 2, 3, 5], "full_attn_layers": [4],
                                      "head_dim": 16, "num_heads": 2,
                                      "short_conv_kernel_size": 4},
                  expert_parallel={"experts": 32, "ranks": 4, "rank": 1})
SEEDS = (2**31 + 101, 7, 2**33 + 9)
# The toy's own limits, in float32 (as test_bench_mc_generator.py's).
TOY_LIMITS = dict(logit_err=1e-3, lp_err=1e-4, route_mismatch_share=0.01, attn_err=1e-3)


def _toy_root(tmp: Path) -> Path:
    root = _small_root(tmp)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs/kimi-linear-48b-a3b.json").read_text())
    cfg.update(TOY_WIDTHS, retrieval="small-hybrid", dtype="float32")
    cfg["check"]["limits"].update(TOY_LIMITS)
    (bench / "configs/kimi-linear-48b-a3b.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic/fiqa_mc_answer_kda.json").read_text())
    mix.update(questions=4, samples=3, max_tokens=16, top_k=2, batches=2, judged_questions=3,
               judged_doubles=1)
    (bench / "traffic/fiqa_mc_answer_kda.json").write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_root(tmp_path_factory.mktemp("checkout"))


def _run(root, trace=False, control=False, seed=SEEDS[0], seconds=0.5):
    return run.run_cell(CELL, seed, seconds, trace, device="cpu", root=root, control=control,
                        t_origin=time.perf_counter())


# -- the planted faults ----------------------------------------------------------------

def _faulty_recurrence(decay_after: bool, beta_one: bool):
    """(a prefill recurrence, a decode step) with the fault, in plain torch."""
    from rag_uq_tpu_torch.ops import kda

    def step(s, q, k, v, g, beta):
        beta = torch.ones_like(beta) if beta_one else beta
        if not decay_after:
            s = s * g.exp()[..., None]
        u = beta[..., None] * (v - torch.einsum("...k,...kv->...v", k, s))
        s = s + k[..., None] * u[..., None, :]
        if decay_after:
            s = s * g.exp()[..., None]
        return s, torch.einsum("...k,...kv->...v", q, s)

    def prefill(q, k, v, g, beta, chunk=kda.CHUNK):
        s = q.new_zeros((q.shape[0], q.shape[-1], v.shape[-1]))
        outs = []
        for t in range(q.shape[1]):
            # Padding past a prompt (beta 0 and g 0) stays inert.
            pad = (beta[:, t] == 0)[:, None, None]
            s_new, o = step(s, q[:, t], k[:, t], v[:, t], g[:, t], beta[:, t])
            s = torch.where(pad, s, s_new)
            outs.append(o)
        return torch.stack(outs, 1), s

    def decode(x, tail, conv_w, f, a_log, dt_bias, beta, gate, norm_w, state, eps):
        s, h, kd = state.shape[0], a_log.shape[0], state.shape[-1]
        window = torch.cat([tail, x[:, None]], dim=1)
        c = kda.short_conv(window, conv_w).view(s, 3, h, kd)
        tail.copy_(window[:, 1:])
        q, k, v = kda.l2norm(c[:, 0]) * kd ** -0.5, kda.l2norm(c[:, 1]), c[:, 2]
        g = kda.kda_gate(f.view(s, h, kd), a_log, dt_bias.view(h, kd))
        st, o = step(state, q, k, v, g, torch.sigmoid(beta.float()))
        state.copy_(st)
        return kda.gated_norm(o, norm_w, gate.view(s, h, kd), eps).reshape(s, h * kd).to(
            x.dtype)

    return prefill, decode


def _recurrence_fault(name: str, decay_after: bool, beta_one: bool):
    @contextlib.contextmanager
    def fault(kl, model):
        prefill, decode = _faulty_recurrence(decay_after, beta_one)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kl.kda, "kda_chunked", prefill)
            mp.setattr(kl.kda, "kda_decode", decode)
            yield

    fault.__name__ = name
    return fault


decay_after_update = _recurrence_fault("decay_after_update", True, False)
beta_one = _recurrence_fault("beta_one", False, True)


@contextlib.contextmanager
def shared_state(kl, model):
    real = kl.KimiLinearModel._kda_decode

    def decode(self, layer, h, cache):
        out = real(self, layer, h, cache)
        st = cache.state[layer.slot]
        per = st.view(-1, cache.group, *st.shape[1:])
        per[:, 1:] = per[:, :1]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kl.KimiLinearModel, "_kda_decode", decode)
        yield


@contextlib.contextmanager
def conv_shifted(kl, model):
    real = kl.kda.conv_prefill
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kl.kda, "conv_prefill",
                   lambda xpad, w: real(F.pad(xpad, (0, 0, 1, 0))[:, :-1], w))
        yield


@contextlib.contextmanager
def rope_in_mla(kl, model):
    prefill, decode = kl.KimiLinearModel._attn_prefill, kl.KimiLinearModel._attn_decode

    def roped_prefill(self, layer, h, cos, sin, pack, cache):
        return prefill(self, layer, h, *self.rope(pack["pos"]), pack, cache)

    def roped_decode(self, layer, i, h, cos, sin, cache, t):
        pos = cache.lens.repeat_interleave(cache.group) + t
        return decode(self, layer, i, h, *self.rope(pos), cache, t)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kl.KimiLinearModel, "_attn_prefill", roped_prefill)
        mp.setattr(kl.KimiLinearModel, "_attn_decode", roped_decode)
        yield


@contextlib.contextmanager
def bias_ignored(kl, model):
    kept = [(layer, layer.score_bias.clone()) for layer in model.layers if layer.moe]
    for layer, _ in kept:
        layer.score_bias.zero_()
    try:
        yield
    finally:
        for layer, bias in kept:
            layer.score_bias.copy_(bias)


FAULTS = [decay_after_update, beta_one, shared_state, conv_shifted, rope_in_mla, bias_ignored]
ATTENTION_FAULTS = (decay_after_update, beta_one, shared_state, conv_shifted, rope_in_mla)


# -- on the CPU ------------------------------------------------------------------------

def test_a_sound_run_is_correct_and_the_control_is_not(toy):
    out = _run(toy, control=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"batch_qps", "setup_s"}
    assert out["metrics"]["batch_qps"]["value"] > 0 and out["failed"] == 0
    assert out["_extra"]["judged_rows"] == 4
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    control = {k[len("control."):]: v for k, v in out["_extra"].items()
               if k.startswith("control.")}
    assert any(control[k] > limits[k] for k in control if k in limits), control


@pytest.mark.parametrize("seed", SEEDS[1:])
def test_sound_runs_on_other_seeds_are_correct(toy, seed):
    out = _run(toy, seed=seed)
    assert out["correct"], out["checks"]


def test_a_traced_run_reads_the_program_counters(toy):
    out = _run(toy, trace=True)
    assert out["correct"], out["checks"]
    # Without a card: no CUDA events and no device trace, so only the MFU.
    assert set(out["metrics"]) == {"gen_mfu.mc_answer_kda"}
    assert out["metrics"]["gen_mfu.mc_answer_kda"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_fails_the_judge(toy, monkeypatch, fault):
    from rag_uq_tpu_torch.llm import kimi_linear as kl

    real = kl.KimiLinearLM.__init__
    stack = contextlib.ExitStack()

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        stack.enter_context(fault(kl, self.model))

    monkeypatch.setattr(kl.KimiLinearLM, "__init__", init)
    with stack:
        out = _run(toy)
    assert not out["correct"], out["checks"]
    if fault in ATTENTION_FAULTS:
        # A fault inside attention fails the attention's own comparison.
        assert out["checks"]["attn_err"]["value"] > out["checks"]["attn_err"]["limit"]


def test_the_kda_rooflines_count_by_hand():
    cfg = json.loads((ROOT / CONFIG).read_text())
    peaks = {"bf16_flops": 1e15, "hbm_bytes_per_s": 1e12}
    # q, k, v 3 x 4096 x 2304; f_a, g_a 2 x 128 x 2304; b 32 x 2304; f_b, g_b
    # 2 x 4096 x 128; o_proj 2304 x 4096.
    proj = 3 * 4096 * 2304 + 2 * 128 * 2304 + 32 * 2304 + 2 * 4096 * 128 + 2304 * 4096
    assert kr.kda_proj_params(cfg) == proj
    assert kr.layer_counts(cfg) == {"kda": 20, "mla": 7, "moe": 26, "dense": 1}
    weights = 2 * (proj + 3 * 4096 * 4 + 128) + 4 * (32 + 4096)
    state, tail = 4 * 32 * 128 * 128, 2 * 3 * 3 * 4096
    per_token = 2 * proj + 7 * 32 * 128 * 128
    # One prompt of 3 tokens, 2 rows, 1 decode step: both bound by bytes.
    prefill = max(per_token * 3 / 1e15, (weights + 2 * 2 * 3 * 2304 + state + tail) / 1e12)
    step = max(per_token * 2 / 1e15, (weights + 2 * 2 * 2 * 2304 + 2 * 2 * (state + tail)) / 1e12)
    assert kr.kda_least_s(cfg, [3], 2, 1, peaks) == pytest.approx(20 * (prefill + step))
    # The kernel at 320 rows: 1.405 GB a launch, 0.419 ms at 3.35 TB/s.
    one = 320 * (2 * state + 2 * (3 * 4096 + 2 * 3 * 3 * 4096 + 3 * 4096 + 32)) \
        + 2 * (3 * 4096 * 4 + 128) + 4 * (4096 + 32)
    assert kr.kernel_bytes(cfg, 320) == one
    assert kr.kernel_least_s(cfg, 320, 1, {"hbm_bytes_per_s": 3.35e12}) == pytest.approx(
        4.1947e-4, rel=1e-4)
    # MFU's operations: 3 prompt tokens and 2 decode positions, 6 causal
    # pairs, 8 cached positions, 10 local token-expert pairs.
    counters = {"kda.prefill_tokens": 3, "gen.prefill_pairs": 6, "gen.prompts": 1,
                "gen.decode_positions": 2, "gen.cache_positions": 8, "moe.local_pairs": 10}
    mla = 32 * 192 * 2304 + 576 * 2304 + 32 * 256 * 512 + 2304 * 4096
    expert = 3 * 2304 * 1024
    linear = 2 * (20 * proj + 7 * mla + 3 * 2304 * 9216 + 26 * (2304 * 256 + expert))
    linear += 20 * 7 * 32 * 128 * 128
    attn = 7 * 2 * 32 * (320 * 6 + 1088 * 8)
    assert kr.model_ops(cfg, counters) == pytest.approx(
        linear * 5 + 2 * expert * 10 + 2 * 2304 * 163840 * 3 + attn)


def test_the_new_readers_read_nothing_from_an_empty_context():
    bench = ROOT / "benchmark"
    for name in ("kda_roofline", "kda_kernel_roofline", "gen_mfu"):
        assert run.load_reader(bench, f"{name}.mc_answer_kda")({}) is None, name
    profile = {"range_s": {"kda": 0.5}, "kda_kernel_s": 0.25, "kda_kernel_launches": 40,
               "call": {"prompt_lens": [3], "group": 2, "steps": 1, "prompts": 1}}
    cfg = json.loads((ROOT / CONFIG).read_text())
    from benchmark.metrics._common import PEAKS

    got = run.load_reader(bench, "kda_kernel_roofline.mc_answer_kda")(
        {"profile": profile, "model": cfg})
    assert got == pytest.approx(100 * kr.kernel_least_s(cfg, 2, 40, PEAKS) / 0.25)
    got = run.load_reader(bench, "kda_roofline.mc_answer_kda")({"profile": profile,
                                                                "model": cfg})
    assert got == pytest.approx(100 * kr.kda_least_s(cfg, [3], 2, 1, PEAKS) / 0.5)


def test_the_benchmark_files_the_cell_found_are_unchanged():
    """Every file under ``benchmark/`` in the commit before the one that
    added the cell is byte for byte as it is now."""
    def blob(rev, path):
        return subprocess.run(["git", "show", f"{rev}:{path}"], cwd=ROOT, capture_output=True)

    log = subprocess.run(["git", "log", "--format=%H", "--diff-filter=A", "--", CONFIG],
                         cwd=ROOT, capture_output=True, text=True)
    if log.returncode:
        pytest.skip("no git history")
    added = log.stdout.split()
    parent = f"{added[-1]}^" if added else "HEAD"
    listed = subprocess.run(["git", "ls-tree", "-r", "--name-only", parent, "benchmark"],
                            cwd=ROOT, capture_output=True, text=True).stdout.split()
    assert listed
    for path in listed:
        now = (ROOT / path).read_bytes()
        assert hashlib.sha256(now).digest() == hashlib.sha256(blob(parent, path).stdout).digest(), \
            path


# -- on the card -----------------------------------------------------------------------

def judge_faults(seed: int, seconds: float = 3.0, faults=FAULTS):
    """The cell at its published widths on the card, drawn once: a short
    window, then the judged call and the judge, sound and under each fault.
    Yields (name, the compared numbers, correct)."""
    from rag_uq_tpu_torch.llm import kimi_linear as kl

    s = run.load_spec(ROOT, CELL)
    cfg, traffic = s["cfg"], s["traffic"]
    kind = run.load_kind(s["bench"], cfg["kind"])
    mode_class = run.load_mode(s["bench"], traffic["mode"])
    inputs = kind.make_inputs(cfg, seed, "cuda")
    dep = kind.build(cfg, inputs, seed, "cuda")
    mode = mode_class(dep, cfg, traffic, seed, "cuda")
    mode.warm()
    for fault in [None] + list(faults):
        stack = contextlib.ExitStack()
        if fault is not None:
            stack.enter_context(fault(kl, dep.lm.model))
        with stack:
            m = mode_class(dep, cfg, traffic, seed, "cuda")
            judged = m.release()
        torch.cuda.empty_cache()
        checks, extra = kind.judge(cfg, inputs, judged, "cuda", False)
        numbers = {k: v["value"] for k, v in checks.items()}
        yield (fault.__name__ if fault else "sound", numbers,
               all(c["value"] <= c["limit"] for c in checks.values()))


@pytest.mark.chip
def test_the_planted_faults_fail_the_judge_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, numbers, correct in judge_faults(2**31 + 443):
        print(name, json.dumps(numbers), correct, flush=True)
        assert correct == (name == "sound"), (name, numbers)
