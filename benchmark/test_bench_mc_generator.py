"""The ``dsv2lite.mc_answer`` cell at toy widths on the CPU: a sound run is
correct, the control and each planted fault in the port's generator fail
its judge; the rooflines' counts by hand; and every benchmark file that
was there before the cell is as it was."""

from __future__ import annotations

import hashlib
import json
import subprocess
import time
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.metrics import _gen_roofline as gr
from benchmark.metrics._common import PEAKS
from benchmark.test_bench_cells import _small_root

ROOT = Path(__file__).resolve().parent.parent
CELL = "dsv2lite.mc_answer"
TOY_WIDTHS = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
                  moe_intermediate_size=32, num_hidden_layers=4, num_attention_heads=2,
                  num_key_value_heads=2, n_shared_experts=1, n_routed_experts=8,
                  num_experts_per_tok=2, kv_lora_rank=32, qk_rope_head_dim=16,
                  qk_nope_head_dim=16, v_head_dim=16)
SEEDS = (2**31 + 101, 7, 2**33 + 9)
# The toy's own limits (see PERF.md section 2 for their readings).
TOY_LIMITS = dict(logit_err=1e-3, lp_err=1e-4, route_mismatch_share=0.01, attn_err=1e-3)


def _toy_root(tmp: Path) -> Path:
    """A checkout whose ``dsv2lite.mc_answer`` runs the toy widths over the
    small retrieval deployment, with a short mix."""
    root = _small_root(tmp)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs/deepseek-v2-lite.json").read_text())
    # In float32, so that the judge sees float32 rounding alone: at toy
    # widths attention adds little to the residual stream, and a fault in it
    # (fp8 latents) moves the logits less than bfloat16's own rounding does.
    cfg.update(TOY_WIDTHS, retrieval="small-hybrid", dtype="float32")
    cfg["check"]["limits"].update(TOY_LIMITS)
    (bench / "configs/deepseek-v2-lite.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic/fiqa_mc_answer.json").read_text())
    mix.update(questions=4, samples=3, max_tokens=16, top_k=2, batches=2, judged_questions=3,
               judged_doubles=1)
    (bench / "traffic/fiqa_mc_answer.json").write_text(json.dumps(mix))
    return root


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return _toy_root(tmp_path_factory.mktemp("checkout"))


def _run(root, trace=False, control=False, seed=SEEDS[0], seconds=0.5):
    return run.run_cell(CELL, seed, seconds, trace, device="cpu", root=root, control=control,
                        t_origin=time.perf_counter())


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
    assert set(out["metrics"]) == {"gen_mfu.mc_answer"}
    assert out["metrics"]["gen_mfu.mc_answer"]["value"] > 0


def _skip_shared(dsv2, monkeypatch):
    monkeypatch.setattr(dsv2.DeepseekV2Model, "shared_experts",
                        lambda self, layer, h: torch.zeros_like(h))


def _no_mscale(dsv2, monkeypatch):
    monkeypatch.setattr(dsv2, "softmax_scale", lambda cfg: cfg.qk_head_dim ** -0.5)


def _top5(dsv2, monkeypatch):
    real = dsv2.DeepseekV2Model.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.top_k = self.config.num_experts_per_tok + 3

    monkeypatch.setattr(dsv2.DeepseekV2Model, "__init__", init)


def _cache_off_by_one(dsv2, monkeypatch):
    def store(gen, t, latent):
        gen[:, min(t + 1, gen.shape[1] - 1)] = latent

    monkeypatch.setattr(dsv2.DeepseekV2Model, "store_latent", staticmethod(store))


def _fp8_latents(dsv2, monkeypatch):
    fp8 = lambda x: x.to(torch.float8_e4m3fn).to(x.dtype)
    model = dsv2.DeepseekV2Model
    real, real_prompt = model.store_latent, model.store_prompt_latents
    monkeypatch.setattr(model, "store_latent", staticmethod(
        lambda gen, t, latent: real(gen, t, fp8(latent))))
    monkeypatch.setattr(model, "store_prompt_latents", staticmethod(
        lambda cache, flat, latent: real_prompt(cache, flat, fp8(latent))))


@pytest.mark.parametrize("fault", [_skip_shared, _no_mscale, _top5, _cache_off_by_one,
                                   _fp8_latents])
def test_a_planted_fault_fails_the_judge(toy, monkeypatch, fault):
    from rag_uq_tpu_torch.llm import deepseek_v2 as dsv2

    fault(dsv2, monkeypatch)
    out = _run(toy)
    assert not out["correct"], out["checks"]
    if fault in (_no_mscale, _cache_off_by_one, _fp8_latents):
        # A fault inside attention fails the attention's own comparison.
        assert out["checks"]["attn_err"]["value"] > out["checks"]["attn_err"]["limit"]


def test_the_rooflines_count_by_hand():
    cfg = json.loads((ROOT / "benchmark/configs/deepseek-v2-lite.json").read_text())
    peaks = {"bf16_flops": 1e15, "hbm_bytes_per_s": 1e12}
    # Attention weights: q_proj 3072 x 2048, kv_a 576 x 2048, kv_b 4096 x 512, o_proj 2048 x 2048.
    assert gr.attn_params(cfg) == 6291456 + 1179648 + 2097152 + 4194304
    assert gr.layer_kinds(cfg) == (1, 26)
    # One prompt of 3 tokens, 2 rows, 1 decode step. Prefill: bytes bound,
    # (weights + 3 tokens in and out + 3 latents) x 2 bytes at 1e12 B/s.
    p = gr.attn_params(cfg)
    prefill = 2 * (p + 2 * 3 * 2048 + 3 * 576) / 1e12
    # Decode step 0: the weights, 2 rows in and out, the prompt's 3 latents
    # once, each row's own one read and its new one written.
    step = 2 * (p + 2 * 2 * 2048 + 3 * 576 + 2 * 2 * 576) / 1e12
    assert gr.mla_least_s(cfg, [3], 2, 1, peaks) == pytest.approx(27 * (prefill + step))
    # Expert layer at 2 rows: 64 (1 - (1 - 6/64)^2) = 11.4375 experts hit.
    one = 3 * 2048 * 1408
    decode = 2 * (2048 * 64 + 2 * one + 11.4375 * one + 2 * 2 * 2048) / 1e12
    hit3 = 64 * (1 - (1 - 6 / 64) ** 3)
    prefill = 2 * (2048 * 64 + 2 * one + hit3 * one + 2 * 3 * 2048) / 1e12
    assert gr.moe_least_s(cfg, [3], 2, 1, peaks) == pytest.approx(26 * (prefill + decode))
    # MFU's operations: one prompt of 3 tokens (6 causal pairs), 2 decode
    # positions over 4 + 4 cached positions.
    counters = {"gen.prefill_tokens": 3, "gen.prefill_pairs": 6, "gen.prompts": 1,
                "gen.decode_positions": 2, "gen.cache_positions": 8}
    per_token = 2 * (27 * p + 3 * 2048 * 10944 + 26 * (2048 * 64 + one * 8))
    attn = 27 * 2 * 16 * (320 * 6 + 1088 * 8)
    assert gr.model_ops(cfg, counters) == pytest.approx(
        per_token * 5 + 2 * 2048 * 102400 * 3 + attn)


def test_gen_mfu_is_held_to_the_call_shapes_and_the_least_times():
    """The window's operations from the port's counters are those that the
    least times count from the calls' shapes; at the published widths a
    window that took the calls' least time reads at most 100%."""
    from rag_uq_tpu_torch.llm.deepseek_v2 import DeepseekV2Config, DeepseekV2LM
    from rag_uq_tpu_torch.utils import profiling

    full = json.loads((ROOT / "benchmark/configs/deepseek-v2-lite.json").read_text())
    toy = {**full, **TOY_WIDTHS}
    lm = DeepseekV2LM(DeepseekV2Config.from_dict(toy), seed=3, device="cpu")
    prompts = ["1 2 3 4"] * 3 + ["5 6 7 8 9 10 11"] * 3
    profiling.take()
    profiling.enable()
    try:
        for _ in range(2):
            lm.generate_batch_scored(prompts, [0.9] * 6, [0.9] * 6, max_tokens=5, seed=1)
        counters = profiling.take()["counters"]
    finally:
        profiling.disable()
    st = lm.last_stats
    assert gr.model_ops(toy, counters) == pytest.approx(
        2 * gr.call_ops(toy, st["prompt_lens"], st["group"], st["steps"]))

    # A call at the published widths: 32 prompts of 1,350 ids, 10 rows each,
    # 99 decode steps; 4.48 GFLOP a token in the linear layers.
    lens, group, steps = [1350] * 32, 10, 99
    per_token = 2 * (27 * gr.attn_params(full) + 3 * 2048 * 10944
                     + 26 * (2048 * 64 + 3 * 2048 * 1408 * 8))
    assert per_token == pytest.approx(4.48e9, rel=0.01)
    ops = gr.call_ops(full, lens, group, steps)
    assert ops > per_token * (32 * 1350 + 320 * 99)
    window = {"gen.prefill_tokens": 32 * 1350, "gen.prefill_pairs": 32 * 1350 * 1351 // 2,
              "gen.prompts": 32, "gen.decode_steps": 99, "gen.decode_positions": 320 * 99,
              "gen.cache_positions": 99 * 320 * 1350 + 320 * 99 * 100 // 2}
    assert gr.model_ops(full, window) == pytest.approx(ops)
    layered = sum(o for o, _ in gr._mla_parts(full, lens, group, steps)) * 27 + sum(
        o for o, _ in gr._moe_parts(full, lens, group, steps)) * 26
    least = (gr.mla_least_s(full, lens, group, steps, PEAKS)
             + gr.moe_least_s(full, lens, group, steps, PEAKS)
             + (ops - layered) / PEAKS["bf16_flops"])
    read = run.load_reader(ROOT / "benchmark", "gen_mfu.mc_answer")
    mfu = read({"counters": window, "elapsed": least, "model": full})
    assert 0 < mfu <= 100
    assert mfu == pytest.approx(100 * ops / (least * PEAKS["bf16_flops"]))


def test_the_generator_readers_take_the_window_alone():
    """Spans that end after the window (the profiled call's) are left out."""
    from rag_uq_tpu_torch.utils.profiling import Span

    spans = [Span(1, None, 1, "generate.prefill", 0, 5, 100, 80.0),
             Span(2, None, 2, "generate.decode", 5, 10, 99, 500.0),
             Span(3, None, 3, "generate.prefill", 20, 25, 100, 120.0),
             Span(4, None, 4, "generate.decode", 25, 30, 99, 900.0)]
    ctx = {"program": {"window": {"spans": spans}}, "end_ns": 15,
           "counters": {"gen.decode_steps": 99}}
    bench = ROOT / "benchmark"
    assert run.load_reader(bench, "gen_prefill_ms.mc_answer")(ctx) == 80.0
    assert run.load_reader(bench, "gen_step_ms.mc_answer")(ctx) == pytest.approx(500.0 / 99)
    for name in ("gen_prefill_ms", "gen_step_ms", "gen_mfu", "mla_roofline", "moe_roofline",
                 "device_idle"):
        assert run.load_reader(bench, f"{name}.mc_answer")({}) is None, name


def test_the_benchmark_files_the_cell_found_are_unchanged():
    """Every file under ``benchmark/`` in the commit before the one that
    added the cell is byte for byte as it is now."""
    def blob(rev, path):
        return subprocess.run(["git", "show", f"{rev}:{path}"], cwd=ROOT, capture_output=True)

    log = subprocess.run(["git", "log", "--format=%H", "--diff-filter=A", "--",
                          "benchmark/configs/deepseek-v2-lite.json"], cwd=ROOT,
                         capture_output=True, text=True)
    if log.returncode:
        pytest.skip("no git history")
    added = log.stdout.split()
    # Not committed yet: the files are held to the last commit.
    parent = f"{added[-1]}^" if added else "HEAD"
    listed = subprocess.run(["git", "ls-tree", "-r", "--name-only", parent, "benchmark"],
                            cwd=ROOT, capture_output=True, text=True).stdout.split()
    assert listed
    for path in listed:
        before = blob(parent, path).stdout
        now = (ROOT / path).read_bytes()
        assert hashlib.sha256(now).digest() == hashlib.sha256(before).digest(), path


@pytest.mark.chip
def test_dsv2lite_is_correct_and_its_control_is_not_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(CELL, 2**31 + 443, 3.0, False, control=True,
                       t_origin=time.perf_counter())
    assert out["correct"], out["checks"]
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    assert any(v > limits[k[8:]] for k, v in out["_extra"].items()
               if k.startswith("control.") and k[8:] in limits)
