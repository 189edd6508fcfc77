"""The absorbed latent-attention decode (``rag_uq_tpu_torch/ops/mla_decode.py``
and ``csrc/mla_decode.cu``).

On the CPU: the plain twin is the chain the generator's decode step ran
before the kernel, bit for bit, alone and inside the generator (ragged
prompts, groups 1 and 3, the first and last step, dead slots); the plan
covers every position. On a card (marked ``chip``, skipped without one;
this file imports no JAX, so it runs there with ``python3 -m pytest
tests/test_torch_mla_decode.py --noconftest -m chip``): the kernel against
its plain twin and a float64 evaluation of the same bf16 inputs, at the
generator's shape and at edge shapes, and its launches in one call of the
published model.
"""

import numpy as np
import pytest
import torch

from rag_uq_tpu_torch.llm import deepseek_v2 as dsv2
from rag_uq_tpu_torch.llm.deepseek_v2 import Capture, DeepseekV2Config, DeepseekV2LM
from rag_uq_tpu_torch.ops import mla_decode as mla
from rag_uq_tpu_torch.utils import profiling

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=2, num_key_value_heads=2,
            n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
            qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16)
SEED = 2**31 + 29


# -- the chain as the decode step ran it before the kernel --------------------------

def _old_mask(lens, lp, group):
    """``LatentCache.fork``'s mask [S, 1, Lp] before the kernel."""
    p = lens.shape[0]
    pos = torch.arange(lp, device=lens.device)
    mask = torch.zeros((p, 1, lp), dtype=torch.float32, device=lens.device)
    mask.masked_fill_(pos[None, None, :] >= lens[:, None, None], float("-inf"))
    return mask.repeat_interleave(group, dim=0)


def _old_core(q, prompt, mask, gen, t, g, scale, r):
    s, nh, _ = q.shape
    gen = gen[:, : t + 1]
    p, lp, d = prompt.shape
    s_p = torch.bmm(q.view(p, g * nh, d), prompt.transpose(1, 2)).view(s, nh, lp)
    s_g = torch.bmm(q, gen.transpose(1, 2))
    scores = torch.cat([s_p.float() * scale + mask, s_g.float() * scale], dim=-1)
    a = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.bmm(a[..., :lp].reshape(p, g * nh, lp), prompt[..., :r]).view(s, nh, r)
    return o + torch.bmm(a[..., lp:], gen[..., :r])


def _old_attn_decode(self, layer, i, h, cos, sin, cache, t):
    cfg = self.config
    s, r = h.shape[0], cfg.kv_lora_rank
    q_nope, q_pe, latent = self._qkv(layer, h, cos, sin)
    self.store_latent(cache.gen[i], t, latent)
    q_lat = torch.bmm(q_nope.transpose(0, 1), layer.w_uk)
    q = torch.cat([q_lat.transpose(0, 1), q_pe], dim=-1)
    prompt = cache.prompt[i]
    mask = _old_mask(cache.lens, prompt.shape[1], cache.group)
    o = _old_core(q, prompt, mask, cache.gen[i], t, cache.group, self.scale, r)
    o = torch.bmm(o.transpose(0, 1), layer.w_uv_t)
    return torch.nn.functional.linear(o.transpose(0, 1).reshape(s, -1), layer.o_proj)


def _inputs(lens, group, heads, max_tokens, d=48, dtype=torch.bfloat16, seed=0,
            device="cpu"):
    """Seeded q [S, heads, d], prompt [P, Lp, d] (zero past each length, as
    the prefill leaves it), lens, gen [S, max_tokens, d]."""
    g = torch.Generator().manual_seed(seed)
    p, lp = len(lens), max(lens)
    s = p * group
    prompt = torch.randn((p, lp, d), generator=g)
    for i, n in enumerate(lens):
        prompt[i, n:] = 0
    q = torch.randn((s, heads, d), generator=g) * 0.5
    gen = torch.randn((s, max_tokens, d), generator=g)
    lens_t = torch.tensor(lens, dtype=torch.long)
    return [x.to(device=device, dtype=dtype) for x in (q, prompt)] + [
        lens_t.to(device), gen.to(device=device, dtype=dtype)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lens,group,t", [
    ([7, 3, 11], 3, 0), ([7, 3, 11], 3, 5), ([5], 1, 0), ([5], 1, 5), ([9, 9, 2, 4], 1, 3),
    ([1, 6], 3, 5),
])
def test_the_plain_twin_is_the_old_chain_bit_for_bit(lens, group, t, dtype):
    q, prompt, lens_t, gen = _inputs(lens, group, heads=2, max_tokens=6, dtype=dtype)
    want = _old_core(q, prompt, _old_mask(lens_t, max(lens), group), gen, t, group, 0.3, 32)
    got = mla.mla_decode_plain(q, prompt, lens_t, gen, t, group, 0.3, 32)
    assert got.dtype == dtype and got.shape == (len(lens) * group, 2, 32)
    assert torch.equal(got, want)
    assert torch.equal(mla.mla_decode(q, prompt, lens_t, gen, t, group, 0.3, 32), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompts", [
    ["1 2 3", "4 5 6 7 8 9 10 11 12", "13 14 15 16 17"],  # ragged, group 1
    ["1 2 3", "1 2 3", "1 2 3", "4 5 6 7 8 9", "4 5 6 7 8 9"],  # group 3, one dead slot
])
def test_the_generator_decodes_as_before_the_kernel(prompts, dtype, monkeypatch):
    lm = DeepseekV2LM(DeepseekV2Config(**TINY, dtype=dtype), seed=SEED, device="cpu")
    rows = list(range(len(prompts)))
    temps, tops = [0.9] * len(prompts), [0.95] * len(prompts)
    max_tokens = 7

    def call():
        lm.capture = Capture(rows)
        out = lm.generate_batch_scored(prompts, temps, tops, max_tokens=max_tokens, seed=5)
        cap, lm.capture = lm.capture, None
        return out, cap.out["rows"]

    (texts, mean_lp, min_lp), rows_new = call()
    launches = mla.cuda_mla_decode.launches
    monkeypatch.setattr(dsv2.DeepseekV2Model, "_attn_decode", _old_attn_decode)
    (texts_o, mean_o, min_o), rows_old = call()
    assert lm.last_stats["steps"] == max_tokens - 1  # t = 0 .. max_tokens - 2
    assert texts == texts_o
    assert np.array_equal(mean_lp, mean_o) and np.array_equal(min_lp, min_o)
    for a, b in zip(rows_new, rows_old):
        assert torch.equal(a["logits"], b["logits"])
        for x, y in zip(a["attn_out"], b["attn_out"]):
            assert torch.equal(x, y)
    assert mla.cuda_mla_decode.launches == launches  # the CPU never reaches the kernel


def test_the_last_step_attends_every_own_position():
    # t = max_tokens - 1: the whole own part is live.
    lens, group, mt = [4, 2], 2, 5
    q, prompt, lens_t, gen = _inputs(lens, group, heads=3, max_tokens=mt, dtype=torch.float32)
    got = mla.mla_decode_plain(q, prompt, lens_t, gen, mt - 1, group, 0.5, 32)
    for s in range(len(lens) * group):
        keys = torch.cat([prompt[s // group, : lens[s // group]], gen[s]]).double()
        a = torch.softmax(q[s].double() @ keys.T * 0.5, dim=-1)
        assert torch.allclose(got[s].double(), a @ keys[:, :32], atol=1e-5)


@pytest.mark.parametrize("lens,group,t", [([4, 2], 2, 4), ([1, 7, 3], 1, 0), ([5], 3, 2)])
def test_the_float64_evaluation_is_the_softmax_over_prompt_and_own_positions(lens, group, t):
    q, prompt, lens_t, gen = _inputs(lens, group, heads=3, max_tokens=5, dtype=torch.float32,
                                     seed=7)
    got = mla.mla_decode_f64(q, prompt, lens_t, gen, t, group, 0.5, 32)
    assert got.dtype == torch.float64 and got.shape == (len(lens) * group, 3, 32)
    for s in range(len(lens) * group):
        keys = torch.cat([prompt[s // group, : lens[s // group]], gen[s, : t + 1]]).double()
        a = torch.softmax(q[s].double() @ keys.T * 0.5, dim=-1)
        assert torch.allclose(got[s], a @ keys[:, :32], rtol=1e-12, atol=1e-12)
    plain = mla.mla_decode_plain(q, prompt, lens_t, gen, t, group, 0.5, 32)
    assert 0 < mla.row_err(plain, got) < 1e-5  # float32 rounding, no more


def test_row_err_is_the_widest_gap_over_the_row_rms():
    ref = torch.tensor([[[3.0, 4.0], [1.0, 1.0]]])  # row RMS 3.5355 and 1
    x = ref + torch.tensor([[[0.5, -1.0], [0.25, 0.0]]])
    assert mla.row_err(x, ref) == pytest.approx(1.0 / (12.5 ** 0.5))
    assert mla.row_err(ref, ref) == 0.0


def test_the_kernel_wrapper_refuses_what_it_cannot_launch():
    q, prompt, lens_t, gen = _inputs([3], 1, heads=2, max_tokens=4)
    with pytest.raises(ValueError, match="CUDA"):
        mla.cuda_mla_decode(q, prompt, lens_t, gen, 0, 1, 0.1, 32)


@pytest.mark.parametrize("prompts,group,heads,lp,t", [
    (32, 10, 16, 1400, 0), (32, 10, 16, 1400, 98), (1, 1, 16, 1, 0), (1, 1, 128, 130, 7),
    (4, 3, 16, 200, 300), (2, 1, 16, 64, 63), (7, 10, 16, 1101, 49),
])
def test_the_plan_covers_every_position_and_fills_the_card(prompts, group, heads, lp, t):
    n_sm = 132
    pl = mla.plan(prompts, group, heads, lp, t, n_sm)
    assert pl.chunk % 64 == 0
    assert pl.splits * pl.chunk >= lp > (pl.splits - 1) * pl.chunk
    assert pl.own_splits * pl.chunk >= t + 1 > (pl.own_splits - 1) * pl.chunk
    assert pl.row_tiles * 64 >= group * heads > (pl.row_tiles - 1) * 64
    assert pl.head_tiles * 64 >= heads > (pl.head_tiles - 1) * 64
    if (prompts, group, heads) == (32, 10, 16):
        # The generator's shape: its 96 prompt items and 320 own items fill
        # the card unsplit (one partial a row each).
        assert pl.splits == 1 and pl.items(prompts, prompts * group) >= n_sm
    if prompts * group == 1:  # one slot: the prompt is split across the SMs
        assert pl.splits == -(-lp // 256) or pl.splits * 64 * 4 >= lp
    assert pl.items(prompts, prompts * group) == (
        prompts * pl.row_tiles * pl.splits + prompts * group * pl.head_tiles * pl.own_splits)


# -- on the card ---------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# The generator's shape, then the edges: one prompt, group 1, a length that
# is no multiple of 64, a prompt of one token, 128 heads.
CELL_LENS = [1100 + (37 * i) % 301 for i in range(32)]
CARD_SHAPES = (
    [("cell", CELL_LENS, 10, 16, t) for t in (0, 1, 49, 98)]
    + [("one_prompt", [1350], 10, 16, 49), ("group_1", CELL_LENS[:8], 1, 16, 20),
       ("ragged_not_64", [1101, 77, 650], 10, 16, 5), ("one_token", [1, 1300], 10, 16, 3),
       ("heads_128", [1000, 513], 2, 128, 30)]
)
# softmax_scale of DeepSeek-V2-Lite: 192 ** -0.5 * (0.0707 ln 40 + 1) ** 2.
SCALE = dsv2.softmax_scale(DeepseekV2Config())


@pytest.mark.chip
@pytest.mark.parametrize("name,lens,group,heads,t", CARD_SHAPES,
                         ids=[s[0] + f"_t{s[4]}" for s in CARD_SHAPES])
def test_the_kernel_is_as_close_to_float64_as_its_plain_twin(name, lens, group, heads, t):
    dev = _card()
    max_tokens = 100 if t < 100 else t + 1
    q, prompt, lens_t, gen = _inputs(lens, group, heads, max_tokens, d=mla.LATENT,
                                     seed=len(lens) * 1000 + t, device=dev)
    got = mla.cuda_mla_decode(q, prompt, lens_t, gen, t, group, SCALE, mla.RANK)
    plain = mla.mla_decode_plain(q, prompt, lens_t, gen, t, group, SCALE, mla.RANK)
    ref = mla.mla_decode_f64(q, prompt, lens_t, gen, t, group, SCALE, mla.RANK)
    torch.cuda.synchronize()
    assert got.shape == plain.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    e_kernel, e_plain = mla.row_err(got, ref), mla.row_err(plain, ref)
    print(f"{name} t={t}: kernel {e_kernel:.5f} plain {e_plain:.5f} "
          f"kernel-plain {mla.row_err(got, plain):.5f}")
    assert e_kernel <= mla.ERR_MARGIN * e_plain, (e_kernel, e_plain)


@pytest.mark.chip
def test_one_published_call_launches_the_kernel_at_every_layer_and_step():
    dev = _card()
    lm = DeepseekV2LM(DeepseekV2Config(), seed=SEED, device=dev)
    prompts = ["what is the capital of france"] * 3 + ["a b c d e f g"] * 2
    lm.generate_batch_scored(prompts, [0.9] * 5, [0.9] * 5, max_tokens=6, seed=1)  # warm
    mla.cuda_mla_decode.launches = 0
    profiling.enable()
    try:
        profiling.take()  # zero the counters
        lm.generate_batch_scored(prompts, [0.9] * 5, [0.9] * 5, max_tokens=6, seed=1)
        counters = profiling.take()["counters"]
    finally:
        profiling.disable()
    steps = lm.last_stats["steps"]
    layers = lm.config.num_hidden_layers
    assert steps >= 1 and counters["gen.decode_steps"] == steps
    assert mla.cuda_mla_decode.launches == layers * steps
    assert counters["mla.decode_kernel"] == layers * steps
