"""The port's transformer encoder against the JAX package's, on the CPU.

The same hashed ids (numpy, seeded) and the same weights (a JAX init
carried across with ``convert.load_encoder``, or the shipped checkpoint read
by both packages' loaders) go through both. Tolerances: in float32 the
two differ only in summation order (1e-5 absolute on unit vectors); in
bf16 every layer rounds its outputs, in another order than XLA, so the
vectors are held by cosine (at least 0.999) and 2e-2 absolute.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_uq_tpu.embed.encoder import EncoderConfig as JaxEncoderConfig
from rag_uq_tpu.embed.encoder import EncoderModel as JaxEncoderModel
from rag_uq_tpu.embed.train import load_encoder_checkpoint as jax_load_encoder
from rag_uq_tpu_torch.convert import load_encoder
from rag_uq_tpu_torch.core.config import EmbedderConfig
from rag_uq_tpu_torch.embed.base import get_embedder
from rag_uq_tpu_torch.embed.encoder import EncoderConfig, TransformerEmbedder
from rag_uq_tpu_torch.embed.train import load_encoder_checkpoint

SMALL = dict(dim=64, num_layers=2, num_heads=4, mlp_dim=128, max_seq_len=16, vocab_buckets=512)
SHIPPED = "models/encoder/encoder.msgpack"


def _inputs(batch=12, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SMALL["vocab_buckets"], size=(batch, SMALL["max_seq_len"])).astype(np.int32)
    lengths = rng.integers(1, SMALL["max_seq_len"] + 1, size=batch).astype(np.int32)
    lengths[0], lengths[1] = 0, SMALL["max_seq_len"]  # empty and full rows
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids, lengths


@pytest.mark.parametrize("dtype,atol,min_cos", [("float32", 1e-5, 1 - 1e-6),
                                                 ("bfloat16", 2e-2, 0.999)])
def test_small_encoder_matches_jax(dtype, atol, min_cos):
    ids, lengths = _inputs()
    jmodel = JaxEncoderModel(JaxEncoderConfig(**SMALL, dtype=dtype))
    params = jmodel.init(jax.random.PRNGKey(7), jnp.asarray(ids), jnp.asarray(lengths))
    ref = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(lengths)))
    ours = load_encoder(TransformerEmbedder(EncoderConfig(**SMALL, dtype=dtype), device="cpu"),
                        jax.tree.map(np.asarray, params))
    out = ours.encode_device(torch.from_numpy(ids), torch.from_numpy(lengths)).numpy()
    assert out.shape == ref.shape == (len(ids), SMALL["dim"]) and np.isfinite(out).all()
    np.testing.assert_array_equal(out[0], 0.0)  # an empty text pools nothing
    np.testing.assert_allclose(out, ref, atol=atol)
    live = lengths > 0
    assert ((out * ref).sum(1)[live] >= min_cos).all()


def test_padded_query_rows_stay_finite():
    """A row with every key masked gets equal most-negative logits, not
    -inf: the block outputs are finite for every position."""
    ids, lengths = _inputs()
    emb = TransformerEmbedder(EncoderConfig(**SMALL), device="cpu")
    model = emb.model
    positions = torch.arange(ids.shape[1])
    lens = torch.from_numpy(lengths)
    valid = positions[None, :] < lens[:, None]
    x = model.tok(torch.from_numpy(ids)) + model.pos(positions)[None]
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    with torch.no_grad():
        for block in model.blocks:
            x = block(x, mask)
    assert torch.isfinite(x.float()).all()


def test_shipped_checkpoint_matches_jax():
    with open("runs/demo_full_r4/corpus.jsonl") as f:
        texts = [json.loads(line)["text"] for line, _ in zip(f, range(32))]
    ref = jax_load_encoder(SHIPPED).encode(texts)
    ours = load_encoder_checkpoint(SHIPPED, device="cpu")
    assert ours.config == EncoderConfig(dim=256, num_layers=2, num_heads=8, mlp_dim=1024,
                                        max_seq_len=64, vocab_buckets=16384)
    out = ours.encode(texts)
    cos = (out * ref).sum(1)
    assert cos.min() >= 0.999, cos.min()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_get_embedder_encoder_kind():
    cfg = EmbedderConfig(kind="encoder", dim=64, encoder_layers=2, encoder_heads=4,
                         encoder_mlp_dim=128, max_seq_len=16, vocab_hash_buckets=512, seed=5)
    a = get_embedder(cfg, device="cpu")
    b = get_embedder(cfg, device="cpu")
    assert isinstance(a, TransformerEmbedder) and a.dim == 64
    assert a.config == EncoderConfig(**SMALL)
    texts = ["the quick brown fox", "", "jumps over the lazy dog"]
    va, vb = a.encode(texts), b.encode(texts)
    np.testing.assert_array_equal(va, vb)  # the seeded torch init is reproducible
    np.testing.assert_allclose(np.linalg.norm(va[[0, 2]], axis=1), 1.0, atol=1e-5)
    other = get_embedder(EmbedderConfig(**{**vars(cfg), "seed": 6}), device="cpu")
    assert not np.allclose(other.encode(texts), va)
    shipped = get_embedder(EmbedderConfig(kind="encoder", checkpoint_path=SHIPPED), device="cpu")
    direct = load_encoder_checkpoint(SHIPPED, device="cpu")
    assert shipped.dim == 256
    np.testing.assert_array_equal(shipped.encode(texts), direct.encode(texts))
