"""The port's seeded encoder init against the JAX package's, with no
weights carried across: ``pathway_tpu_torch.xpacks.llm._flax_init``
reproduces ``model.init(jax.random.PRNGKey(seed), ...)`` in numpy.

Tolerances: random bits, ``fold_in`` keys and uniforms are bit-exact; a
weight may differ from the JAX one by XLA's f32 ``erfinv``/``log1p``
rounding, so every weight is held to a relative 1e-6 of its tensor's
largest magnitude. ``EncoderRuntime(seed=s)`` of both packages then agree in
float32 within atol 1e-5 (embeddings and cross-encoder scores) and, at the
default bfloat16, within the encoder tests' cosine 0.999 (embeddings) and
atol 1e-2 (scores)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.xpacks.llm import _encoder as jenc
from pathway_tpu_torch.xpacks.llm import _encoder as tenc
from pathway_tpu_torch.xpacks.llm import _flax_init as fi

DIM, DEPTH, HEADS, VOCAB, MAXLEN = 32, 2, 4, 500, 32
WEIGHT_RTOL = 1e-6
F32_ATOL = 1e-5
BF16_MIN_COS = 0.999
BF16_SCORE_ATOL = 1e-2


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_bits_fold_in_and_uniform_are_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(x) for x in np.asarray(jax.random.key_data(key))) == fi.prng_key(seed)
    got = fi.random_bits(fi.prng_key(seed), (3, 5, 7))
    assert np.array_equal(np.asarray(jax.random.bits(key, (3, 5, 7), jnp.uint32)), got)
    folded = np.asarray(jax.random.key_data(jax.random.fold_in(key, 0xDEADBEEF)))
    assert tuple(int(x) for x in folded) == fi.fold_in(fi.prng_key(seed), 0xDEADBEEF)
    ref = np.asarray(jax.random.uniform(key, (4096,), jnp.float32, -0.75, 3.0))
    assert np.array_equal(ref, fi._uniform(fi.prng_key(seed), (4096,), -0.75, 3.0))


@pytest.mark.parametrize("kind", ["normal", "truncated_normal"])
def test_normals_within_rounding(kind):
    key = jax.random.PRNGKey(7)
    if kind == "normal":
        ref = np.asarray(jax.random.normal(key, (50_000,), jnp.float32))
        got = fi._normal(fi.prng_key(7), (50_000,))
    else:
        ref = np.asarray(jax.random.truncated_normal(key, -2, 2, (50_000,), jnp.float32))
        got = fi._truncated_normal(fi.prng_key(7), (50_000,))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=WEIGHT_RTOL, atol=WEIGHT_RTOL)
    assert np.mean(got == ref) > 0.95  # most are bit-equal


def _flat(tree):
    return {
        jax.tree_util.keystr(path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize("cross", [False, True], ids=["encoder", "cross_encoder"])
@pytest.mark.parametrize("seed", [0, 3])
def test_every_weight_equals_the_jax_init(cross, seed):
    ref = jenc.EncoderRuntime(
        vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN,
        seed=seed, cross_encoder=cross,
    ).params
    got = fi.init_params(
        seed, vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS, mlp_ratio=4,
        max_len=MAXLEN, cross_encoder=cross,
    )
    ref_f, got_f = _flat(ref), _flat(got)
    assert sorted(ref_f) == sorted(got_f)
    for name, r in ref_f.items():
        g = got_f[name]
        assert g.shape == r.shape and g.dtype == np.float32, name
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= WEIGHT_RTOL * scale, name


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, VOCAB, size=(6, 16)).astype(np.int32)
    mask = np.ones((6, 16), np.float32)
    mask[1, 9:] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _runtimes(cross, dtype_name, seed=5):
    kw = dict(vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, seed=seed)
    jr = jenc.EncoderRuntime(cross_encoder=cross, **kw)
    tr = tenc.EncoderRuntime(cross_encoder=cross, device="cpu", **kw)
    if dtype_name == "float32":
        enc = jenc.TransformerEncoder(
            vocab_size=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, dtype=jnp.float32
        )
        jr.model = jenc.CrossEncoderHead(enc) if cross else enc
        (tr.model.encoder if cross else tr.model).dtype = torch.float32
    return jr, tr


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_seeded_embeddings_match_without_convert(dtype_name):
    jr, tr = _runtimes(False, dtype_name)
    ids, mask = _batch(1)
    a, b = jr.forward_ids(ids, mask), tr.forward_ids(ids, mask)
    assert a.shape == b.shape == (6, DIM)
    if dtype_name == "float32":
        np.testing.assert_allclose(b, a, atol=F32_ATOL, rtol=0)
    else:
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() >= BF16_MIN_COS, cos


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_seeded_cross_encoder_scores_match_without_convert(dtype_name):
    jr, tr = _runtimes(True, dtype_name)
    ids, mask = _batch(2)
    a, b = jr.forward_ids(ids, mask), tr.forward_ids(ids, mask)
    assert a.shape == b.shape == (6,)
    atol = F32_ATOL if dtype_name == "float32" else BF16_SCORE_ATOL
    np.testing.assert_allclose(b, a, atol=atol, rtol=0)
