"""The port's bundled decoder against the JAX package's: bit-identical
seeded weights, ``decode_step`` logits and K/V pools token by token, a
decode carried across packages mid-sequence through
``convert.pools_to_torch``, and identical sampling draws.

Tolerances: logits and pool values 1e-5 absolute — XLA and torch sum the
f32 matmuls of the 64-wide layers in different orders, and a later layer's
K/V carry the earlier layers' differences. Which page slots
hold data must match exactly, and greedy tokens must be equal."""

import numpy as np
import pytest
import torch

from pathway_tpu.xpacks.llm import decoder as jdec
from pathway_tpu_torch.convert import decoder_params_to_torch, pools_to_torch
from pathway_tpu_torch.xpacks.llm import decoder as tdec

LOGIT_TOL = 1e-5
POOL_TOL = 1e-5
_SHAPE = dict(dim=64, n_layers=1, n_heads=2, head_dim=32, ffn_dim=128, max_len=64, page_size=8)


def _cfgs(**kw):
    shape = {**_SHAPE, **kw}
    return jdec.DecoderConfig(**shape), tdec.DecoderConfig(**shape)


def _i32(*xs):
    return np.array(xs, np.int32)


def _jax_step(params, cfg, tok, pos, pools, pt, sl):
    logits, k, v = jdec.decode_step(
        params, tok, pos, pools[0], pools[1], pt, sl, cfg=cfg, kernel="ref"
    )
    return np.asarray(logits), (k, v)


def _torch_step(params, cfg, tok, pos, pools, pt, sl, kernel="cuda"):
    t = torch.from_numpy
    logits, k, v = tdec.decode_step(
        params, t(tok), t(pos), pools[0], pools[1], t(pt), t(sl), cfg=cfg, kernel=kernel
    )
    return logits.numpy(), (k, v)


def test_config_and_tokenizer_match():
    jcfg, tcfg = _cfgs()
    assert (tcfg.head_dim_padded, tcfg.max_pages) == (jcfg.head_dim_padded, jcfg.max_pages)
    assert (tdec.BOS, tdec.EOS, tdec.PAD) == (jdec.BOS, jdec.EOS, jdec.PAD)
    text = "paged ü"
    assert tdec.encode_text(text) == jdec.encode_text(text)
    toks = tdec.encode_text(text) + [tdec.EOS, 300]
    assert tdec.decode_tokens(toks) == jdec.decode_tokens(toks) == text


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_bit_equal(seed):
    jcfg, tcfg = _cfgs()
    jp, tp = jdec.init_params(jcfg, seed=seed), tdec.init_params(tcfg, seed=seed)
    assert jp.keys() == tp.keys() and len(jp["layers"]) == len(tp["layers"])
    for name in jp:
        if name != "layers":
            assert np.array_equal(jp[name], tp[name]) and tp[name].dtype == np.float32
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert jl.keys() == tl.keys()
        assert all(np.array_equal(jl[k], tl[k]) for k in jl)
    on_cpu = decoder_params_to_torch(tp, "cpu")
    assert np.array_equal(on_cpu["embed"].numpy(), jp["embed"])
    assert np.array_equal(on_cpu["layers"][0]["wq"].numpy(), jp["layers"][0]["wq"])


@pytest.mark.parametrize("kernel", ["ref", "cuda"])
def test_decode_step_token_by_token(kernel):
    """One sequence fed token by token: logits at every step and the pools
    after the last step match JAX's reference path."""
    jcfg, tcfg = _cfgs()
    jp = jdec.init_params(jcfg, seed=3)
    tp = decoder_params_to_torch(tdec.init_params(tcfg, seed=3), "cpu")
    jpools = jdec.empty_pools(jcfg, n_pages=6)
    tpools = tdec.empty_pools(tcfg, n_pages=6, device="cpu")
    pt = np.zeros((1, jcfg.max_pages), np.int32)
    pt[0, :3] = [1, 2, 3]
    toks = jdec.encode_text("paged") + [65, 66, 67, 68, 69]
    for i, t in enumerate(toks):
        args = (_i32(t), _i32(i), pt, _i32(i + 1))
        jl, jpools = _jax_step(jp, jcfg, args[0], args[1], jpools, args[2], args[3])
        tl, tpools = _torch_step(tp, tcfg, *args[:1], args[1], tpools, args[2], args[3], kernel)
        assert np.allclose(jl, tl, atol=LOGIT_TOL), (i, np.abs(jl - tl).max())
    for jpool, tpool in zip(jpools, tpools):
        jpool, tpool = np.asarray(jpool), tpool.numpy()
        assert np.array_equal(jpool != 0, tpool != 0)  # the same slots written
        assert np.allclose(jpool, tpool, atol=POOL_TOL)


def test_batched_step_writes_like_jax():
    """A padded batch (2 live sequences, 2 pad slots on the null page):
    the in-place write lands the [B, H, Dp] K/V rows in the same page slots
    as JAX's ``.at[li, page_ids, :, slots, :].set``."""
    jcfg, tcfg = _cfgs(n_layers=2)
    jp = jdec.init_params(jcfg, seed=1)
    tp = decoder_params_to_torch(tdec.init_params(tcfg, seed=1), "cpu")
    jpools = jdec.empty_pools(jcfg, n_pages=8)
    tpools = tdec.empty_pools(tcfg, n_pages=8, device="cpu")
    pt = np.zeros((4, jcfg.max_pages), np.int32)
    pt[0, :2] = [3, 5]
    pt[1, :2] = [6, 2]
    prompts = [jdec.encode_text("first row"), jdec.encode_text("row two!!")]
    for i in range(len(prompts[0])):
        tok = _i32(prompts[0][i], prompts[1][i], 0, 0)
        pos = _i32(i, i, 0, 0)
        sl = _i32(i + 1, i + 1, 0, 0)
        jl, jpools = _jax_step(jp, jcfg, tok, pos, jpools, pt, sl)
        tl, tpools = _torch_step(tp, tcfg, tok, pos, tpools, pt, sl)
        assert np.allclose(jl, tl, atol=LOGIT_TOL)
    for jpool, tpool in zip(jpools, tpools):
        jpool, tpool = np.asarray(jpool), tpool.numpy()
        assert np.array_equal(jpool != 0, tpool != 0)
        assert np.allclose(jpool, tpool, atol=POOL_TOL)
        # live pages hold data, untouched pages stay zero; the padded slots
        # wrote only page 0, slot 0
        assert (tpool[:, [3, 5, 6, 2]] != 0).any(axis=(2, 3, 4)).all()
        assert (tpool[:, [1, 4, 7]] == 0).all()
        assert (tpool[:, 0, :, 1:] == 0).all() and (tpool[:, 0, :, 0] != 0).any()


def _greedy(step, pools, params, cfg, tokens, start, n_new, pt):
    """Feed tokens[start:] one by one, then n_new greedy tokens (each fed
    but the last); returns (the new tokens, the pools)."""
    toks = list(tokens)
    for _ in range(n_new):
        for i in range(start, len(toks)):
            logits, pools = step(params, cfg, _i32(toks[i]), _i32(i), pools, pt, _i32(i + 1))
        start = len(toks)
        toks.append(int(np.argmax(logits[0])))
    return toks[len(tokens):], pools


def test_pools_carried_from_jax_continue_in_the_port():
    """Run the prompt through JAX, carry its pools across with
    ``pools_to_torch``, continue greedily in the port: the tokens equal an
    uninterrupted JAX run."""
    jcfg, tcfg = _cfgs()
    jp = jdec.init_params(jcfg, seed=7)
    tp = decoder_params_to_torch(tdec.init_params(tcfg, seed=7), "cpu")
    pt = np.zeros((1, jcfg.max_pages), np.int32)
    pt[0, :5] = [4, 1, 6, 3, 2]
    prompt = jdec.encode_text("carry the cache over")
    whole, _ = _greedy(_jax_step, jdec.empty_pools(jcfg, 8), jp, jcfg, prompt, 0, 12, pt)
    # JAX feeds the prompt and 3 generated tokens; the 4th is sampled only
    head, jpools = _greedy(_jax_step, jdec.empty_pools(jcfg, 8), jp, jcfg, prompt, 0, 4, pt)
    tpools = pools_to_torch(np.asarray(jpools[0]), np.asarray(jpools[1]), "cpu")
    assert np.array_equal(tpools[0].numpy(), np.asarray(jpools[0]))
    assert np.array_equal(tpools[1].numpy(), np.asarray(jpools[1]))
    # the port feeds the 4th and carries on from the carried pools
    rest, _ = _greedy(_torch_step, tpools, tp, tcfg, prompt + head, len(prompt) + 3, 8, pt)
    assert head + rest == whole


def test_sample_token_same_draws():
    rng = np.random.default_rng(0)
    for trial in range(40):
        logits = rng.normal(size=259).astype(np.float32)
        kw = dict(
            temperature=[0.0, 0.7, 1.3][trial % 3],
            top_k=[1, 5, 40, 259][trial % 4],
            seed=[0, 5, -1, -12345678901, 2**40][trial % 5],
            step=trial,
        )
        assert tdec.sample_token(logits, **kw) == jdec.sample_token(logits, **kw)


def test_unknown_kernel_raises():
    _jcfg, tcfg = _cfgs()
    tp = decoder_params_to_torch(tdec.init_params(tcfg), "cpu")
    k, v = tdec.empty_pools(tcfg, 2, device="cpu")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tdec.decode_step(
            tp, z, z, k, v, torch.zeros(1, tcfg.max_pages, dtype=torch.int32), z + 1,
            cfg=tcfg, kernel="pallas",
        )
