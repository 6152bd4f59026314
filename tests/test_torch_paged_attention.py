"""The port's ragged paged attention against the JAX package's: the port's
``paged_attention`` (on CPU tensors its wrapper runs the plain version) and
``paged_attention_ref`` against JAX's ``paged_attention_ref`` and the Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerance: 2e-6 absolute, the bound ``tests/test_paged_attention.py`` holds
between interpret mode and the JAX reference (f32 sums in another order);
rows with no live token must be exactly 0 in every version.

The CUDA kernel splits each sequence's pages across S blocks and merges the
partial softmax states in the launch; a plain-torch emulation of exactly
that arithmetic (8 warps of T-token chunks per split, the warp merge, the
online merge of the splits) is held here against both references within
1e-5, the tolerance the card holds the kernel to."""

import numpy as np
import pytest
import torch

from pathway_tpu.ops import paged_attention as jpa
from pathway_tpu_torch.ops import lane_pad
from pathway_tpu_torch.ops import paged_attention as tpa

TOL = 2e-6


def _rand_case(b, h, p, dp, n_pages, max_pages, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dp)).astype(np.float32)
    k = rng.normal(size=(n_pages, h, p, dp)).astype(np.float32)
    v = rng.normal(size=(n_pages, h, p, dp)).astype(np.float32)
    pt = rng.integers(1, n_pages, size=(b, max_pages)).astype(np.int32)
    sl = rng.integers(0, max_pages * p + 1, size=(b,)).astype(np.int32)
    return q, k, v, pt, sl


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "b,h,p,dp,n_pages,max_pages",
    [
        (4, 4, 8, 128, 16, 3),  # the decoder's default layout
        (1, 2, 16, 256, 8, 4),  # multi-lane head_dim
        (8, 4, 8, 128, 32, 5),
        (3, 1, 4, 128, 7, 2),  # page_size below the sublane width
    ],
)
def test_port_matches_jax_ref_and_interpret(b, h, p, dp, n_pages, max_pages):
    q, k, v, pt, sl = _rand_case(b, h, p, dp, n_pages, max_pages, b * 31)
    sl[0] = 0  # always include an empty slot
    scale = 1.0 / np.sqrt(32.0)
    jref = np.asarray(jpa.paged_attention_ref(q, k, v, pt, sl, sm_scale=scale))
    jint = np.asarray(jpa.paged_attention(q, k, v, pt, sl, sm_scale=scale, interpret=True))
    args = _torch(q, k, v, pt, sl)
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*args, sm_scale=scale).numpy()
    ref = tpa.paged_attention_ref(*args, sm_scale=scale).numpy()
    assert tpa.paged_attention.launches == before  # CPU tensors never launch
    for other in (jref, jint, ref):
        assert np.allclose(got, other, atol=TOL), np.abs(got - other).max()
    assert (got[0] == 0.0).all() and (ref[0] == 0.0).all()


def test_boundary_lengths_and_negative():
    """Lengths at the page edges (0, P, P+1, full) and a negative length
    mask exactly as JAX's reference does; empty rows are exactly 0."""
    b, h, p, dp, n_pages, max_pages = 5, 2, 8, 128, 12, 3
    q, k, v, pt, sl = _rand_case(b, h, p, dp, n_pages, max_pages, 99)
    sl[:] = [0, p, p + 1, max_pages * p, -2]
    jref = np.asarray(jpa.paged_attention_ref(q, k, v, pt, sl, sm_scale=0.2))
    jint = np.asarray(jpa.paged_attention(q, k, v, pt, sl, sm_scale=0.2, interpret=True))
    got = tpa.paged_attention(*_torch(q, k, v, pt, sl), sm_scale=0.2).numpy()
    assert np.allclose(got, jref, atol=TOL) and np.allclose(got, jint, atol=TOL)
    assert (got[0] == 0.0).all() and (got[4] == 0.0).all()
    # the live rows against a dense softmax over exactly n tokens (numpy)
    for i in (1, 2, 3):
        n = int(sl[i])
        kk = np.concatenate([k[pt[i, j]] for j in range(max_pages)], axis=1)[:, :n]
        vv = np.concatenate([v[pt[i, j]] for j in range(max_pages)], axis=1)[:, :n]
        s = np.einsum("hd,hnd->hn", q[i], kk) * 0.2
        w = np.exp(s - s.max(axis=1, keepdims=True))
        w /= w.sum(axis=1, keepdims=True)
        assert np.allclose(np.einsum("hn,hnd->hd", w, vv), got[i], atol=2e-5)


def test_page_permutation_invariance():
    """Permuting the physical pages and remapping the table gives the same
    output: attention depends on the mapped pages, not their ids."""
    b, h, p, dp, n_pages, max_pages = 2, 2, 8, 128, 10, 2
    q, k, v, pt, sl = _rand_case(b, h, p, dp, n_pages, max_pages, 5)
    sl[:] = [11, 13]
    out1 = tpa.paged_attention_ref(*_torch(q, k, v, pt, sl), sm_scale=1.0).numpy()
    perm = np.random.default_rng(6).permutation(n_pages)
    inv = np.argsort(perm).astype(np.int32)
    k2, v2, pt2 = k[perm], v[perm], inv[pt]
    out2 = tpa.paged_attention_ref(*_torch(q, k2, v2, pt2, sl), sm_scale=1.0).numpy()
    jout = np.asarray(jpa.paged_attention_ref(q, k2, v2, pt2, sl, sm_scale=1.0))
    assert np.allclose(out1, out2, atol=1e-6) and np.allclose(out2, jout, atol=TOL)


@pytest.mark.parametrize("d,padded", [(1, 128), (32, 128), (128, 128), (129, 256), (256, 256)])
def test_lane_pad_edges(d, padded):
    assert lane_pad(d) == padded == jpa.lane_pad(d)


def test_wrapper_rejects_bad_inputs():
    q, k, v, pt, sl = _torch(*_rand_case(2, 2, 8, 128, 6, 2, 1))
    with pytest.raises(TypeError):
        tpa.paged_attention(q.double(), k, v, pt, sl, sm_scale=1.0)
    with pytest.raises(TypeError):
        tpa.paged_attention(q, k, v, pt.long(), sl, sm_scale=1.0)
    with pytest.raises(ValueError):
        tpa.paged_attention(q[:1], k, v, pt, sl, sm_scale=1.0)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, k[:, :1].contiguous(), v[:, :1].contiguous(), pt, sl, sm_scale=1.0)
    with pytest.raises(ValueError):
        tpa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, pt, sl, sm_scale=1.0)


@pytest.mark.parametrize(
    "bh,max_pages,page_size,dp,sms,splits",
    [
        (32, 16, 16, 128, 132, 4),  # the generation step: B = 8 bucket x 4 heads
        (256, 128, 16, 128, 132, 1),  # long context: B x H alone fills the card
        (132, 16, 16, 128, 132, 1),  # B x H >= SMs
        (300, 4, 8, 256, 132, 1),
        (8, 16, 8, 128, 132, 2),  # 128 tokens: two chunk rounds of 8 warps x 8
        (1, 256, 16, 128, 132, 64),  # one sequence: 4 pages (one chunk round) per split
        (4, 3, 8, 128, 132, 1),  # shorter than one chunk round
        (16, 16, 16, 512, 132, 8),  # Dp = 512: one-token chunks; 9 wanted, 2 pages per split
    ],
)
def test_split_count(bh, max_pages, page_size, dp, sms, splits):
    got = tpa.split_count(bh, max_pages, page_size, dp, sms)
    assert got == splits
    pps = -(-max_pages // got)
    assert -(-max_pages // pps) == got  # no split is left without a page
    if got > 1:
        assert bh * got <= bh * -(-sms // bh)  # no more blocks than filling the card needs
        assert pps * page_size >= 8 * tpa._chunk_tokens(dp)  # a chunk round per split


def _kernel_emulation(q, k, v, pt, sl, scale, splits):
    """The kernel's arithmetic in plain torch: per split, 8 warps each run an
    online softmax over their chunks (chunk c = warp, warp + 8, ...), the
    warp states merge by exp(m_w - max); the split partials then merge one
    by one with online rescaling, as the last split of a (b, h) does."""
    neg = tpa._NEG
    b, h, dp = q.shape
    n_pages, _h, p, _dp = k.shape
    mp = pt.shape[1]
    chunk = tpa._chunk_tokens(dp)
    pps = -(-mp // splits)
    pages = pt.long().clamp(0, n_pages - 1)
    kk = k[pages].permute(0, 2, 1, 3, 4).reshape(b, h, mp * p, dp)
    vv = v[pages].permute(0, 2, 1, 3, 4).reshape(b, h, mp * p, dp)
    s_all = torch.einsum("bhd,bhld->bhl", q, kk) * scale
    n = sl.long().clamp(0, mp * p)
    live = torch.arange(mp * p)[None, :] < n[:, None]  # [b, L]
    parts = []
    for sp in range(splits):
        t0, t1 = sp * pps * p, min((sp + 1) * pps * p, mp * p)
        states = []
        for w in range(8):
            m = torch.full((b, h), neg)
            l = torch.zeros(b, h)
            acc = torch.zeros(b, h, dp)
            for c in range(w, -(-(t1 - t0) // chunk), 8):
                idx = torch.arange(t0 + c * chunk, min(t0 + (c + 1) * chunk, t1))
                sc, lv = s_all[:, :, idx], live[:, idx][:, None, :]
                m_new = torch.maximum(m, torch.where(lv, sc, neg).amax(-1))
                alpha = torch.exp(m - m_new)
                wts = torch.where(lv, torch.exp(sc - m_new[..., None]), 0.0)
                l = l * alpha + wts.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("bhl,bhld->bhd", wts, vv[:, :, idx])
                m = m_new
            states.append((m, l, acc))
        mx = torch.stack([m for m, _l, _a in states]).amax(0)
        sw = [torch.exp(m - mx) for m, _l, _a in states]
        parts.append((
            mx,
            sum(l * f for (_m, l, _a), f in zip(states, sw)),
            sum(a * f[..., None] for (_m, _l, a), f in zip(states, sw)),
        ))
    big_m = torch.full((b, h), neg)
    den = torch.zeros(b, h)
    out = torch.zeros(b, h, dp)
    for m_s, l_s, a_s in parts:
        m_new = torch.maximum(big_m, m_s)
        r, w = torch.exp(big_m - m_new), torch.exp(m_s - m_new)
        den = den * r + l_s * w
        out = out * r[..., None] + a_s * w[..., None]
        big_m = m_new
    return torch.where(den[..., None] > 0, out / den.clamp(min=1e-30)[..., None], 0.0)


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("p,dp", [(16, 128), (8, 256)])
def test_split_merge_emulation_matches_refs(splits, p, dp):
    """Splits with no live token (lengths 0, P, P + 1 on a 16-page table)
    and whole rows with none (0 and a negative length) come out as the
    references say; empty rows exactly 0."""
    b, h, n_pages, max_pages = 6, 2, 40, 16
    q, k, v, pt, sl = _rand_case(b, h, p, dp, n_pages, max_pages, 7 * splits + p)
    sl[:] = [0, p, p + 1, max_pages * p, -4, 5 * p + 3]
    scale = 32**-0.5
    args = _torch(q, k, v, pt, sl)
    got = _kernel_emulation(*args, scale, splits).numpy()
    ref = tpa.paged_attention_ref(*args, sm_scale=scale).numpy()
    jref = np.asarray(jpa.paged_attention_ref(q, k, v, pt, sl, sm_scale=scale))
    for other in (ref, jref):
        assert np.abs(got - other).max() <= 1e-5
    assert (got[0] == 0.0).all() and (got[4] == 0.0).all()
