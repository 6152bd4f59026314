"""The port's ragged paged attention against the JAX package's: the port's
``paged_attention`` (on CPU tensors its wrapper runs the plain version) and
``paged_attention_ref`` against JAX's ``paged_attention_ref`` and the Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerance: 2e-6 absolute, the bound ``tests/test_paged_attention.py`` holds
between interpret mode and the JAX reference (f32 sums in another order);
rows with no live token must be exactly 0 in every version."""

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
