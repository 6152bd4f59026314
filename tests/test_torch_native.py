"""The port's native host hasher (``pathway_tpu_torch/internals/native.py``
building ``native/pathway_native.cc``): the cases of ``tests/test_native.py``
— hash parity for every value shape against the pure-Python path, int and
float keys alike, batch column hashing, consolidate native and pure-Python,
``DiffBatch.consolidate``'s native path, ``match_fk`` against numpy, join
pruning — each also held bit for bit against the JAX package's keys. Plus:
both packages' extensions live in one process with their own ``Pointer``
types, and the port builds into ``build/pathway_tpu_torch/``."""

import os
from pathlib import Path

import numpy as np
import pytest

import pathway_tpu as jpw
from pathway_tpu.internals import api as japi
from pathway_tpu.internals.native import get_native as jax_native
from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.internals import api, native


@pytest.fixture
def nat():
    mod = native.get_native()
    assert mod is not None, f"the port's native hasher did not build: {native.build_log}"
    return mod


def _port_value(v):
    """A value of the shapes below in the port's own types."""
    if isinstance(v, japi.Pointer):
        return api.Pointer(int(v))
    if isinstance(v, tuple):
        return tuple(_port_value(x) for x in v)
    return v


VALUES = [
    None, True, False, 0, 1, -1, 2**62, -(2**62), 2**70, -(2**100), 1.0, -1.5, 3.14159,
    float("nan"), float("inf"), "", "hello", "ünïcødé", b"", b"\x00\xff", (), (1, 2),
    ("a", (None, 2.0)), [1, "x"], japi.Pointer(12345), {"k": 1}, float(2**53), float(-(2**53) + 1),
    np.int64(7), np.float64(2.5), np.array([1.0, 2.0]),
]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_hash_parity_all_value_shapes(nat, value):
    pv = (_port_value(value),)
    want = api._hash_bytes(api._value_bytes(pv))
    assert nat.hash_value(pv) == want
    assert int(api.ref_scalar(*pv)) == int(japi.ref_scalar(value)) == want


def test_int_float_key_equivalence(nat):
    assert nat.hash_value((1,)) == nat.hash_value((1.0,))
    assert api.ref_scalar(1) == api.ref_scalar(1.0) == int(japi.ref_scalar(1))


def test_batch_column_hashing_matches_scalar(nat):
    cols = [list(range(100)), [f"s{i}" for i in range(100)]]
    arr = api.ref_scalars_columns(cols, 100)
    assert arr.tolist() == japi.ref_scalars_columns(cols, 100).tolist()
    for i in (0, 37, 99):
        assert arr[i] == int(api.ref_scalar(cols[0][i], cols[1][i]))
    # numpy columns and pointer columns serialize from their buffers
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**63, 64, dtype=np.int64).astype(np.uint64)
    ncols = [rng.integers(-9, 9, 64).astype(np.int64), rng.standard_normal(64), api.ptr_column(keys)]
    jcols = ncols[:2] + [japi.ptr_column(keys)]
    assert api.ref_scalars_columns(ncols, 64).tolist() == japi.ref_scalars_columns(jcols, 64).tolist()


def test_native_consolidate_groups_and_drops_zeros(nat):
    keys = np.array([1, 2, 1, 3, 2, 1], dtype=np.uint64)
    vh = np.array([9, 8, 9, 7, 8, 5], dtype=np.uint64)
    diffs = np.array([1, 1, -1, 1, 1, 1], dtype=np.int64)
    idx_b, d_b = nat.consolidate(keys.tobytes(), vh.tobytes(), diffs.tobytes())
    # (1,9): +1-1 dropped; (2,8): 1+1=2; (3,7): 1; (1,5): 1
    assert np.frombuffer(idx_b, dtype=np.int64).tolist() == [1, 3, 5]
    assert np.frombuffer(d_b, dtype=np.int64).tolist() == [2, 1, 1]


def _rows(batch):
    return [(int(k), int(d), repr(v)) for k, d, v in batch.iter_rows()]


def test_consolidate_fallback_matches_native(nat, monkeypatch):
    """Same-key rows with values differing from the first-seen entry cancel
    identically in both paths and both packages, in the same row order."""
    rows = [(1, 1, ("a",)), (1, 1, ("b",)), (1, -1, ("b",)), (2, 1, (float("nan"),)), (2, -1, (float("nan"),)),
            (3, 1, (5,)), (4, 2, (2.5,))]
    native_out = _rows(DiffBatch.from_rows(rows, ["v"]).consolidate())
    monkeypatch.setattr(native, "_native", None)
    monkeypatch.setattr(native, "_tried", True)
    py_out = _rows(DiffBatch.from_rows(rows, ["v"]).consolidate())
    from pathway_tpu.engine.batch import DiffBatch as JaxBatch

    jax_out = _rows(JaxBatch.from_rows(rows, ["v"]).consolidate())
    assert native_out == py_out == jax_out == [(1, 1, "('a',)"), (3, 1, "(5,)"), (4, 2, "(2.5,)")]


def test_diffbatch_consolidate_native_path(nat):
    b = DiffBatch.from_rows([(1, 1, ("a",)), (2, 1, ("b",)), (1, -1, ("a",)), (1, 1, ("a2",))], ["v"])
    got = sorted((int(k), int(d), vals) for k, d, vals in b.consolidate().iter_rows())
    assert got == [(1, 1, ("a2",)), (2, 1, ("b",))]


@pytest.mark.parametrize("n_l,n_r,keyspace", [(100, 50, 20), (5000, 3000, 1000), (200_000, 50_000, 40_000)])
def test_match_fk_against_numpy_reference(nat, monkeypatch, n_l, n_r, keyspace):
    """The C hash-probe join match gives exactly the pair order of the
    numpy sort+searchsorted path (left-input order; equal-key right rows
    in right-input order), and the JAX package's pairs."""
    rng = np.random.default_rng(7)
    left = rng.integers(0, keyspace, size=n_l).astype(np.uint64)
    right = rng.integers(0, keyspace, size=n_r).astype(np.uint64)
    li, ri = api.match_keys(left, right)
    jli, jri = japi.match_keys(left, right)
    monkeypatch.setattr(api, "_native_mod", None)
    pli, pri = api.match_keys(left, right)
    assert li.tolist() == pli.tolist() == jli.tolist() and ri.tolist() == pri.tolist() == jri.tolist()


def test_join_live_cols_pruning_correctness():
    """Bulk join output is identical whether or not the pointer columns are
    pruned, and equal to the JAX package's, keys included."""
    import pathway_tpu_torch as tpw

    def run(pw, with_ids: bool):
        pw.internals.parse_graph.G.clear()

        class L(pw.Schema):
            k: int
            a: int

        class R(pw.Schema):
            k: int
            b: int

        lk = np.random.default_rng(5).integers(0, 500, size=2000)
        lt = pw.debug.table_from_rows(L, [(int(lk[i]), i) for i in range(2000)])
        rt = pw.debug.table_from_rows(R, [(int(i), i * 10) for i in range(500)])
        jr = lt.join(rt, lt.k == rt.k)
        sel = jr.select(lt.a, left_id=lt.id, right_id=rt.id) if with_ids else jr.select(lt.a, rt.b)
        keys, cols = pw.debug.table_to_dicts(sel)
        out = {int(k): tuple(int(cols[c][k]) for c in sorted(cols)) for k in keys}
        pw.internals.parse_graph.G.clear()
        return out

    for with_ids in (False, True):
        port, ref = run(tpw, with_ids), run(jpw, with_ids)
        assert port == ref and len(port) == 2000


def test_two_copies_in_one_process_keep_their_own_pointer_types(nat):
    """Both packages' extensions are loaded; each hashes its own Pointer as
    a Pointer (tag 0x07), not as an int, so neither configure replaced the
    other's type, and the keys agree across the packages."""
    jnat = jax_native()
    assert jnat is not None and jnat is not nat
    assert nat.__name__ == "pathway_tpu_torch._native" and jnat.__name__ == "pathway_tpu._native"
    assert os.path.realpath(nat.__file__) != os.path.realpath(jnat.__file__)
    for raw in (0, 12345, 2**63 + 7):
        as_ptr = api._hash_bytes(api._value_bytes((api.Pointer(raw),)))
        assert nat.hash_value((api.Pointer(raw),)) == jnat.hash_value((japi.Pointer(raw),)) == as_ptr
        # the other package's Pointer is just an int to each extension
        assert nat.hash_value((japi.Pointer(raw),)) == api._hash_bytes(api._value_bytes((raw,)))
    keys = np.array([3, 4], dtype=np.uint64)
    assert (api.ref_scalars_columns([api.ptr_column(keys)], 2).tolist()
            == japi.ref_scalars_columns([japi.ptr_column(keys)], 2).tolist())


def test_the_port_builds_into_its_own_build_directory(nat):
    root = Path(__file__).resolve().parents[1]
    assert native.target().parent == root / "build" / "pathway_tpu_torch"
    assert Path(nat.__file__).resolve() == native.target().resolve()
    assert native.SOURCE == root / "native" / "pathway_native.cc"


def test_no_native_env_keeps_the_pure_python_keys(monkeypatch):
    monkeypatch.setenv("PATHWAY_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_native", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_native() is None
    assert native._tried
