"""Row keys across the two packages: the port's ``ref_scalar`` /
``ref_scalars_columns``, with its native hasher and with the pure-Python
blake2b path (every case runs under both), must give bit-identical keys
to the JAX package's (its native hasher where built), because every
engine parity test compares row ids. Also ``Pointer`` and
``with_shard_of``."""

import math

import numpy as np
import pytest

from pathway_tpu.internals import api as jax_api
from pathway_tpu.internals.json import Json as JaxJson
from pathway_tpu_torch.internals import api as port_api
from pathway_tpu_torch.internals.json import Json as PortJson
from pathway_tpu_torch.internals.native import get_native


@pytest.fixture(autouse=True, params=["native", "python"])
def hasher(request, monkeypatch):
    """The port's keys through its native hasher, or the pure-Python path."""
    mod = get_native() if request.param == "native" else None
    assert mod is not None or request.param == "python"
    monkeypatch.setattr(port_api, "_native_mod", mod)
    monkeypatch.setattr(port_api, "_native_checked", True)
    return request.param

SCALARS = [
    0, 1, -1, 7, -7, 2**31, -(2**31), 2**62, -(2**62), 2**63 - 1, -(2**63),
    0.0, -0.0, 1.5, -2.25, 1e300, -1e-300, math.inf, -math.inf, math.nan,
    True, False, "", "a", "héllo wörld", "x" * 300, b"", b"\x00\xff",
    None, (), (1, 2), ("a", None, 3.5), ((1,), (2, (3,))),
    np.int64(5), np.int32(-3), np.float64(2.5), np.float32(0.25), np.bool_(True),
]


def _jax_value(v):
    if isinstance(v, tuple):
        return tuple(_jax_value(x) for x in v)
    return v


@pytest.mark.parametrize("value", SCALARS, ids=repr)
def test_ref_scalar_bit_equal(value):
    assert int(port_api.ref_scalar(value)) == int(jax_api.ref_scalar(_jax_value(value)))


@pytest.mark.parametrize(
    "values",
    [(1, "a"), (None, 2.5, True), ("k", -0.0, b"z"), (3, (4, 5), "q"), ()],
    ids=repr,
)
def test_ref_scalar_of_several_values(values):
    assert int(port_api.ref_scalar(*values)) == int(jax_api.ref_scalar(*values))


def test_pointer_values_hash_alike():
    raw = int(jax_api.ref_scalar("doc", 1))
    jp, pp = jax_api.Pointer(raw), port_api.Pointer(raw)
    assert int(pp) == int(jp) and str(pp) == str(jp) and repr(pp) == repr(jp)
    assert int(port_api.ref_scalar(pp)) == int(jax_api.ref_scalar(jp))
    assert int(port_api.ref_scalar(pp, "x")) == int(jax_api.ref_scalar(jp, "x"))


def test_json_values_hash_alike():
    for value in ({"a": [1, 2, {"b": None}]}, [1.5, "s"], 3, "text", None):
        assert int(port_api.ref_scalar(PortJson(value))) == int(
            jax_api.ref_scalar(JaxJson(value))
        )


def test_with_shard_of_bit_equal():
    for a, b in [(1, 2), ("x", "y"), (None, 5.5)]:
        jk = jax_api.ref_scalar(a).with_shard_of(jax_api.ref_scalar(b))
        pk = port_api.ref_scalar(a).with_shard_of(port_api.ref_scalar(b))
        assert int(pk) == int(jk)


def test_ref_scalars_columns_bit_equal():
    rng = np.random.default_rng(0)
    n = 50
    cols = [
        rng.integers(-1000, 1000, n).astype(np.int64),
        rng.standard_normal(n),
        np.array([f"s{i % 7}" for i in range(n)], dtype=object),
        np.array([None if i % 5 == 0 else i for i in range(n)], dtype=object),
    ]
    assert port_api.ref_scalars_columns(cols, n).tolist() == jax_api.ref_scalars_columns(
        cols, n
    ).tolist()
    keys = rng.integers(0, 2**63, n, dtype=np.int64).astype(np.uint64)
    assert port_api.ref_scalars_columns(
        [port_api.ptr_column(keys)], n
    ).tolist() == jax_api.ref_scalars_columns([jax_api.ptr_column(keys)], n).tolist()


def test_sequential_key_matches():
    for i in (0, 1, 12345):
        assert int(port_api.sequential_key(i)) == int(jax_api.sequential_key(i))
