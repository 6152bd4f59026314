"""The port's own copies of the arrangement and the segment codec against the
JAX package's: the same seeded append/retract/seal/compact sequence gives the
same consolidated ``entries()``, the same segment gives the same bytes, and
each package's ``load_arrangement`` reads the other's segment files.

Tolerance: none — every comparison is exact (entries by value, segments by
bytes)."""

import json

import numpy as np
import pytest

from pathway_tpu.engine import arrangement as jax_arr
from pathway_tpu.persistence import segments as jax_seg
from pathway_tpu_torch.engine import arrangement as port_arr
from pathway_tpu_torch.engine import batch as port_batch
from pathway_tpu_torch.persistence import segments as port_seg


def _ops(seed: int, n_ops: int = 40):
    """A seeded list of (kind, payload) operations over a small key space:
    inserts, retractions of live rows, seals and compactions. Value columns:
    int64 (raw), uniform float32 [2, 3] ndarrays (stacked), dicts (pickle)."""
    rng = np.random.default_rng(seed)
    live: dict[tuple[int, int], tuple] = {}
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.1:
            ops.append(("seal", None))
            continue
        if r < 0.15:
            ops.append(("compact", None))
            continue
        m = int(rng.integers(1, 6))
        jks, keys, diffs, c0, c1, c2 = [], [], [], [], [], []
        for _j in range(m):
            if live and rng.random() < 0.35:
                pair = list(live)[int(rng.integers(len(live)))]
                vals = live.pop(pair)
                diff = -1
            else:
                pair = (int(rng.integers(0, 8)), int(rng.integers(0, 1 << 40)))
                vals = (
                    int(rng.integers(-100, 100)),
                    rng.standard_normal((2, 3)).astype(np.float32),
                    {"n": int(rng.integers(0, 9)), "t": [int(x) for x in rng.integers(0, 50, 3)]},
                )
                live[pair] = vals
                diff = 1
            jks.append(pair[0])
            keys.append(pair[1])
            diffs.append(diff)
            c0.append(vals[0])
            c1.append(vals[1])
            c2.append(vals[2])
        ops.append(("append", (jks, keys, diffs, c0, c1, c2)))
    return ops


def _run(mod, ops):
    arr = mod.Arrangement(3, max_segments=4, compact_ratio=0.5)
    for kind, payload in ops:
        if kind == "seal":
            arr.seal()
        elif kind == "compact":
            arr.compact()
        else:
            jks, keys, diffs, c0, c1, c2 = payload
            arr.append(
                np.array(jks, np.uint64),
                np.array(keys, np.uint64),
                np.array(diffs, np.int64),
                [
                    np.array(c0, np.int64),
                    port_batch._obj_column(c1),
                    port_batch._obj_column(c2),
                ],
            )
    return arr


def _entries(arr) -> list:
    rows = arr.entries()
    out = []
    for i in range(len(rows)):
        out.append((
            int(rows.jk[i]), int(rows.key[i]), int(rows.count[i]), int(rows.age[i]),
            int(rows.cols[0][i]), rows.cols[1][i].tobytes(), json.dumps(rows.cols[2][i]),
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_ops_same_entries(seed):
    ops = _ops(seed)
    a, b = _run(jax_arr, ops), _run(port_arr, ops)
    assert _entries(a) == _entries(b)
    assert a.segment_sizes() == b.segment_sizes()
    assert a.resident_bytes() == b.resident_bytes()
    assert len(a) == len(b) and a.merges == b.merges and a.compactions == b.compactions


@pytest.mark.parametrize("seed", [4, 5])
def test_segments_byte_identical_and_cross_loadable(seed):
    ops = _ops(seed)
    a, b = _run(jax_arr, ops), _run(port_arr, ops)
    man_a, man_b = jax_seg.manifest_of(a), port_seg.manifest_of(b)
    assert {k: v for k, v in man_a.items() if k != "epoch"} == {
        k: v for k, v in man_b.items() if k != "epoch"
    }
    blobs_a = {s.seg_id: jax_seg.segment_to_bytes(s) for s in a.segments}
    blobs_b = {s.seg_id: port_seg.segment_to_bytes(s) for s in b.segments}
    assert blobs_a == blobs_b and blobs_a
    # each package loads the other's segments
    loaded_b = port_seg.load_arrangement(man_a, blobs_a.get)
    loaded_a = jax_seg.load_arrangement(man_b, blobs_b.get)
    assert isinstance(loaded_b, port_arr.Arrangement)
    assert _entries(loaded_b) == _entries(a) == _entries(loaded_a)
    assert loaded_b.epoch == a.epoch and loaded_a.epoch == b.epoch


def test_segment_header_is_the_reference_format():
    arr = port_arr.Arrangement(1)
    arr.append(
        np.array([1, 2], np.uint64), np.array([3, 4], np.uint64), np.array([1, 1], np.int64),
        [np.array([7, 8], np.int64)],
    )
    arr.seal()
    blob = port_seg.segment_to_bytes(arr.segments[0])
    assert blob.startswith(b"PWSEG01\n") and port_seg.MAGIC == jax_seg.MAGIC
    seg = jax_seg.segment_from_buffer(blob)
    assert seg.jks.tolist() == [1, 2] and seg.cols[0].tolist() == [7, 8]
    with pytest.raises(ValueError):
        port_seg.segment_from_buffer(b"NOTASEG!" + blob[8:])


def test_knobs_have_the_reference_names(monkeypatch):
    monkeypatch.setenv("PATHWAY_ARRANGE_MAX_SEGMENTS", "3")
    monkeypatch.setenv("PATHWAY_ARRANGE_COMPACT_RATIO", "0.9")
    a, b = jax_arr.Arrangement(1), port_arr.Arrangement(1)
    assert (a.max_segments, a.compact_ratio) == (b.max_segments, b.compact_ratio) == (3, 0.9)


def test_column_helpers_match():
    from pathway_tpu.engine import batch as jax_batch
    from pathway_tpu.internals.api import expand_ranges

    starts, counts = np.array([5, 0, 9]), np.array([2, 0, 3])
    assert port_batch.expand_ranges(starts, counts).tolist() == expand_ranges(starts, counts).tolist()
    parts = [np.array([1, 2], np.int64), np.array([0.5])]
    assert port_batch.concat_columns(parts).tolist() == jax_batch.concat_columns(parts).tolist()
    assert port_batch.concat_columns(parts).dtype == object
    col = port_batch._obj_column([np.zeros((2, 2), np.float32)] * 3)
    assert port_batch.uniform_element_spec(col) == jax_batch.uniform_element_spec(col)
    assert port_batch.uniform_element_spec(port_batch._obj_column([1, "a"])) is None
