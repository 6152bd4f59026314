"""The port's ``KvLedger`` on the CPU: incremental snapshots (bytes track
churn), drop retracts everything, restore sees exactly the live state; and
across the packages, the same puts give byte-identical segment files, and a
snapshot written by either package restores in the other with the same
pages (bit-equal float32) and metadata.

Tolerance: none — pages are compared bit for bit, metadata by value."""

import os

import numpy as np
import pytest

from pathway_tpu.generate.kv_cache import KvLedger as JaxLedger
from pathway_tpu.generate.kv_cache import seq_jk as jax_seq_jk
from pathway_tpu_torch.generate.kv_cache import KvLedger, seq_jk


def _page(x: float) -> np.ndarray:
    return np.full((1, 2, 8, 128), x, np.float32)


def _meta(seq_id: int, tokens: list[int], n_fed: int, n_pages: int) -> dict:
    return {
        "seq_id": seq_id, "tokens": tokens, "prompt_len": 2, "max_new": 4,
        "temperature": 0.0, "top_k": 1, "seed": 0, "n_fed": n_fed,
        "n_generated": 0, "remaining_ms": 1000.0, "tenant": None, "n_pages": n_pages,
    }


def test_ledger_snapshot_incremental_and_drop(tmp_path):
    """Snapshot bytes track churn (pages already persisted are not
    rewritten) and a dropped sequence's rows leave the ledger."""
    led = KvLedger()
    led.put_page(1, 0, _page(1.0), _page(1.5))
    led.put_page(1, 1, _page(2.0), _page(2.5))
    led.put_seq(1, _meta(1, [1, 2], 2, 2))
    root = str(tmp_path / "led")
    s1 = led.snapshot(root)
    assert s1["segments_written"] >= 1 and s1["bytes_written"] > 0
    # an unchanged ledger re-snapshots for free (same sealed segments)
    s2 = led.snapshot(root)
    assert s2["segments_written"] == 0 and s2["bytes_written"] == 0
    # churn one page per snapshot: amortized bytes follow the churned rows
    churn_bytes = []
    for i in range(4):
        led.put_page(1, 1, _page(3.0 + i), _page(3.5 + i))
        si = led.snapshot(root)
        assert si["bytes_written"] > 0
        churn_bytes.append(si["bytes_written"])
    assert min(churn_bytes) < s1["bytes_written"]
    led2 = KvLedger.restore(root)
    assert set(led2.live_pages()) == {(1, 0), (1, 1)}
    assert np.array_equal(led2.live_pages()[(1, 1)][0], _page(6.0))
    assert led2.live_seqs()[1]["tokens"] == [1, 2]
    # every file the manifest does not name was removed after the commit
    names = sorted(os.listdir(os.path.join(root, "segs")))
    assert all(n.endswith(".seg") and n.startswith(("pages-", "seqs-")) for n in names)
    led2.drop_seq(1)
    led2.snapshot(root)
    led3 = KvLedger.restore(root)
    assert not led3.live_pages() and not led3.live_seqs()
    assert KvLedger.restore(str(tmp_path / "empty")) is None


def test_resident_bytes_counts_the_mirror():
    led = KvLedger()
    led.put_page(3, 0, _page(1.0), _page(2.0))
    parts = led.resident_bytes()
    assert parts["host_mirror"] == 2 * _page(0).nbytes + 16
    assert parts["pages_arrangement"] > 0 and parts["seqs_arrangement"] == 0


def _fill(led, rng: np.random.Generator) -> None:
    for seq_id in (1, 2, 7):
        for page_idx in range(3):
            led.put_page(
                seq_id, page_idx,
                rng.standard_normal((2, 4, 16, 128)).astype(np.float32),
                rng.standard_normal((2, 4, 16, 128)).astype(np.float32),
            )
        led.put_seq(seq_id, _meta(seq_id, [1, seq_id, 5], 3, 3))
    led.drop_seq(2)


def _segment_blobs(root: str) -> dict:
    """{(arrangement, seg_id): bytes} — file names without the epoch."""
    out = {}
    for name in os.listdir(os.path.join(root, "segs")):
        arr, _epoch, seg_id = name[: -len(".seg")].split("-")
        with open(os.path.join(root, "segs", name), "rb") as f:
            out[(arr, int(seg_id))] = f.read()
    return out


def test_same_puts_write_byte_identical_segments(tmp_path):
    assert [seq_jk(i) for i in (0, 1, 99)] == [jax_seq_jk(i) for i in (0, 1, 99)]
    roots = {}
    for name, cls in (("jax", JaxLedger), ("torch", KvLedger)):
        led = cls()
        _fill(led, np.random.default_rng(7))
        roots[name] = str(tmp_path / name)
        led.snapshot(roots[name])
    assert _segment_blobs(roots["jax"]) == _segment_blobs(roots["torch"])


@pytest.mark.parametrize("writer,reader", [(KvLedger, JaxLedger), (JaxLedger, KvLedger)])
def test_snapshot_restores_across_packages(tmp_path, writer, reader):
    led = writer()
    _fill(led, np.random.default_rng(11))
    led.snapshot(str(tmp_path))
    got = reader.restore(str(tmp_path))
    assert isinstance(got, reader)
    want_pages, got_pages = led.live_pages(), got.live_pages()
    assert set(got_pages) == set(want_pages) == {(s, p) for s in (1, 7) for p in range(3)}
    for key, (k, v, ident) in want_pages.items():
        gk, gv, gi = got_pages[key]
        assert gk.dtype == np.float32 and gk.tobytes() == k.tobytes()
        assert gv.tobytes() == v.tobytes() and gi.tolist() == ident.tolist()
    assert got.live_seqs() == led.live_seqs()
    # the reader continues the writer's store incrementally
    got.put_page(1, 0, _page(9.0), _page(9.5))
    assert got.snapshot(str(tmp_path))["segments_written"] >= 1
    again = writer.restore(str(tmp_path))
    assert np.array_equal(again.live_pages()[(1, 0)][0], _page(9.0))
