"""``DataIndex`` over ``TpuKnn`` in the port's engine (``device="cpu"``: the
kernel's wrapper runs its plain version) against the JAX package's, on the
same seeded streams: documents upserted and deleted across ticks, queries
answered as of now and live (``query`` re-answers after every corpus
change), with and without a metadata filter. The full update streams must
agree: times, diffs, row ids and matched ids exactly, scores within
atol 1e-5. The JAX side runs its interpreter (``PATHWAY_COMPILED_TICK=0``)."""

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.stdlib.indexing import DataIndex as JaxDataIndex, TpuKnn as JaxTpuKnn
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from pathway_tpu_torch.stdlib.indexing import DataIndex as PortDataIndex, TpuKnn as PortTpuKnn

DIM = 16
N_DOCS = 48
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _doc_events(seed=0):
    """(name, vec, meta, time, diff): inserts at t=2, upserts (retract +
    insert of the same key) and deletions at t=4 and t=6, late inserts
    at t=8."""
    rng = np.random.default_rng(seed)
    vec = lambda: rng.standard_normal(DIM).astype(np.float32)  # noqa: E731
    first = {f"d{i}": (vec(), {"lang": "en" if i % 3 else "fr", "n": i}) for i in range(N_DOCS)}
    events = [(n, v, m, 2, 1) for n, (v, m) in first.items()]
    for i in range(0, N_DOCS, 5):  # upserts
        n = f"d{i}"
        v, m = first[n]
        events += [(n, v, m, 4, -1), (n, vec(), m, 4, 1)]
    for i in range(3, N_DOCS, 7):  # deletions
        n = f"d{i}"
        if i % 5:
            v, m = first[n]
            events.append((n, v, m, 6, -1))
    events += [(f"late{i}", vec(), {"lang": "fr", "n": 100 + i}, 8, 1) for i in range(6)]
    return events


def _query_events(seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i, t in enumerate([2, 2, 4, 6, 6, 8, 8]):
        flt = "lang == 'fr'" if i % 2 else None
        out.append((f"q{i}", rng.standard_normal(DIM).astype(np.float32), flt, t, 1))
    return out


def _norm(v):
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    if type(v).__name__ == "Pointer":
        return int(v)
    return v


def _run(pw, DataIndex, TpuKnn, live, k, **dev):
    class doc_schema(pw.Schema):
        name: str = pw.column_definition(primary_key=True)
        vec: np.ndarray
        meta: dict

    class q_schema(pw.Schema):
        qname: str = pw.column_definition(primary_key=True)
        vec: np.ndarray
        filter: str | None

    docs = pw.debug.table_from_rows(doc_schema, _doc_events(), is_stream=True)
    queries = pw.debug.table_from_rows(q_schema, _query_events(), is_stream=True)
    index = DataIndex(docs, TpuKnn(docs.vec, docs.meta, dimensions=DIM, **dev))
    ask = index.query if live else index.query_as_of_now
    result = ask(queries.vec, number_of_matches=k, metadata_filter=queries["filter"]).select(
        qname=pw.left.qname,
        names=pw.right.name,
        ids=pw.right._pw_index_reply_id,
        scores=pw.right._pw_index_reply_score,
    )
    events = []

    def on_change(key, row, time, is_addition):
        events.append((time, 1 if is_addition else -1, int(key), {c: _norm(v) for c, v in row.items()}))

    pw.io.subscribe(result, on_change=on_change)
    pw.run()
    return sorted(events, key=lambda e: (e[0], e[1], e[2]))


@pytest.mark.parametrize("live", [False, True], ids=["as_of_now", "live"])
@pytest.mark.parametrize("k", [1, 4])
def test_data_index_stream_equals_reference(live, k):
    ref = _run(jpw, JaxDataIndex, JaxTpuKnn, live, k)
    port = _run(tpw, PortDataIndex, PortTpuKnn, live, k, device="cpu")
    assert len(ref) >= len(_query_events())
    assert [e[:3] for e in port] == [e[:3] for e in ref]
    for (_t, _d, _key, p), (_t2, _d2, _key2, r) in zip(port, ref):
        assert p["qname"] == r["qname"]
        assert p["names"] == r["names"] and p["ids"] == r["ids"]
        np.testing.assert_allclose(p["scores"], r["scores"], atol=ATOL, rtol=0)


def test_live_query_is_re_answered_after_upserts():
    port = _run(tpw, PortDataIndex, PortTpuKnn, True, 4, device="cpu")
    times_q0 = [t for t, d, _k, row in port if row["qname"] == "q0" and d > 0]
    assert len(times_q0) > 1 and times_q0[0] == 2


def test_filtered_replies_hold_only_matching_documents():
    port = _run(tpw, PortDataIndex, PortTpuKnn, False, 4, device="cpu")
    fr = {f"d{i}" for i in range(N_DOCS) if i % 3 == 0} | {f"late{i}" for i in range(6)}
    filtered = [row for _t, d, _k, row in port if d > 0 and int(row["qname"][1:]) % 2]
    assert filtered and all(set(row["names"]) <= fr for row in filtered)


def test_deleted_documents_leave_the_replies():
    port = _run(tpw, PortDataIndex, PortTpuKnn, True, 4, device="cpu")
    deleted = {f"d{i}" for i in range(3, N_DOCS, 7) if i % 5}
    late = [row for t, d, _k, row in port if d > 0 and t >= 6]
    assert late and not any(set(row["names"]) & deleted for row in late)
