"""``pw.AsyncTransformer`` of the port against the JAX package's: the same
subclass over the same seeded stream (``__time__``/``__diff__``, with
retractions and an ``instance`` column) gives the same ``successful``,
``failed`` and ``finished`` update streams — keys, diffs, times and values
exact. An ``invoke`` that raises, or returns a result that does not match
``output_schema``, makes its row fail; a failure demotes the later rows of
the same instance to failed, as the reference's second pass does. Options
(``capacity``, ``timeout``, a retry strategy, a cache strategy), ``open``/
``close`` and the signature check behave as in the reference. The cases
are those of ``tests/test_async_transformer.py``. The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import asyncio

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, markdown, stream, streams

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _rows(seed, n=30):
    """(id, value, group, time, diff): inserts over times 2..8, a quarter
    retracted (some in their own tick, which must leave no ghost)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(1, n + 1):
        v, g, t = int(rng.integers(0, 60)), int(rng.integers(0, 5)), int(rng.integers(1, 5)) * 2
        rows.append((i, v, g, t, 1))
        r = rng.random()
        if r < 0.15:
            rows.append((i, v, g, t + 2, -1))
        elif r < 0.25:
            rows.append((i, v, g, t, -1))
    return rows


def _transformer(pw, *, kind="plain", instance=False, seed=0, options=None):
    class Out(pw.Schema):
        ret: int
        tag: str

    class Flaky(pw.AsyncTransformer, output_schema=Out):
        async def invoke(self, value, group) -> dict:
            await asyncio.sleep(0.0005 * (value % 3))
            if value % 7 == 0:
                raise RuntimeError("boom")
            if kind == "bad_result" and value % 5 == 0:
                return {"unexpected": value}
            if kind == "timeout" and value % 4 == 0:
                await asyncio.sleep(0.5)
            return {"ret": value * 10 + group, "tag": f"g{group}"}

    t = pw.debug.table_from_markdown(markdown(["value", "group"], _rows(seed)))
    tr = Flaky(input_table=t, instance=t.group if instance else None)
    if options is not None:
        tr = tr.with_options(**options(pw))
    return tr


CASES = {
    "plain": dict(),
    "instance": dict(instance=True),
    "bad_result": dict(kind="bad_result"),
    "capacity": dict(options=lambda pw: {"capacity": 2}),
    "timeout": dict(kind="timeout", options=lambda pw: {"timeout": 0.1}),
    "instance_seed_1": dict(instance=True, seed=1),
}


@pytest.mark.parametrize("view", ["successful", "failed", "finished"])
@pytest.mark.parametrize("case", list(CASES))
def test_view_stream_equals_reference(case, view):
    got, want = streams(PACKAGES, lambda pw: getattr(_transformer(pw, **CASES[case]), view))
    assert want
    assert_streams_equal(got, want)


def test_instance_failure_demotes_later_rows_like_reference():
    # group 1 fails at time 4; its rows at times 4 and 6 are failed, its
    # row at time 2 stays successful; group 2 never fails
    rows = [(1, 1, 1, 2, 1), (2, 14, 1, 4, 1), (3, 3, 1, 4, 1), (4, 5, 1, 6, 1), (5, 8, 2, 6, 1)]
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()

        class Out(pw.Schema):
            ret: int

        class Flaky(pw.AsyncTransformer, output_schema=Out):
            async def invoke(self, value, group) -> dict:
                if value % 7 == 0:
                    raise RuntimeError("boom")
                return {"ret": value}

        t = pw.debug.table_from_markdown(markdown(["value", "group"], rows))
        out[name] = stream(pw, Flaky(input_table=t, instance=t.group).finished)
    assert_streams_equal(out["port"], out["jax"])
    status = {k: dict(r)["_async_status"] for _t, d, k, r in out["port"] if d > 0}
    assert sorted(status.values()) == ["-FAILURE-"] * 3 + ["-SUCCESS-"] * 2


def test_retry_and_cache_strategies_equal_reference():
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        calls: dict[int, int] = {}

        class Out(pw.Schema):
            ret: int

        class Transient(pw.AsyncTransformer, output_schema=Out):
            async def invoke(self, value, group) -> dict:
                calls[value] = calls.get(value, 0) + 1
                if calls[value] < 3 and value % 2:
                    raise RuntimeError("transient")
                return {"ret": value + 1}

        t = pw.debug.table_from_markdown(markdown(["value", "group"], _rows(2)))
        tr = Transient(input_table=t).with_options(
            retry_strategy=pw.udfs.FixedDelayRetryStrategy(max_retries=4, delay_ms=1),
            cache_strategy=pw.udfs.InMemoryCache(),
        )
        out[name] = (stream(pw, tr.finished), sorted(calls.items()))
    assert_streams_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]


def test_open_close_and_signature_check_like_reference():
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
        seen = []

        class Out(pw.Schema):
            ret: int

        class Inc(pw.AsyncTransformer, output_schema=Out):
            async def invoke(self, value, group) -> dict:
                return {"ret": value}

            def open(self):
                seen.append("open")

            def close(self):
                seen.append("close")

        t = pw.debug.table_from_markdown(markdown(["value", "group"], _rows(0)))
        stream(pw, Inc(input_table=t).successful)
        assert seen == ["open", "close"]

        class Wrong(pw.AsyncTransformer, output_schema=Out):
            async def invoke(self, wrong_name) -> dict:  # pragma: no cover
                return {"ret": 0}

        with pytest.raises(TypeError, match="wrong_name"):
            Wrong(input_table=t)
