"""The Graph Doctor of the port (``pathway_tpu_torch.analysis``) against the
JAX package's: the same pipelines, built in each package on a fresh graph
and the same environment, give the same findings — (rule id, severity,
anchored node type, message) with package names and node ids taken out,
compared exactly — for every graph rule and every plane rule;
``pw.run(diagnostics="error")`` raises before any tick in both; the port's
``python -m pathway_tpu_torch.analysis`` exits as the reference's verdict
on the same graph says. The compiled-tick cases of the reference's suite
that wait for the doctor and ``/debug/graph`` run here as port cases."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"port": tpw, "jax": jpw}


NEUTRAL_COVERAGE = {
    "recorder_enabled": True, "serving_active": False, "compiled_ticks": 0,
    "roofline_samples": {"compiled_tick": 0, "topk": 0, "paged_attention": 0},
}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    # ambient knobs would change the env-reading rules; the JAX side runs
    # interpreted (its compiled path needs the jax it lacks)
    for k in list(os.environ):
        if k.startswith("PATHWAY_"):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    # the process-wide state a few rules read (monitoring servers, the
    # signal sampler, Tick Scope's coverage) comes from whatever else ran
    # in this process, differently per package: pin it alike for both
    for name in ("pathway_tpu", "pathway_tpu_torch"):
        ms = __import__(f"{name}.internals.monitoring_server", fromlist=["x"])
        monkeypatch.setattr(ms, "_servers", {})
        __import__(f"{name}.observability.signals", fromlist=["x"]).reset_sampler()
        ts = __import__(f"{name}.observability.tickscope", fromlist=["x"])
        monkeypatch.setattr(ts, "coverage_status", lambda: dict(NEUTRAL_COVERAGE))
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
    from pathway_tpu.serving import degrade as jdeg
    from pathway_tpu_torch.serving import degrade as tdeg

    jdeg.reset()
    tdeg.reset()
    yield
    jdeg.reset()
    tdeg.reset()
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()


_PKG = re.compile(r"pathway_tpu_torch|pathway_tpu")
_ID = re.compile(r"#\d+")


def _norm(diag) -> tuple:
    node = None if diag.node is None else type(diag.node).__name__
    msg = _ID.sub("#N", _PKG.sub("PKG", diag.message))
    return (diag.rule, diag.severity.name, node, msg)


def _report(pw, build, plane: bool, rules=None):
    pw.internals.parse_graph.G.clear()
    build(pw)
    analysis = pw.analysis
    run = analysis.run_plane_doctor if plane else analysis.run_doctor
    return sorted(_norm(d) for d in run(rules=rules))


def _both(build, plane=False, rules=None):
    return {name: _report(pw, build, plane, rules) for name, pw in PACKAGES.items()}


# --- the pipelines (the reference's test_graph_doctor.py fixtures) ---------


def _kv(pw):
    class KV(pw.Schema):
        k: str
        v: int

    return KV


def _closed_subject(pw):
    class Closed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            self.close()

    return Closed()


def _stream(pw):
    return pw.io.python.read(_closed_subject(pw), schema=_kv(pw))


def _static(pw):
    return pw.debug.table_from_markdown(
        """
        k | v
        a | 1
        b | 2
        """
    )


def _static_other(pw):
    return pw.debug.table_from_markdown(
        """
        k | v
        c | 3
        """
    )


def dead_node(pw):
    t = _static(pw)
    t.select(x=pw.this.v * 2)
    a = t.select(y=pw.this.v + 1)
    a.select(z=pw.this.y + 1)
    pw.io.null.write(t.select(pw.this.k))


def dead_column(pw):
    t = _static(pw)
    s = t.select(pw.this.k, unused=pw.this.v * 10, kept=pw.this.v + 1)
    pw.io.null.write(s.select(pw.this.k, pw.this.kept))


def stream_groupby(pw):
    t = _stream(pw)
    r = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    pw.io.null.write(r)


def static_groupby(pw):
    t = _static(pw)
    r = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    pw.io.null.write(r)


def stream_join(pw):
    left, right = _stream(pw), _stream(pw)
    j = left.join(right, left.k == right.k).select(v1=left.v, v2=right.v)
    pw.io.null.write(j)


def stream_dedup_instance(pw):
    t = _stream(pw)
    d = pw.stateful.deduplicate(
        t, value=t.v, instance=t.k, acceptor=lambda new, old: new > old
    )
    pw.io.null.write(d)


def windowed_with_behavior(pw):
    class TS(pw.Schema):
        k: str
        t: int

    t = pw.io.python.read(_closed_subject(pw), schema=TS)
    counts = t.windowby(
        pw.this.t,
        window=pw.temporal.tumbling(duration=10),
        instance=pw.this.k,
        behavior=pw.temporal.common_behavior(cutoff=30),
    ).reduce(k=pw.this._pw_instance, n=pw.reducers.count())
    pw.io.null.write(counts)


def windowed_no_behavior(pw):
    class TS(pw.Schema):
        k: str
        t: int

    t = pw.io.python.read(_closed_subject(pw), schema=TS)
    counts = t.windowby(
        pw.this.t, window=pw.temporal.tumbling(duration=10), instance=pw.this.k
    ).reduce(k=pw.this._pw_instance, n=pw.reducers.count())
    pw.io.null.write(counts)


def universe_restrict(pw):
    t1, t2 = _static(pw), _static_other(pw)
    pw.io.null.write(t2.with_universe_of(t1))


def universe_promised_subset(pw):
    t1, t2 = _static(pw), _static_other(pw)
    t2p = t2.promise_universe_is_subset_of(t1)
    pw.io.null.write(t2p.with_universe_of(t1))


def universe_having(pw):
    t = _static(pw)
    keys = _static_other(pw).select(ptr=t.pointer_from(pw.this.k))
    pw.io.null.write(t.having(keys.ptr))


def concat_promise(pw):
    t1, t2 = _static(pw), _static_other(pw)
    pw.universes.promise_are_pairwise_disjoint(t1, t2)
    pw.io.null.write(t1.concat(t2))


def map_only(pw):
    pw.io.null.write(_static(pw).select(doubled=pw.this.v * 2))


def udf_into_groupby(pw):
    @pw.udf(deterministic=False)
    def wobble(x: int) -> int:
        return x

    t = _static(pw)
    w = t.select(pw.this.k, w=wobble(pw.this.v))
    pw.io.null.write(w.groupby(pw.this.w).reduce(pw.this.w, n=pw.reducers.count()))


def reducers_tuple_sum(pw):
    t = _static(pw)
    r = t.groupby(pw.this.k).reduce(
        pw.this.k,
        hist=pw.reducers.tuple(pw.this.v),
        total=pw.reducers.sum(pw.this.v),
        first=pw.reducers.earliest(pw.this.v),
    )
    pw.io.null.write(r)


def plain_join(pw):
    t, u = _static(pw), _static(pw)
    pw.io.null.write(t.join(u, t.k == u.k).select(t.v))


def interval_join(pw):
    class TS(pw.Schema):
        t: int
        v: int

    a = pw.debug.table_from_rows(TS, [(1, 1), (5, 2)])
    b = pw.debug.table_from_rows(TS, [(2, 3), (6, 4)])
    j = a.interval_join_inner(b, a.t, b.t, pw.temporal.interval(-2, 2)).select(a.v)
    pw.io.null.write(j)


def compile_udf(pw):
    class Num(pw.Schema):
        a: int
        b: float

    t = pw.debug.table_from_rows(Num, [(1, 1.0), (2, 2.0)])
    m = t.select(x=t.a * 2)
    u = m.select(u=pw.apply(lambda x: x + 1, pw.this.x), x=pw.this.x)
    pw.io.null.write(u.select(y=pw.this.u + pw.this.x))


def compile_pure_chain(pw):
    class Num(pw.Schema):
        a: int
        b: float

    t = pw.debug.table_from_rows(Num, [(1, 1.0), (2, 2.0)])
    pw.io.null.write(t.select(x=t.a * 2).filter(pw.this.x > 0))


def monoliths(pw):
    t = _static(pw)
    u = _static_other(pw)
    pw.io.null.write(t.update_rows(u))
    pw.io.null.write(t.sort(key=pw.this.v))
    keys = u.select(ptr=t.pointer_from(pw.this.k))
    pw.io.null.write(t.ix(keys.ptr))
    pw.io.null.write(u.with_universe_of(t))


def numeric_groupbys(pw):
    t = _static(pw)
    numeric = t.select(v=pw.this.v)
    pw.io.null.write(numeric.groupby(pw.this.v).reduce(pw.this.v, n=pw.reducers.count()))


def gated_index(pw, route="/knn", qos=True):
    from importlib import import_module

    http = import_module(f"{pw.__name__}.io.http")
    serving = import_module(f"{pw.__name__}.serving")
    indexing = import_module(f"{pw.__name__}.stdlib.indexing")
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(vec=np.ndarray),
        [(np.asarray([1.0, 0.0], dtype=np.float32),)],
    )
    queries, _writer = http.rest_connector(
        host="127.0.0.1",
        port=18099,
        schema=pw.schema_from_types(q=str),
        route=route,
        qos=serving.QoSConfig() if qos else None,
    )
    qvec = queries.select(
        vec=pw.apply(lambda s: np.asarray([1.0, 0.0], dtype=np.float32), queries.q)
    )
    kw = {"device": "cpu"} if pw is tpw else {}
    index = indexing.DataIndex(docs, indexing.TpuKnn(docs.vec, dimensions=2, **kw))
    reply = index.query_as_of_now(qvec.vec, number_of_matches=1)
    pw.io.null.write(reply.select(score=pw.right._pw_index_reply_score))


def ungated_index(pw):
    gated_index(pw, qos=False)


def gated_generate(pw):
    gated_index(pw, route="/generate")


def ungated_generate(pw):
    gated_index(pw, route="/generate", qos=False)


def transient_and_persisted(pw, tmp=[None]):  # noqa: B006 - one folder per process
    import tempfile

    if tmp[0] is None:
        tmp[0] = tempfile.mkdtemp(prefix="doctor_fs_")
        Path(tmp[0], "a.jsonl").write_text('{"k": "a", "v": 1}\n')
    logged = pw.io.jsonlines.read(tmp[0], schema=_kv(pw), mode="static")
    fixture = _static(pw)
    both = logged.concat_reindex(fixture)
    pw.io.null.write(both.groupby(pw.this.k).reduce(pw.this.k, n=pw.reducers.count()))


def mixed(pw):
    """Every kind at once: a stream, a static fixture, a groupby, a join,
    a sort, a dead table, an unused column."""
    s = _stream(pw)
    t = _static(pw)
    g = s.groupby(pw.this.k).reduce(pw.this.k, total=pw.reducers.sum(pw.this.v))
    j = t.join(g, t.k == g.k).select(t.k, t.v, g.total, spare=t.v * 3)
    pw.io.null.write(j.select(pw.this.k, pw.this.total))
    pw.io.null.write(t.sort(key=pw.this.v, instance=pw.this.k))
    t.select(orphan=pw.this.v + 7)


GRAPH_CASES = {
    "dead_node": (dead_node, {}),
    "dead_column": (dead_column, {}),
    "unbounded_stream_groupby": (stream_groupby, {}),
    "static_groupby": (static_groupby, {}),
    "unbounded_stream_join": (stream_join, {}),
    "unbounded_dedup_instance": (stream_dedup_instance, {}),
    "windowed_with_behavior": (windowed_with_behavior, {}),
    "windowed_no_behavior": (windowed_no_behavior, {}),
    "universe_restrict": (universe_restrict, {}),
    "universe_promised_subset": (universe_promised_subset, {}),
    "universe_having": (universe_having, {}),
    "concat_promise": (concat_promise, {}),
    "map_only": (map_only, {}),
    "shard_nondeterministic_udf": (udf_into_groupby, {}),
    "shard_reducers": (reducers_tuple_sum, {}),
    "join_rowwise_forced": (plain_join, {"PATHWAY_JOIN_ROWWISE": "1"}),
    "join_columnar": (plain_join, {}),
    "interval_join_rowwise": (interval_join, {}),
    "compile_boundary_udf": (compile_udf, {}),
    "compile_pure_chain": (compile_pure_chain, {}),
    "serving_admission_ungated": (ungated_index, {}),
    "unreplicated_gated": (gated_index, {}),
    "replicas_unbounded_staleness": (gated_index, {
        "PATHWAY_SERVING_REPLICAS": "http://127.0.0.1:9101,http://127.0.0.1:9102",
        "PATHWAY_REPL_STANDBY": "127.0.0.1:9200",
    }),
    "replicas_no_standby": (gated_index, {
        "PATHWAY_SERVING_REPLICAS": "http://127.0.0.1:9101,http://127.0.0.1:9102",
        "PATHWAY_SERVING_MAX_STALENESS_MS": "2000",
    }),
    "replicas_single_owner_shards": (gated_index, {
        "PATHWAY_SERVING_REPLICAS": "http://127.0.0.1:9101,http://127.0.0.1:9102",
        "PATHWAY_SERVING_SHARDS": "2",
        "PATHWAY_SERVING_MAX_STALENESS_MS": "2000",
        "PATHWAY_REPL_STANDBY": "127.0.0.1:9200",
    }),
    "shard_map_single_owner": (gated_index, {
        "PATHWAY_SERVING_SHARD_MAP": "127.0.0.1:9101,127.0.0.1:9102|127.0.0.1:9103",
        "PATHWAY_SERVING_MAX_STALENESS_MS": "2000",
    }),
    "tenant_blind_replicated": (gated_index, {
        "PATHWAY_REPL_PORT": "18765", "PATHWAY_ROUTER_CACHE": "1",
    }),
    "tenant_fair_replicated": (gated_index, {
        "PATHWAY_REPL_PORT": "18765", "PATHWAY_TENANT_QOS": "1",
    }),
    "generate_ungated": (ungated_generate, {}),
    "generate_gated_bounded": (gated_generate, {
        "PATHWAY_SERVING_DEADLINE_MS": "5000", "PATHWAY_GENERATE_PAGES": "256",
    }),
    "generate_env_armed": (map_only, {"PATHWAY_GENERATE": "1"}),
    "unrecoverable_state": (transient_and_persisted, {}),
    "observability_replicated_unarmed": (map_only, {
        "PATHWAY_SERVING_REPLICAS": "http://127.0.0.1:9101", "PATHWAY_TRACING": "0",
    }),
    "observability_slo_declared": (map_only, {"PATHWAY_SLO_SHED_RATE": "0.01"}),
    "observability_signals_off": (map_only, {"PATHWAY_SIGNALS": "0"}),
    "mixed": (mixed, {}),
}
# a two-process group: the monolithic execs pin resizes to log replay
# (elastic-resharding); one process per case elsewhere (test_torch_mesh_doctor)
TWO_PROCESS_CASES = {"monoliths_two_processes": (monoliths, {"PATHWAY_PROCESSES": "2"})}


@pytest.mark.parametrize("case", sorted({**GRAPH_CASES, **TWO_PROCESS_CASES}))
def test_graph_rules_equal_the_reference(case, monkeypatch):
    build, env = {**GRAPH_CASES, **TWO_PROCESS_CASES}[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _both(build)
    assert got["port"] == got["jax"]
    assert got["port"], "every case yields at least graph-stats"


def test_every_graph_rule_fires_somewhere(monkeypatch):
    """The cases above reach every one of the 17 graph rules;
    elastic-resharding fires under a two-process topology, in both
    packages."""
    fired: set[str] = set()
    for build, env in {**GRAPH_CASES, **TWO_PROCESS_CASES}.values():
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            fired |= {r for r, *_ in _report(tpw, build, plane=False)}
    assert set(tpw.analysis.RULES) == set(jpw.analysis.RULES)
    assert len(tpw.analysis.RULES) == 17
    assert set(tpw.analysis.RULES) - fired == set()


PLANE_CASES = {
    "monoliths": (monoliths, {}),
    "object_exchange_key": (static_groupby, {}),
    "numeric_exchange_key": (numeric_groupbys, {}),
    "interval_join_monolith": (interval_join, {}),
    "clean_env": (map_only, {}),
    "shard_count_conflict": (map_only, {
        "PATHWAY_SERVING_SHARDS": "3", "PATHWAY_SERVING_SHARD_MAP": "h1:9000|h2:9001",
    }),
    "shard_count_agrees": (map_only, {
        "PATHWAY_SERVING_SHARDS": "2", "PATHWAY_SERVING_SHARD_MAP": "h1:9000|h2:9001",
    }),
    "torn_map_bad_qos": (map_only, {
        "PATHWAY_SERVING_SHARD_MAP": "|||", "PATHWAY_SERVING_MAX_QUEUE": "many",
    }),
    "bad_shard_count": (map_only, {"PATHWAY_SERVING_SHARDS": "three"}),
    "gate_without_deadline": (map_only, {
        "PATHWAY_SERVING_ENABLED": "1", "PATHWAY_SERVING_DEADLINE_MS": "0",
    }),
    "deadline_above_cap": (map_only, {
        "PATHWAY_SERVING_ENABLED": "1", "PATHWAY_SERVING_DEADLINE_MS": "9000",
        "PATHWAY_SERVING_MAX_DEADLINE_MS": "1000",
    }),
    "cache_and_inert_tenancy": (map_only, {
        "PATHWAY_ROUTER_CACHE": "1", "PATHWAY_TENANT_QOS": "1",
    }),
    "resizable_shard_map": (map_only, {"PATHWAY_SERVING_SHARD_MAP": "h1:9000|h2:9001"}),
    "mixed": (mixed, {}),
}


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_plane_rules_equal_the_reference(case, monkeypatch):
    build, env = PLANE_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _both(build, plane=True)
    assert got["port"] == got["jax"]


def test_every_plane_rule_fires_somewhere(monkeypatch):
    fired: set[str] = set()
    for build, env in PLANE_CASES.values():
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            fired |= {r for r, *_ in _report(tpw, build, plane=True)}
    assert set(tpw.analysis.PLANE_RULES) == set(jpw.analysis.PLANE_RULES)
    assert len(tpw.analysis.PLANE_RULES) == 5
    # tickscope-coverage reads Tick Scope's process-wide status: its own test
    assert set(tpw.analysis.PLANE_RULES) - fired == {"tickscope-coverage"}


COVERAGE = {
    "neutral": {},
    "serving_blind": {"recorder_enabled": False, "serving_active": True},
    "broken_roofline": {"compiled_ticks": 12},
    "both": {"recorder_enabled": False, "serving_active": True, "compiled_ticks": 3},
    "roofline_fed": {"compiled_ticks": 3,
                     "roofline_samples": {"compiled_tick": 3, "topk": 0, "paged_attention": 0}},
}


@pytest.mark.parametrize("case", sorted(COVERAGE))
def test_tickscope_coverage_equals_the_reference(case, monkeypatch):
    status = dict(NEUTRAL_COVERAGE, **COVERAGE[case])
    for name in ("pathway_tpu", "pathway_tpu_torch"):
        ts = __import__(f"{name}.observability.tickscope", fromlist=["x"])
        monkeypatch.setattr(ts, "coverage_status", lambda: dict(status))
    got = _both(map_only, plane=True, rules=["tickscope-coverage"])
    assert got["port"] == got["jax"]
    assert bool(got["port"]) == (case not in ("neutral", "roofline_fed"))


def test_rule_subset_and_unknown_ids():
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
        stream_groupby(pw)
    got = {n: sorted(_norm(d) for d in pw.analysis.run_doctor(rules=["unbounded-state"]))
           for n, pw in PACKAGES.items()}
    assert got["port"] == got["jax"] and len(got["port"]) == 1
    for pw in PACKAGES.values():
        with pytest.raises(ValueError, match="unknown rule id"):
            pw.analysis.run_doctor(rules=["bogus-rule"])


@pytest.mark.parametrize("name", ["port", "jax"])
def test_suppression_reaches_the_operator_under_a_result(name):
    pw = PACKAGES[name]
    t = _stream(pw)
    r = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    pw.io.null.write(r)
    assert pw.analysis.run_doctor().by_rule("unbounded-state")
    pw.analysis.suppress(r, "unbounded-state")
    assert not pw.analysis.run_doctor().by_rule("unbounded-state")
    assert pw.analysis.run_doctor().by_rule("shard-exchange")


def _sick(pw, rows):
    t = _stream(pw)
    r = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    pw.io.subscribe(r, on_change=lambda **kw: rows.append(kw))


def test_run_diagnostics_error_raises_before_any_tick():
    seen = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        rows: list = []
        _sick(pw, rows)
        with pytest.raises(pw.analysis.GraphDoctorError) as exc:
            pw.run(diagnostics="error")
        assert rows == [] and pw.internals.parse_graph.G.runtime is None
        assert "unbounded-state" in str(exc.value)
        seen[name] = sorted(_norm(d) for d in exc.value.report)
    assert seen["port"] == seen["jax"]


def test_run_diagnostics_warn_runs_and_bad_mode_raises(caplog):
    import logging

    rows: list = []
    _sick(tpw, rows)
    with caplog.at_level(logging.WARNING, logger="pathway_tpu_torch.analysis"):
        tpw.run(diagnostics="warn")
    assert any("unbounded-state" in r.message for r in caplog.records)
    assert tpw.internals.parse_graph.G.last_runtime.stats.ticks >= 1
    tpw.internals.parse_graph.G.clear()
    _sick(tpw, rows)
    with pytest.raises(ValueError, match="diagnostics"):
        tpw.run(diagnostics="loud")


def test_debug_diagnose_scopes_to_the_table(capsys):
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        t = _static(pw)
        _static(pw).select(z=pw.this.v * 3)
        t2 = t.select(pw.this.k, unused=pw.this.v * 10)
        report = pw.debug.diagnose(t2.select(pw.this.k))
        out[name] = sorted(_norm(d) for d in report)
        assert "graph doctor" in capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert "dead-column" in {r for r, *_ in out["port"]}
    assert "dead-node" not in {r for r, *_ in out["port"]}


# --- the CLI ----------------------------------------------------------------

SCRIPTS = {
    "clean": """
t = pw.debug.table_from_markdown('''
    k | v
    a | 1
''')
pw.io.null.write(t.select(d=pw.this.v * 2))
pw.run()
""",
    "dead_table": """
t = pw.debug.table_from_markdown('''
    k | v
    a | 1
''')
t.select(orphan=pw.this.v + 1)
pw.io.null.write(t.select(pw.this.k))
pw.run()
""",
    "warning_only": """
class KV(pw.Schema):
    k: str
    v: int
class Closed(pw.io.python.ConnectorSubject):
    def run(self):
        self.close()
t = pw.io.python.read(Closed(), schema=KV)
pw.io.null.write(t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v)))
pw.run()
""",
}


class _Run:
    def __init__(self, returncode, stdout, stderr):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def _cli(script: Path | None, *flags: str):
    """``python -m pathway_tpu_torch.analysis`` in this process (its
    ``main``), on a fresh port graph."""
    import contextlib
    import io

    from pathway_tpu_torch.analysis.__main__ import main

    out, err = io.StringIO(), io.StringIO()
    tpw.internals.parse_graph.G.clear()
    argv = [*flags] + ([str(script)] if script is not None else [])
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as exc:  # argparse usage errors
            rc = exc.code
    tpw.internals.parse_graph.G.clear()
    return _Run(rc, out.getvalue(), err.getvalue())


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_cli_exit_code_follows_the_reference_verdict(name, tmp_path):
    from pathway_tpu.analysis import Severity

    # the reference's verdict on the same graph, in process
    jpw.internals.parse_graph.G.clear()
    exec(compile("import pathway_tpu as pw\nimport pathway_tpu.internals.run as _r\n"
                 "_r._build_only = True\n" + SCRIPTS[name], name, "exec"), {})
    import pathway_tpu.internals.run as jrun

    jrun._build_only = False
    report = jpw.analysis.run_doctor(outputs=list(jpw.internals.parse_graph.G.outputs))
    for fail_on in ("error", "warning"):
        want = int(report.count_at_least(Severity.parse(fail_on)) > 0)
        script = tmp_path / f"{name}.py"
        script.write_text("import pathway_tpu_torch as pw\n" + SCRIPTS[name])
        res = _cli(script, "--fail-on", fail_on)
        assert res.returncode == want, res.stdout + res.stderr
    res = _cli(script, "--json", "--fail-on", "never")
    assert res.returncode == 0, res.stderr
    rules = {f["rule"] for f in json.loads(res.stdout)}
    assert rules == {d.rule for d in report}


def test_cli_rule_filter_unknown_rule_and_script_requirement(tmp_path):
    script = tmp_path / "clean.py"
    script.write_text("import pathway_tpu_torch as pw\n" + SCRIPTS["clean"])
    res = _cli(script, "--json", "--fail-on", "never", "--rule", "graph-stats")
    assert res.returncode == 0 and {f["rule"] for f in json.loads(res.stdout)} == {"graph-stats"}
    res = _cli(script, "--rule", "bogus-rule")
    assert res.returncode == 2 and "unknown rule id" in res.stderr
    res = _cli(None)
    assert res.returncode == 2 and "script is required" in res.stderr


def test_cli_plane_proves_the_launch_ledger_and_writes_its_manifest(tmp_path):
    script = tmp_path / "clean.py"
    script.write_text("import pathway_tpu_torch as pw\n" + SCRIPTS["clean"])
    manifest = tmp_path / "ledger.json"
    # the module entry point itself, in a process of its own
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "pathway_tpu_torch.analysis", "--plane", "--json",
         "--manifest", str(manifest), str(script)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=240,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(res.stdout)
    assert doc["lowering"]["platform"] == "sm_90a"
    statuses = {c["status"] for c in doc["lowering"]["cases"]}
    assert statuses == {"proved", "rejected"}
    assert json.loads(manifest.read_text())["content_sha256"] == doc["lowering"]["content_sha256"]
    # a shape the gate refuses is an ERROR finding naming the rule
    res = _cli(script, "--plane", "--json", "--manifest", "none",
               "--prove-shape", "paged_attention:head_dim=129")
    assert res.returncode == 1
    assert any("vector-width" in f["message"] for f in json.loads(res.stdout)["findings"])


# --- the compiled-tick cases that waited for the doctor and /debug/graph ----


def _public_build_and_collect(pw):
    class Num(pw.Schema):
        a: int
        b: float

    rng = np.random.default_rng(7)
    rows = [(int(a), float(b)) for a, b in zip(rng.integers(-50, 50, 64), rng.normal(size=64))]
    t = pw.debug.table_from_rows(Num, rows)
    r = t.select(x=t.a * 2 + 1, y=t.b - t.a).filter(pw.this.x > 0).select(
        z=pw.this.x + 1, y=pw.this.y
    )
    keys, cols = pw.debug.table_to_dicts(r)
    return keys, cols, pw.internals.parse_graph.G.last_runtime


def test_debug_graph_reports_segments(monkeypatch):
    from pathway_tpu_torch.observability.debug import graph_table

    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "1")
    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cpu")
    monkeypatch.setenv("PATHWAY_COMPILED_MIN_ROWS", "1")
    _, cols, rt = _public_build_and_collect(tpw)
    rows = graph_table(rt)
    assert [r["id"] for r in rows] == [n.id for n in rt.order]
    tails = [r for r in rows if r.get("segment_tail")]
    assert tails, "no segment tail rows in /debug/graph"
    assert any(r["compiled_ticks"] > 0 for r in tails)
    assert all(r["fallback_ticks"] == 0 for r in tails)
    assert all("compiled" in r for r in rows)
    # the JAX package's table over its interpreted run has the same keys
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    jpw.internals.parse_graph.G.clear()
    _, jcols, jrt = _public_build_and_collect(jpw)
    from pathway_tpu.observability.debug import graph_table as jgraph_table

    jrows = jgraph_table(jrt)
    assert len(jrows) == len(rows)
    assert [sorted(r) for r in jrows] == [
        sorted(k for k in r if k not in ("segment", "segment_tail", "compiled_ticks",
                                          "fallback_ticks")) for r in rows
    ]
    assert [r["type"] for r in jrows] == [r["type"] for r in rows]
    assert sorted(cols["z"].values()) == sorted(jcols["z"].values())


def test_doctor_compile_boundary_names_udf():
    out = _both(compile_udf)
    assert out["port"] == out["jax"]
    diags = [d for d in out["port"] if d[0] == "compile-boundary"]
    assert diags, "expected a compile-boundary diagnostic for the UDF"
    assert any("UDF" in d[3] or "udf" in d[3] for d in diags)


def test_doctor_compile_boundary_negative_pure_chain():
    out = _both(compile_pure_chain)
    assert out["port"] == out["jax"]
    assert not [d for d in out["port"] if d[0] == "compile-boundary"]
