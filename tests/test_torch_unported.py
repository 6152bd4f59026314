"""Every reference hook the port does not carry yet raises
``NotImplementedError`` naming its ROADMAP tag, instead of running
without it: compiled ticks, engine shards, the multi-process engine (DCN),
replication, ``mesh=``, the temporal operators and the ``.dt`` namespace,
the service connectors, the replicated read plane (``ReplicaServer``,
``FailoverRouter``, ``ResultCache`` and the ``/generate`` route), every root
name of the reference the port lacks (``pw.iterate``, ``pw.sql``,
``pw.temporal``, …) and every ``pw.stdlib.<name>`` it lacks, each naming its
tag."""

import numpy as np
import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.stdlib import indexing


@pytest.fixture(autouse=True)
def _fresh_graph():
    parse_graph.G.clear()
    yield
    parse_graph.G.clear()


def _table():
    return pw.debug.table_from_markdown(
        """
        | a | b
      1 | 1 | x
      2 | 2 | y
    """
    )


def _run_simple():
    t = _table()
    pw.io.subscribe(t.select(c=t.a + 1), on_change=lambda **kw: None)
    pw.run()


def _index_pipeline(**kw):
    schema = pw.schema_from_types(vec=np.ndarray)
    docs = pw.debug.table_from_rows(schema, [(np.ones(4, np.float32),)])
    index = indexing.DataIndex(docs, indexing.TpuKnn(docs.vec, dimensions=4, device="cpu", **kw))
    res = index.query_as_of_now(docs.vec, number_of_matches=1).select(r=pw.right.vec)
    pw.io.subscribe(res, on_change=lambda **k: None)
    pw.run()


ENV_CASES = [
    ({"PATHWAY_COMPILED_TICK": "1"}, _run_simple, r"\[compiled-ticks\]"),
    ({"PATHWAY_ENGINE_SHARDS": "4"}, _run_simple, r"\[mesh\]"),
    ({"PATHWAY_PROCESSES": "2"}, _run_simple, r"\[mesh\]"),  # the DCN engine
    ({"PATHWAY_REPL_PORT": "18765"}, _index_pipeline, r"\[replication\]"),
]


@pytest.mark.parametrize(
    "env,run,item", ENV_CASES, ids=[next(iter(c[0])) for c in ENV_CASES]
)
def test_env_hook_raises(monkeypatch, env, run, item):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=item):
        run()


def test_compiled_tick_off_or_unset_runs_the_interpreter(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    _run_simple()
    assert parse_graph.G.last_runtime.compiled_plan is None


def test_tpu_knn_mesh_raises():
    t = _table()
    with pytest.raises(NotImplementedError, match=r"\[mesh\]"):
        indexing.TpuKnn(t.a, dimensions=4, mesh=object(), device="cpu")


@pytest.mark.parametrize(
    "make,item",
    [
        (lambda t: t.windowby(t.a, window=None), r"\[temporal\]"),
        (lambda t: t.interval_join(t, t.a, t.a, None), r"\[temporal\]"),
        (lambda t: t.diff(t.a, t.b), r"\[temporal\]"),
        (lambda t: t.b.dt, r"\[temporal\]"),
        # the file connectors are ported: the case holds a service connector
        (lambda t: pw.io.kafka, r"\[connectors\]"),
        (lambda t: pw.run(with_http_server=True), r"\[observability\]"),
    ],
    ids=[
        "windowby", "interval_join", "diff", "dt_namespace", "io.csv", "http_server",
    ],
)
def test_unported_kind_raises(make, item):
    with pytest.raises(NotImplementedError, match=item):
        make(_table())


@pytest.mark.parametrize("name", ["ReplicaServer", "FailoverRouter", "ResultCache"])
def test_replica_plane_names_raise(name):
    import pathway_tpu_torch.serving as serving

    with pytest.raises(NotImplementedError, match=r"\[replication\]"):
        getattr(serving, name)


def test_generate_route_raises():
    from pathway_tpu_torch.generate.serving import attach_generate

    with pytest.raises(NotImplementedError, match=r"\[replication\].*/generate|/generate.*\[replication\]"):
        attach_generate(object())


def _missing(ref_names, port_module):
    return sorted(n for n in ref_names if n not in port_module.__all__ and n not in ("ml",))


ROOT_MISSING = _missing(__import__("pathway_tpu").__all__, pw)
STDLIB_MISSING = _missing(__import__("pathway_tpu.stdlib").stdlib.__all__, pw.stdlib)


@pytest.mark.parametrize("name", ROOT_MISSING)
def test_reference_root_name_raises_with_its_tag(name):
    from pathway_tpu_torch._unported import ROOT_NAMES

    with pytest.raises(NotImplementedError, match=r"\[[a-z-]+\]") as e:
        getattr(pw, name)
    assert ROOT_NAMES[name].split()[0] in str(e.value) and f"pw.{name}" in str(e.value)


@pytest.mark.parametrize("name", STDLIB_MISSING)
def test_reference_stdlib_name_raises_with_its_tag(name):
    from pathway_tpu_torch._unported import STDLIB_NAMES

    with pytest.raises(NotImplementedError, match=r"\[[a-z-]+\]") as e:
        getattr(pw.stdlib, name)
    assert STDLIB_NAMES[name].split()[0] in str(e.value)


def test_root_name_tags_and_unknown_names():
    assert "[core-api]" in str(pytest.raises(NotImplementedError, getattr, pw, "iterate").value)
    assert "[core-api]" in str(pytest.raises(NotImplementedError, getattr, pw, "sql").value)
    assert "[core-api]" in str(pytest.raises(NotImplementedError, getattr, pw, "transformer").value)
    assert "[temporal]" in str(pytest.raises(NotImplementedError, getattr, pw, "temporal").value)
    with pytest.raises(AttributeError):
        pw.no_such_name
    with pytest.raises(AttributeError):
        pw.stdlib.no_such_name
    assert len(ROOT_MISSING) >= 30 and len(STDLIB_MISSING) == 7


@pytest.mark.parametrize("name", ["classifiers", "smart_table_ops", "hmm", "datasets"])
def test_ml_rest_raises_with_its_tag(name):
    with pytest.raises(NotImplementedError, match=r"\[ml-rest\]"):
        getattr(pw.stdlib.ml, name)
