"""Every reference hook the port does not carry yet raises
``NotImplementedError`` naming its ROADMAP tag, instead of running
without it: engine shards, the multi-process engine (DCN),
the standby writer and the process-group supervisor of replication, the
device mesh's names in ``parallel``, ``mesh=``,
the observability routes of the read plane (501 naming [observability]),
every root name of the reference the port lacks (``pw.analysis``) and
``pw.debug.diagnose``, each naming its tag. Compiled ticks without a card
raise the device error; ``pw.graphs``, ``pw.viz`` and every
``pw.stdlib.<name>`` resolve to the port's own modules. Every public name of every package ``__init__`` of the reference
resolves in the port or raises naming a tag, and the names that the port
carries now (the root's, ``pw.temporal``'s, ``pw.debug``'s and
``pw.stdlib.ml``'s) resolve to counterparts with the reference's
signatures."""

import importlib
import inspect
import types
from pathlib import Path

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
    # compiled ticks are ported ([compiled-ticks] is gone): they run on
    # PATHWAY_COMPILED_DEVICE, default cuda, which raises without a card
    ({"PATHWAY_COMPILED_TICK": "1"}, _run_simple, RuntimeError, r"torch\.cuda\.is_available\(\) is False"),
    ({"PATHWAY_ENGINE_SHARDS": "4"}, _run_simple, NotImplementedError, r"\[mesh\]"),
    ({"PATHWAY_PROCESSES": "2"}, _run_simple, NotImplementedError, r"\[mesh\]"),  # the DCN engine
    # the writer's delta stream is ported (PATHWAY_REPL_PORT arms it); the
    # standby writer that takes over its port is not
    ({"PATHWAY_REPL_PORT": "18765"}, lambda: importlib.import_module(
        "pathway_tpu_torch.parallel.standby").main(), NotImplementedError, r"\[replication\]"),
]


@pytest.mark.parametrize(
    "env,run,exc,item", ENV_CASES, ids=[next(iter(c[0])) for c in ENV_CASES]
)
def test_env_hook_raises(monkeypatch, env, run, exc, item):
    monkeypatch.delenv("PATHWAY_COMPILED_DEVICE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(exc, match=item):
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
        # the temporal operators are ported ([temporal] is gone): each of
        # these resolves to the port's own object
        (lambda t: t.windowby(t.a, window=pw.temporal.tumbling(duration=2)), None),
        (lambda t: t.interval_join(t.copy(), t.a, t.a, pw.temporal.interval(-1, 1)), None),
        (lambda t: t.diff(t.a, t.a), None),
        (lambda t: t.b.dt, None),
        # the connectors are ported ([connectors] is gone): a service
        # connector gives the port's own table
        (lambda t: pw.io.debezium.read(input_dir="unused", schema=pw.schema_from_types(a=int, b=str)), None),
        (lambda t: pw.run(with_http_server=True), r"\[observability\]"),
        # the graphs and viz stdlib are ported ([stdlib-rest] is gone)
        (lambda t: pw.stdlib.graphs.pagerank(t.select(u=t.b, v=t.b)), None),
    ],
    ids=[
        "windowby", "interval_join", "diff", "dt_namespace", "io.csv", "http_server", "stdlib.graphs",
    ],
)
def test_unported_kind_raises(make, item):
    """A kind the port lacks raises naming its tag; one it carries now
    (``item`` None) gives the port's own object."""
    if item is None:
        got = make(_table())
        assert type(got).__module__.startswith("pathway_tpu_torch."), type(got)
        return
    with pytest.raises(NotImplementedError, match=item):
        make(_table())


@pytest.mark.parametrize("name", ["ReplicaServer", "FailoverRouter", "ResultCache"])
def test_replica_plane_names_raise(name):
    """The read plane's names resolve (lazily, as in the reference) to the
    ported classes with the reference's signatures; what still raises
    [replication] is the standby writer and the group supervisor."""
    import pathway_tpu.serving as jax_serving
    import pathway_tpu_torch.serving as serving

    port, ref = getattr(serving, name), getattr(jax_serving, name)
    assert port.__module__.startswith("pathway_tpu_torch.serving.")
    assert [p for p in _params(port) if p[0] != "device"] == _params(ref)
    for module, names in (("standby", ("StandbyWriter", "grace_env", "main")),
                          ("supervisor", ("GroupSupervisor", "max_restarts_env", "main"))):
        mod = importlib.import_module(f"pathway_tpu_torch.parallel.{module}")
        for missing in names:
            with pytest.raises(NotImplementedError, match=r"\[replication\]"):
                getattr(mod, missing)


def test_generate_route_raises():
    """``attach_generate`` mounts ``/generate`` on a replica (it raised
    [replication] until the plane was ported); on anything but a replica it
    fails as the reference's does."""
    from pathway_tpu.generate.serving import attach_generate as jax_attach
    from pathway_tpu_torch.generate import GenerateConfig
    from pathway_tpu_torch.generate.scheduler import DecodeScheduler
    from pathway_tpu_torch.generate.serving import attach_generate
    from pathway_tpu_torch.serving.replica import ReplicaServer

    for attach in (jax_attach, attach_generate):
        with pytest.raises(AttributeError, match="replica_id"):
            attach(object())
    srv = ReplicaServer(replica_id=3, index_factory=dict, device="cpu")
    sched = attach_generate(srv, DecodeScheduler(GenerateConfig(kernel="ref"), device="cpu"))
    try:
        assert srv.generate_scheduler is sched and list(srv.extra_post_routes) == ["/generate"]
    finally:
        sched.stop()


def test_repl_port_arms_the_writers_delta_stream(monkeypatch):
    """PATHWAY_REPL_PORT no longer raises: the index exec publishes each
    tick's corpus deltas (the reference's hook)."""
    from pathway_tpu_torch.parallel import replicate

    monkeypatch.setenv("PATHWAY_DCN_SECRET", "unported-test")
    monkeypatch.setenv("PATHWAY_REPL_PORT", "0")
    replicate.reset_publisher()
    try:
        _index_pipeline()
        pub = replicate.publisher()
        assert pub is not None and pub.newest_tick() >= 0 and pub._ticks_published >= 1
    finally:
        replicate.reset_publisher()


def test_observability_routes_of_the_plane_answer_501_naming_the_tag():
    import http.client
    import json

    from pathway_tpu_torch.serving.replica import ReplicaServer
    from pathway_tpu_torch.serving.router import FailoverRouter

    rep = ReplicaServer(replica_id=0, index_factory=dict, device="cpu").start()
    router = FailoverRouter([f"http://127.0.0.1:{rep.http_port}"]).start()
    try:
        for port, path in ((rep.http_port, "/debug/signals"), (rep.http_port, "/debug/trace"),
                           (router.port, "/fleet/metrics"), (router.port, "/fleet/events"),
                           (router.port, "/fleet/trace")):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c.request("GET", path)
            r = c.getresponse()
            body = json.loads(r.read())
            c.close()
            assert r.status == 501 and "[observability]" in body["error"], path
    finally:
        router.stop()
        rep.stop()


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


@pytest.mark.parametrize("name", __import__("pathway_tpu.stdlib").stdlib.__all__)
def test_reference_stdlib_name_raises_with_its_tag(name):
    """Every ``pw.stdlib.<name>`` of the reference resolves to the port's
    own module: none is left to raise a tag since [stdlib-rest] (graphs,
    viz) was ported."""
    assert name not in STDLIB_MISSING
    assert getattr(pw.stdlib, name).__name__ == f"pathway_tpu_torch.stdlib.{name}"


def test_root_name_tags_and_unknown_names():
    # [stdlib-rest] is ported: the graphs and viz stdlib are the port's own
    assert pw.graphs is pw.stdlib.graphs and pw.graphs.__name__ == "pathway_tpu_torch.stdlib.graphs"
    assert pw.viz is pw.stdlib.viz and pw.viz.__name__ == "pathway_tpu_torch.stdlib.viz"
    # [temporal] is ported: its root names are the port's own
    assert pw.temporal.__name__ == "pathway_tpu_torch.stdlib.temporal"
    assert pw.IntervalJoinResult.__module__ == "pathway_tpu_torch.stdlib.temporal._interval_join"
    assert callable(pw.iterate) and callable(pw.sql) and callable(pw.transformer)
    with pytest.raises(AttributeError):
        pw.no_such_name
    with pytest.raises(AttributeError):
        pw.stdlib.no_such_name
    # 12 until LiveTable, load_yaml and demo were ported (``live`` is not in
    # the reference's ``__all__``), 9 until the temporal names were, 2 (and
    # 2 of the stdlib) until graphs and viz were
    assert ROOT_MISSING == ["analysis"] and not STDLIB_MISSING


# root names (and ``pw.stdlib.utils``) that raised [core-api] until the
# port carried them: each resolves to a counterpart with the reference's
# signature (a module: every public name of it). The reference's root
# ``TableSlice`` is an empty placeholder class; the port exports the class
# that ``Table.slice`` returns, so it is held against that class of the
# reference.
PORTED_ROOT = [
    "iterate", "iterate_universe", "transformer", "ClassArg", "attribute",
    "input_attribute", "input_method", "method", "output_attribute", "sql",
    "AsyncTransformer", "pandas_transformer", "udfs", "universes",
    "set_license_key", "set_monitoring_config", "enable_interactive_mode",
    "table_transformer", "TableSlice", "utils", "LiveTable", "live", "load_yaml", "demo",
    "temporal", "ordered", "stateful", "statistical", "AsofJoinResult", "IntervalJoinResult",
    "WindowJoinResult", "graphs",
]
REFERENCE_COUNTERPART = {"TableSlice": ("pathway_tpu.internals.table_slice", "TableSlice")}


def _default(value):
    # a function default (a lambda) compares by its name, not its address
    return value.__qualname__ if inspect.isfunction(value) else repr(value)


def _params(obj):
    return [(p.name, p.kind, _default(p.default)) for p in inspect.signature(obj).parameters.values()]


def _same_api(ref, port, where):
    if isinstance(ref, types.ModuleType):
        assert isinstance(port, types.ModuleType), where
        names = getattr(ref, "__all__", None) or [
            n for n, v in vars(ref).items()
            if not n.startswith("_") and callable(v) and v.__module__ == ref.__name__
        ]
        assert names, where
        for n in names:
            _same_api(getattr(ref, n), getattr(port, n), f"{where}.{n}")
        return
    assert callable(port) and isinstance(port, type) == isinstance(ref, type), where
    if callable(ref):
        assert _params(port) == _params(ref), where


@pytest.mark.parametrize("name", PORTED_ROOT)
def test_ported_root_name_has_the_reference_signature(name):
    import pathway_tpu as jpw

    assert name in pw.__all__ and name not in ROOT_MISSING
    if name in REFERENCE_COUNTERPART:
        module, attr = REFERENCE_COUNTERPART[name]
        ref = getattr(importlib.import_module(module), attr)
    else:
        ref = getattr(jpw, name)
    _same_api(ref, getattr(pw, name), f"pw.{name}")
    if name == "utils":
        assert pw.stdlib.utils is pw.utils


# every package ``__init__`` of the reference, found on disk
REF_ROOT = Path(__file__).resolve().parent.parent / "pathway_tpu"
REF_PACKAGES = sorted(
    ".".join(("pathway_tpu",) + init.parent.relative_to(REF_ROOT).parts)
    for init in REF_ROOT.rglob("__init__.py")
)
RENAMES = {"pallas_topk": "block_topk", "jax_metrics": "torch_metrics"}


def _tags():
    from pathway_tpu_torch import _unported

    return [v.split()[0] for k, v in vars(_unported).items() if k.isupper() and isinstance(v, str)]


def _public_names(module):
    """``__all__``, else the objects of the reference the package binds
    (its own classes and functions and their re-exports; no submodules,
    no ``typing``/numpy helpers)."""
    names = getattr(module, "__all__", None)
    if names is not None:
        return list(names)
    return [
        n for n, v in vars(module).items()
        if not n.startswith("_") and not isinstance(v, types.ModuleType)
        and str(getattr(v, "__module__", "")).startswith("pathway_tpu")
    ]


def _assert_raises_with_tag(fn, what):
    with pytest.raises(NotImplementedError) as e:
        fn()
    assert any(tag in str(e.value) for tag in _tags()), (what, str(e.value))


@pytest.mark.parametrize("package", REF_PACKAGES)
def test_reference_package_names_resolve_or_raise_with_a_tag(package):
    ref = importlib.import_module(package)
    parts = ("pathway_tpu_torch" + package[len("pathway_tpu"):]).split(".")
    for depth in range(len(parts), 0, -1):
        try:
            port = importlib.import_module(".".join(parts[:depth]))
            break
        except ModuleNotFoundError:
            continue
    if depth < len(parts):
        # the port lacks the package: its nearest parent raises for it
        _assert_raises_with_tag(lambda: getattr(port, parts[depth]), package)
        return
    for name in _public_names(ref):
        ported = name
        for old, new in RENAMES.items():
            ported = ported.replace(old, new)
        try:
            getattr(port, ported)
        except NotImplementedError as e:
            assert any(tag in str(e) for tag in _tags()), (package, name, str(e))


@pytest.mark.parametrize("name", ["classifiers", "smart_table_ops", "hmm", "datasets"])
def test_ml_rest_raises_with_its_tag(name):
    """These raised [ml-rest] until the port carried them: each now
    resolves to a module with the reference's public names and
    signatures, and the tag is gone."""
    import pathway_tpu as jpw
    from pathway_tpu_torch import _unported

    assert not hasattr(_unported, "ML_REST")
    _same_api(getattr(jpw.stdlib.ml, name), getattr(pw.stdlib.ml, name), f"pw.stdlib.ml.{name}")


# the service connectors of ``pw.io`` that raised [connectors] until the port
# carried them: each is a module with the reference's public names and
# signatures
CONNECTORS = [
    "airbyte", "bigquery", "debezium", "deltalake", "elasticsearch", "gdrive", "iceberg", "kafka",
    "logstash", "minio", "mongodb", "nats", "postgres", "pubsub", "pyfilesystem", "redpanda", "s3",
    "s3_csv", "sharepoint", "slack", "sqlite",
]


@pytest.mark.parametrize("name", CONNECTORS)
def test_ported_connector_has_the_reference_signature(name):
    import pathway_tpu as jpw
    from pathway_tpu_torch import _unported

    assert not hasattr(_unported, "CONNECTORS") and name in pw.io.__all__
    port = getattr(pw.io, name)
    assert port.__name__ == f"pathway_tpu_torch.io.{name}"
    _same_api(getattr(jpw.io, name), port, f"pw.io.{name}")


# the names ``pw.debug`` raised [core-api] for until the port carried them
PORTED_DEBUG = [
    "StreamGenerator", "table_from_pandas", "table_to_pandas", "table_from_parquet",
    "table_to_parquet", "trace", "trace_tree",
]


@pytest.mark.parametrize("name", PORTED_DEBUG)
def test_ported_debug_name_has_the_reference_signature(name):
    import pathway_tpu as jpw
    from pathway_tpu_torch import _unported

    assert not hasattr(_unported, "CORE_API")
    ref, port = getattr(jpw.debug, name), getattr(pw.debug, name)
    _same_api(ref, port, f"pw.debug.{name}")
    if isinstance(ref, type):
        methods = [n for n, v in vars(ref).items() if callable(v) and not n.startswith("__")]
        assert methods, name
        for m in methods:
            _same_api(getattr(ref, m), getattr(port, m), f"pw.debug.{name}.{m}")


def test_debug_diagnose_keeps_its_tag():
    with pytest.raises(NotImplementedError, match=r"\[observability\]"):
        pw.debug.diagnose
