"""Every reference hook the port once lacked raised ``NotImplementedError``
naming its ROADMAP tag instead of running without it; the port carries all
of them now, and no tag is left (``_unported.py`` is gone). The elastic
resizing (the segment ferry, the two-phase handover, ``reshard_stores``)
and the autoscaler (``pw.autoscale``, ``/debug/autoscale``) raised [mesh]
until they were ported: their names resolve to the port's with the
reference's signatures, and ``/debug/autoscale`` answers 404 until a
controller is armed, as the reference's does. The standby writer, the process-group
supervisor and ``spawn --supervise`` run now (they raised [replication]
until they were ported): the names resolve to the port's classes with the
reference's signatures, and ``python -m
pathway_tpu_torch.parallel.standby`` without a writer argv refuses as the
reference's does. The multi-process engine runs now (the host mesh, the device group,
``spawn``, the chaos helpers resolve to the port's own modules, and a
process group without its secret refuses to run unauthenticated); engine shards
(``PATHWAY_ENGINE_SHARDS``) and ``TpuKnn(mesh=)`` run sharded now on the
port's in-process mesh, and an engine mesh that cannot be built raises
naming its device; the
observability routes of the read plane answer now (they raised
[observability] until it was ported), and ``pw.analysis`` and
``pw.debug.diagnose`` resolve to the port's Graph Doctor. Compiled ticks without a card
raise the device error; ``pw.graphs``, ``pw.viz`` and every
``pw.stdlib.<name>`` resolve to the port's own modules. Every public name of every package ``__init__`` of the reference
resolves in the port or raises naming a tag, and the names that the port
carries now (the root's, ``pw.temporal``'s, ``pw.debug``'s and
``pw.stdlib.ml``'s) resolve to counterparts with the reference's
signatures."""

import importlib
import importlib.util
import inspect
import types
from pathlib import Path

import numpy as np
import pytest
import torch

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
    replies = []
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: replies.append(row["r"]))
    pw.run()
    return replies


def _run_sharded():
    """A groupby and a join under ``PATHWAY_ENGINE_SHARDS=4`` on the CPU
    mesh: both operators shard, the rows equal an unsharded run's."""
    from pathway_tpu_torch.engine import sharded
    from pathway_tpu_torch.parallel import mesh

    def rows():
        t = _table()
        agg = t.groupby(t.b).reduce(t.b, s=pw.reducers.sum(t.a))
        j = agg.join(t, agg.b == t.b).select(t.a, agg.s)
        return pw.debug.table_to_dicts(j)

    try:
        got = rows()
        rt = parse_graph.G.last_runtime
        kinds = {type(e) for e in rt.execs.values()}
        assert {sharded.ShardedGroupByExec, sharded.ShardedJoinExec} <= kinds
        assert rt.frontier_syncs > 0 and rt.engine_mesh[0].shape == {"data": 4}
        parse_graph.G.clear()
        mesh.set_engine_mesh(None)
        assert got == rows()
    finally:
        mesh.reset_engine_mesh()


def _standby_main_refuses():
    """``standby.main([])`` with PATHWAY_REPL_PORT set: exit 2 and the
    reference's message, in both packages."""
    import contextlib
    import io

    got = []
    for root in ("pathway_tpu", "pathway_tpu_torch"):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = importlib.import_module(f"{root}.parallel.standby").main([])
        got.append((rc, err.getvalue()))
    assert got[0] == got[1] == (2, "nothing to take over with (pass -- <writer argv>)\n"), got


ENV_CASES = [
    # compiled ticks are ported ([compiled-ticks] is gone): they run on
    # PATHWAY_COMPILED_DEVICE, default cuda, which raises without a card
    ({"PATHWAY_COMPILED_TICK": "1"}, _run_simple, RuntimeError, r"torch\.cuda\.is_available\(\) is False"),
    # engine shards are ported: on a CPU mesh the run shards (exc None);
    # on the default cuda mesh without a card it raises naming the device
    ({"PATHWAY_ENGINE_SHARDS": "4", "PATHWAY_MESH_DEVICE": "cpu"}, _run_sharded, None, None),
    ({"PATHWAY_MESH_DEVICE": "cuda", "PATHWAY_ENGINE_SHARDS": "4"}, _run_simple, RuntimeError,
     r"PATHWAY_MESH_DEVICE='cuda'"),
    # the DCN engine is ported: a group without PATHWAY_DCN_SECRET refuses
    # to run unauthenticated (the host mesh's own check)
    ({"PATHWAY_PROCESSES": "2"}, _run_simple, RuntimeError, r"PATHWAY_DCN_SECRET is not set"),
    # the writer's delta stream is ported (PATHWAY_REPL_PORT arms it), and so
    # is the standby writer that takes over its port: without a writer argv
    # it refuses (exit 2) with the reference's message
    ({"PATHWAY_REPL_PORT": "18765"}, lambda: _standby_main_refuses(), None, None),
]


@pytest.mark.parametrize(
    "env,run,exc,item", ENV_CASES, ids=[next(iter(c[0])) for c in ENV_CASES]
)
def test_env_hook_raises(monkeypatch, env, run, exc, item):
    """A hook the port lacks, or cannot run here, raises; one it carries
    now (``exc`` None) runs."""
    from pathway_tpu_torch.parallel import mesh

    for k in ("PATHWAY_COMPILED_DEVICE", "PATHWAY_ENGINE_SHARDS", "PATHWAY_MESH_DEVICE", "PATHWAY_DCN_SECRET"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh.reset_engine_mesh()
    try:
        if exc is None:
            run()
            return
        if "PATHWAY_MESH_DEVICE" in env and torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(exc, match=item):
            run()
    finally:
        mesh.reset_engine_mesh()


MULTI_PROCESS_NAMES = [
    ("pathway_tpu_torch.parallel.host_exchange", "HostMesh"),
    ("pathway_tpu_torch.parallel.host_exchange", "process_env"),
    ("pathway_tpu_torch.parallel.host_exchange", "dcn_active"),
    ("pathway_tpu_torch.parallel.host_exchange", "get_host_mesh"),
    ("pathway_tpu_torch.parallel.distributed", "global_mesh"),
    ("pathway_tpu_torch.parallel.distributed", "sharded_topk_global"),
    ("pathway_tpu_torch.testing", "chaos"),
    ("pathway_tpu_torch.elastic", "FerryReceiver"),
    ("pathway_tpu_torch.elastic", "TwoPhaseHandover"),
    ("pathway_tpu_torch", "autoscale"),
]


@pytest.mark.parametrize("module,name", MULTI_PROCESS_NAMES, ids=[f"{m.split('.')[-1]}.{n}" for m, n in
                                                                   MULTI_PROCESS_NAMES])
def test_multi_process_names_raise_naming_mesh(module, name):
    """Every name of [mesh] raised it until it was ported: the host mesh,
    meshes across processes and the chaos helpers with the multi-process
    engine; the segment ferry, the handover and the autoscaler with the
    elastic resizing. Each resolves now to the port's own object, with the
    reference's public names and signatures."""
    got = getattr(importlib.import_module(module), name)
    assert getattr(got, "__module__", getattr(got, "__name__", "")).startswith("pathway_tpu_torch."), got
    ref_module = "pathway_tpu" + module[len("pathway_tpu_torch"):]
    if isinstance(got, types.ModuleType):
        ref = importlib.import_module(f"{ref_module}.{name}")
        names = getattr(ref, "__all__", None) or [n for n, v in vars(ref).items()
                                                  if not n.startswith("_") and inspect.isfunction(v)
                                                  and v.__module__ == ref.__name__]
        pairs = [(getattr(ref, n), getattr(got, n)) for n in names]
    else:
        pairs = [(getattr(importlib.import_module(ref_module), name), got)]
    for ref, port in pairs:
        if callable(ref):
            # the reference's parameters, then only keyword-only ones of the
            # port's own (``device=``, the card or the CPU; a process group)
            theirs, ours = _params(ref), [p for p in _params(port) if p[0] != "device"]
            assert ours[:len(theirs)] == theirs, (module, name, ref)
            assert all(kind == inspect.Parameter.KEYWORD_ONLY for _n, kind, _d in ours[len(theirs):])
        else:
            assert port == ref, (module, name)


def test_cli_spawn_raises_naming_mesh():
    """``spawn`` raised [mesh] until the multi-process engine was ported, and
    ``--supervise`` raised [replication] until the group supervisor was:
    both run a group now."""
    from pathway_tpu_torch import cli

    assert cli.main(["spawn", "-n", "2", "--", "true"]) == 0
    assert cli.main(["spawn", "-n", "2", "--supervise", "--", "true"]) == 0


def test_compiled_tick_off_or_unset_runs_the_interpreter(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    _run_simple()
    assert parse_graph.G.last_runtime.compiled_plan is None


def test_tpu_knn_mesh_raises():
    """``TpuKnn(mesh=)`` raised [mesh] until the mesh was ported: it now
    searches a corpus sharded over the mesh and answers as unsharded."""
    from pathway_tpu_torch.parallel import make_mesh

    sharded = _index_pipeline(mesh=make_mesh(2, device="cpu"))
    parse_graph.G.clear()
    assert len(sharded) == 1
    np.testing.assert_array_equal(np.asarray(sharded[0]), np.asarray(_index_pipeline()[0]))


def _served_run(t):
    from pathway_tpu_torch.internals import monitoring_server
    from pathway_tpu_torch.observability.signals import reset_sampler

    pw.io.subscribe(t.select(c=t.a + 1), on_change=lambda **kw: None)
    pw.run(with_http_server=True)
    rt = parse_graph.G.last_runtime
    server = rt.http_server
    assert server is not None and server in monitoring_server._servers.values()
    server.shutdown()
    reset_sampler()  # serving armed the process-wide sampler
    return rt


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
        # the monitoring server is ported ([observability] is gone): a
        # served run gives the port's own runtime, its server attached
        (_served_run, None),
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
    ported classes with the reference's signatures; so do the standby
    writer's and the group supervisor's, which raised [replication] until
    they were ported."""
    import pathway_tpu.serving as jax_serving
    import pathway_tpu_torch.serving as serving

    port, ref = getattr(serving, name), getattr(jax_serving, name)
    assert port.__module__.startswith("pathway_tpu_torch.serving.")
    assert [p for p in _params(port) if p[0] != "device"] == _params(ref)
    for module, names in (("standby", ("StandbyWriter", "grace_env", "main")),
                          ("supervisor", ("GroupSupervisor", "max_restarts_env", "main"))):
        mod = importlib.import_module(f"pathway_tpu_torch.parallel.{module}")
        ref = importlib.import_module(f"pathway_tpu.parallel.{module}")
        for ported in names:
            got = getattr(mod, ported)
            assert got.__module__ == f"pathway_tpu_torch.parallel.{module}"
            assert _params(got) == _params(getattr(ref, ported)), ported


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
    """The replica's ``/debug/signals`` and ``/debug/trace`` and the router's
    ``/fleet/*`` answered 501 naming [observability] until it was ported:
    each answers 200 now. ``/debug/autoscale`` of the monitoring server
    answered 501 naming [mesh] until the autoscaler was ported: it answers
    404 now with no controller armed, as the reference's does."""
    import http.client
    import json

    from pathway_tpu_torch.internals import monitoring_server
    from pathway_tpu_torch.serving.replica import ReplicaServer
    from pathway_tpu_torch.serving.router import FailoverRouter

    rep = ReplicaServer(replica_id=0, index_factory=dict, device="cpu").start()
    router = FailoverRouter([f"http://127.0.0.1:{rep.http_port}"]).start()
    mon = monitoring_server.start_http_server(port=0)
    try:
        for port, path, status, tag in (
            (rep.http_port, "/debug/signals", 200, None),
            (rep.http_port, "/debug/trace", 200, None),
            (router.port, "/fleet/metrics", 200, None),
            (router.port, "/fleet/events", 200, None),
            (router.port, "/fleet/trace", 200, None),
            (mon.server_address[1], "/debug/autoscale", 404, "no autoscale controller armed"),
        ):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c.request("GET", path)
            r = c.getresponse()
            body = r.read()
            c.close()
            assert r.status == status, (path, r.status, body[:200])
            if tag is None:
                assert "[observability]" not in body.decode(), path
                if path != "/fleet/metrics":
                    json.loads(body)
            else:
                assert tag in body.decode(), path
    finally:
        mon.shutdown()
        router.stop()
        rep.stop()
        from pathway_tpu_torch.observability.signals import reset_sampler

        reset_sampler()


def _missing(ref_names, port_module):
    return sorted(n for n in ref_names if n not in port_module.__all__ and n not in ("ml",))


ROOT_MISSING = _missing(__import__("pathway_tpu").__all__, pw)
STDLIB_MISSING = _missing(__import__("pathway_tpu.stdlib").stdlib.__all__, pw.stdlib)


@pytest.mark.parametrize("name", ["autoscale"])
def test_reference_root_name_raises_with_its_tag(name):
    """Every reference root name is the port's own now (``ROOT_MISSING`` is
    empty since ``pw.analysis`` was ported). The root subpackage that raised
    its tag longest, ``pw.autoscale`` ([mesh]), resolves now to the port's
    own package with the reference's public names and signatures, and no
    module of unported names is left."""
    import pathway_tpu as jpw

    assert name not in ROOT_MISSING
    assert importlib.util.find_spec("pathway_tpu_torch._unported") is None
    port = getattr(pw, name)
    assert port.__name__ == f"pathway_tpu_torch.{name}"
    ref = importlib.import_module(f"{jpw.__name__}.{name}")
    assert port.__all__ == ref.__all__
    for n in ref.__all__:
        if callable(getattr(ref, n)):
            _same_api(getattr(ref, n), getattr(port, n), f"pw.{name}.{n}")
        else:
            assert getattr(port, n) == getattr(ref, n), n


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
    # 2 of the stdlib) until graphs and viz were, 1 until pw.analysis was
    assert ROOT_MISSING == [] and not STDLIB_MISSING
    assert pw.analysis.__name__ == "pathway_tpu_torch.analysis"


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
    # a function default (a lambda) compares by its name, not its address;
    # an object of either package (a registry) by its class's name
    if inspect.isfunction(value):
        return value.__qualname__
    if type(value).__module__.startswith("pathway_tpu"):
        return type(value).__qualname__
    return repr(value)


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


@pytest.mark.parametrize("package", REF_PACKAGES)
def test_reference_package_names_resolve_or_raise_with_a_tag(package):
    """No tag is left to raise: the port has every package of the reference,
    and every public name of each resolves."""
    ref = importlib.import_module(package)
    port = importlib.import_module("pathway_tpu_torch" + package[len("pathway_tpu"):])
    for name in _public_names(ref):
        ported = name
        for old, new in RENAMES.items():
            ported = ported.replace(old, new)
        getattr(port, ported)


@pytest.mark.parametrize("name", ["classifiers", "smart_table_ops", "hmm", "datasets"])
def test_ml_rest_raises_with_its_tag(name):
    """These raised [ml-rest] until the port carried them: each now
    resolves to a module with the reference's public names and
    signatures, and the tag is gone."""
    import pathway_tpu as jpw
    assert importlib.util.find_spec("pathway_tpu_torch._unported") is None
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
    assert importlib.util.find_spec("pathway_tpu_torch._unported") is None and name in pw.io.__all__
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
    assert importlib.util.find_spec("pathway_tpu_torch._unported") is None
    ref, port = getattr(jpw.debug, name), getattr(pw.debug, name)
    _same_api(ref, port, f"pw.debug.{name}")
    if isinstance(ref, type):
        methods = [n for n, v in vars(ref).items() if callable(v) and not n.startswith("__")]
        assert methods, name
        for m in methods:
            _same_api(getattr(ref, m), getattr(port, m), f"pw.debug.{name}.{m}")


def test_debug_diagnose_keeps_its_tag():
    """``pw.debug.diagnose`` raised [observability] until the Graph Doctor
    was ported; it is the port's own now, with the reference's signature,
    and no tag is left: ``_unported`` is gone."""
    import pathway_tpu as jpw

    assert importlib.util.find_spec("pathway_tpu_torch._unported") is None
    _same_api(jpw.debug.diagnose, pw.debug.diagnose, "pw.debug.diagnose")
    report = pw.debug.diagnose(_table().select(c=pw.this.a * 2))
    assert report.by_rule("graph-stats")
