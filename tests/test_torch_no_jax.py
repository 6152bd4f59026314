"""pathway_tpu_torch, chip_smoke.py and tools/ stand alone: every module of the port
imports with ``jax``, ``flax`` and ``pathway_tpu`` blocked, and no source
file names them in an import. The engine, the Table API and the root
package also import with ``pandas`` blocked (the card's machine has none),
and no module of the port imports it at module level. The RAG layer
(``xpacks/llm``) imports with the HTTP and API clients blocked too
(``requests``, ``openai``, ``litellm``, ``aiohttp``, ``flashrank``, …): the
card's machine has none of them, and no port module imports one at module
level. The REST connector and the Surge Gate (``io/http``, ``serving``)
import with the clients blocked as well, and a port server started with
``aiohttp`` and ``requests`` blocked answers over HTTP without loading
either. The in-process device mesh (``parallel.mesh``, ``exchange``,
``collectives``, the sharded execs, ``sharded_topk``, the mesh encoder)
imports with them blocked, and a sharded run loads neither. So do the
replicated read plane's modules (``parallel``, the
replica, the router, the result cache, ``/generate``), which import
neither anywhere, and a writer's stream, a replica and a router with its
cache answer with both blocked. The persistence glue, its stores and the file connectors import
with ``pandas`` and ``fsspec`` blocked, and a persisted ``pw.io.fs`` run
stops and restores from its store without loading either (``fsspec`` is
imported only when an ``FsspecStore`` is built). The rest of the Table API
(``iterate``, ``sql``, the row transformers, ``AsyncTransformer``,
``pandas_transformer``, ``pw.stdlib.utils``, ``pw.udfs``, ``pw.universes``)
imports with ``pandas`` blocked, and a pipeline over all of them but
``pandas_transformer`` runs without loading it; ``pandas_transformer``
needs pandas only when its operator runs. The temporal operators
(``pw.temporal``, ``.dt``, ``pw.ordered``, ``pw.stateful``,
``pw.statistical``) import with ``pandas`` blocked, and windows under a
behavior and the interval and asof joins over int times run without
loading it. Every connector of ``pw.io`` imports with pyarrow, fsspec,
pandas, ``requests`` and every broker, database and cloud client blocked,
none imports one at module level, and the card's CDC path (a SQLite table
streamed through the embedder into ``TpuKnn``, the replies written back
with ``pw.io.sqlite.write``, the Debezium stream read beside it) runs with
all of them blocked. The compiled ticks, the native hasher's loader and the
graphs and viz stdlib import with ``pandas``, ``rich`` and ``bokeh`` blocked,
and a compiled chain on the CPU, pagerank and ``pw.viz.plot``'s refusal run
with them blocked. The Graph Doctor, the launch ledger, the debug surfaces,
signals, fleet federation, the monitoring server and its dashboard import
with ``pandas``, ``rich`` and ``bokeh`` blocked, and a monitored, diagnosed
run serves its routes with them blocked. The multi-process engine (the host mesh, the device
group, the DCN execs, ``spawn``, the chaos helpers, the group supervisor and
the standby writer) imports with pandas and the clients blocked, and a
two-process group spawned through the CLI runs a groupby and a join and
searches ``sharded_topk_global`` on gloo with them blocked in every rank;
so does a supervised group, in both of its incarnations. The elastic
resizing (the segment ferry, the handover, ``reshard_stores``) and the
autoscaler import with them blocked, and a ferry sender and receiver in two
processes commit a transfer with them blocked. Without a card, an entry point left
on its default device (compiled ticks included) raises instead of falling
back to the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pathway_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "pathway_tpu")
BLOCKED_WITH_PANDAS = BLOCKED + ("pandas",)
# clients the RAG layer imports only inside the call that needs them
# (``google.generativeai`` is checked in the sources only: the ``google``
# namespace may be loaded at interpreter start by other packages)
CLIENTS = (
    "requests", "openai", "litellm", "aiohttp", "flashrank", "cohere",
    "transformers", "pypdf", "unstructured", "docling",
)
BLOCKED_WITH_CLIENTS = BLOCKED_WITH_PANDAS + CLIENTS
BLOCKED_WITH_FSSPEC = BLOCKED_WITH_PANDAS + ("fsspec",)
# packages the last slice imports only inside the calls that need them
BLOCKED_WITH_ML = BLOCKED_WITH_PANDAS + ("yaml", "pyarrow", "sklearn")
# the clients, lake and object-store libraries the connectors import only
# inside the calls that need them (the ``google`` namespace is checked in
# the sources only, as above)
CONNECTOR_CLIENTS = ("confluent_kafka", "nats", "pymongo", "psycopg2", "psycopg", "googleapiclient", "s3fs", "fs")
BLOCKED_WITH_CONNECTOR_CLIENTS = BLOCKED_WITH_CLIENTS + ("pyarrow", "fsspec") + CONNECTOR_CLIENTS
# the compiled ticks, the native hasher's loader and the graphs and viz
# stdlib import with pandas, rich and bokeh blocked too (viz imports them
# inside its functions)
BLOCKED_WITH_VIZ = BLOCKED_WITH_PANDAS + ("rich", "bokeh")
COMPILED_MODULES = [
    "pathway_tpu_torch.engine.compile",
    "pathway_tpu_torch.internals.native",
    "pathway_tpu_torch.stdlib.graphs",
    "pathway_tpu_torch.stdlib.viz",
]
# modules that may import pandas at module level: none (the ``.dt``
# namespace, the reference's one such module, imports it inside its methods)
PANDAS_MODULES: set[str] = set()

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import pathway_tpu_torch
mods = ["pathway_tpu_torch"]
for info in pkgutil.walk_packages(pathway_tpu_torch.__path__, "pathway_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print(len(mods))
"""

_DEFAULT_DEVICE_RAISES = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
assert not torch.cuda.is_available()
from pathway_tpu_torch.ops.knn import DeviceCorpus
from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
from pathway_tpu_torch.xpacks.llm._encoder import EncoderRuntime
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker
from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer
from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig
from pathway_tpu_torch.xpacks.llm.decoder import DecoderConfig, empty_pools
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.stdlib.indexing import DataIndex, IvfKnn, LshKnn, TpuKnn
from pathway_tpu_torch.stdlib.indexing._index_impls import IvfKnnIndex, LshKnnIndex
from pathway_tpu_torch.ops.ivf import IvfDeviceIndex, assign_clusters
from pathway_tpu_torch.ops.lsh import make_projections
from pathway_tpu_torch.serving.replica import ReplicaServer


def _knn_pipeline_on_default_device(inner=TpuKnn):
    pw.internals.parse_graph.G.clear()
    docs = pw.debug.table_from_rows(pw.schema_from_types(v=np.ndarray), [(np.ones(4),)])
    index = DataIndex(docs, inner(docs.v, dimensions=4))
    res = index.query_as_of_now(docs.v, number_of_matches=1).select(r=pw.right.v)
    pw.io.subscribe(res, on_change=lambda **kw: None)
    pw.run()


def _compiled_ticks_on_default_device():
    import os

    os.environ["PATHWAY_COMPILED_TICK"] = "1"
    try:
        pw.internals.parse_graph.G.clear()
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,), (2,)])
        pw.io.subscribe(t.select(b=t.a * 2), on_change=lambda **kw: None)
        pw.run()
    finally:
        del os.environ["PATHWAY_COMPILED_TICK"]


def _ml_knn_index_on_default_device():
    pw.internals.parse_graph.G.clear()
    docs = pw.debug.table_from_rows(pw.schema_from_types(v=np.ndarray), [(np.ones(4),)])
    res = pw.stdlib.ml.KNNIndex(docs.v, docs, n_dimensions=4).get_nearest_items(docs.v, k=1)
    pw.io.subscribe(res, on_change=lambda **kw: None)
    pw.run()


for make in (
    lambda: TpuDenseKnnIndex(dimensions=8),
    lambda: DeviceCorpus(8),
    lambda: EncoderRuntime(vocab_size=50, dim=8, depth=1, heads=2, max_len=16),
    lambda: SentenceTransformerEmbedder(dim=8, depth=1, heads=2, max_len=16),
    lambda: CrossEncoderReranker(dim=8, depth=1, heads=2, max_len=16),
    lambda: VectorStoreServer(
        pw.debug.table_from_rows(pw.schema_from_types(data=bytes), [(b"x",)]),
        embedder=SentenceTransformerEmbedder(dim=8, depth=1, heads=2, max_len=16, device="cpu"),
    ),
    lambda: DecodeScheduler(),
    lambda: DecodeScheduler(GenerateConfig(kernel="ref")),
    lambda: empty_pools(DecoderConfig(), 4),
    _knn_pipeline_on_default_device,
    lambda: _knn_pipeline_on_default_device(LshKnn),
    lambda: _knn_pipeline_on_default_device(IvfKnn),
    _ml_knn_index_on_default_device,
    lambda: LshKnnIndex(dimensions=4),
    lambda: IvfKnnIndex(dimensions=4),
    lambda: IvfDeviceIndex(np.ones((16, 4), np.float32)),
    lambda: assign_clusters(np.ones((2, 4), np.float32), np.ones((1, 4), np.float32)),
    lambda: make_projections(4, 2, 2, 1.0),
    lambda: ReplicaServer(replica_id=0, index_factory=dict),
    _compiled_ticks_on_default_device,
):
    try:
        make()
    except RuntimeError as e:
        assert "cuda" in str(e).lower()
    else:
        raise AssertionError("default device did not raise without CUDA")
print("ok")
"""


_IMPORT_EACH = """
import importlib, json, sys
for name in {blocked!r}:
    sys.modules[name] = None
ok = []
for mod in {mods!r}:
    importlib.import_module(mod)
    ok.append(mod)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print(json.dumps(ok))
"""

# the durability and observability modules, each imported on its own line
# of the check so a failure names it
DURABLE_MODULES = [
    "pathway_tpu_torch.engine.arrangement",
    "pathway_tpu_torch.engine.batch",
    "pathway_tpu_torch.engine.sharded",
    "pathway_tpu_torch.persistence.segments",
    "pathway_tpu_torch.generate.kv_cache",
    "pathway_tpu_torch.elastic.handover",
    "pathway_tpu_torch.elastic.kv",
    "pathway_tpu_torch.observability.registry",
    "pathway_tpu_torch.observability.exposition",
    "pathway_tpu_torch.observability.tracing",
    "pathway_tpu_torch.observability.journal",
    "pathway_tpu_torch.observability.tickscope",
    "pathway_tpu_torch.observability.torch_metrics",
    "pathway_tpu_torch.testing.faults",
]


# the engine, the Table API, the index operator and the root package: each
# imports with pandas blocked too
ENGINE_MODULES = [
    "pathway_tpu_torch",
    "pathway_tpu_torch.debug",
    "pathway_tpu_torch.reducers",
    "pathway_tpu_torch.engine.expression_eval",
    "pathway_tpu_torch.engine.index_node",
    "pathway_tpu_torch.engine.nodes",
    "pathway_tpu_torch.engine.reducers",
    "pathway_tpu_torch.engine.runtime",
    "pathway_tpu_torch.internals",
    "pathway_tpu_torch.internals.api",
    "pathway_tpu_torch.internals.common",
    "pathway_tpu_torch.internals.config",
    "pathway_tpu_torch.internals.custom_reducers",
    "pathway_tpu_torch.internals.datetime_types",
    "pathway_tpu_torch.internals.dtype",
    "pathway_tpu_torch.internals.error_log_table",
    "pathway_tpu_torch.internals.errors",
    "pathway_tpu_torch.internals.expression",
    "pathway_tpu_torch.internals.expression_printer",
    "pathway_tpu_torch.internals.expressions",
    "pathway_tpu_torch.internals.expressions.numerical",
    "pathway_tpu_torch.internals.expressions.string",
    "pathway_tpu_torch.internals.groupbys",
    "pathway_tpu_torch.internals.joins",
    "pathway_tpu_torch.internals.json",
    "pathway_tpu_torch.internals.parse_graph",
    "pathway_tpu_torch.internals.reducer_descriptors",
    "pathway_tpu_torch.internals.run",
    "pathway_tpu_torch.internals.schema",
    "pathway_tpu_torch.internals.table",
    "pathway_tpu_torch.internals.table_slice",
    "pathway_tpu_torch.internals.telemetry",
    "pathway_tpu_torch.internals.thisclass",
    "pathway_tpu_torch.internals.udfs",
    "pathway_tpu_torch.internals.universe",
    "pathway_tpu_torch.io",
    "pathway_tpu_torch.io._subscribe",
    "pathway_tpu_torch.io.python",
    "pathway_tpu_torch.stdlib.indexing",
    "pathway_tpu_torch.stdlib.indexing.colnames",
    "pathway_tpu_torch.stdlib.indexing.data_index",
    "pathway_tpu_torch.stdlib.indexing.nearest_neighbors",
    "pathway_tpu_torch.stdlib.indexing.retrievers",
    "pathway_tpu_torch.xpacks.llm.embedders",
    # the other index kinds and their device ops
    "pathway_tpu_torch.ops.ivf",
    "pathway_tpu_torch.ops.lsh",
    "pathway_tpu_torch.ops.segment",
    "pathway_tpu_torch.stdlib",
    "pathway_tpu_torch.stdlib.indexing._index_impls",
    "pathway_tpu_torch.stdlib.indexing.bm25",
    "pathway_tpu_torch.stdlib.indexing.full_text_document_index",
    "pathway_tpu_torch.stdlib.indexing.hybrid_index",
    "pathway_tpu_torch.stdlib.indexing.vector_document_index",
    "pathway_tpu_torch.stdlib.ml",
    "pathway_tpu_torch.stdlib.ml.index",
    "pathway_tpu_torch.stdlib.ml.utils",
]

# the RAG product layer: each imports with pandas and the clients blocked
RAG_MODULES = [
    "pathway_tpu_torch.xpacks.llm",
    "pathway_tpu_torch.xpacks.llm._flax_init",
    "pathway_tpu_torch.xpacks.llm._utils",
    "pathway_tpu_torch.xpacks.llm.document_store",
    "pathway_tpu_torch.xpacks.llm.embedders",
    "pathway_tpu_torch.xpacks.llm.llms",
    "pathway_tpu_torch.xpacks.llm.parsers",
    "pathway_tpu_torch.xpacks.llm.prompts",
    "pathway_tpu_torch.xpacks.llm.question_answering",
    "pathway_tpu_torch.xpacks.llm.rerankers",
    "pathway_tpu_torch.xpacks.llm.servers",
    "pathway_tpu_torch.xpacks.llm.splitters",
    "pathway_tpu_torch.xpacks.llm.utils",
    "pathway_tpu_torch.xpacks.llm.vector_store",
]


# the REST connector and the Surge Gate: each imports with pandas and the
# clients blocked (the server is the standard library's)
REST_MODULES = [
    "pathway_tpu_torch.io.http",
    "pathway_tpu_torch.io.http._client",
    "pathway_tpu_torch.io.http._server",
    "pathway_tpu_torch.io.http._web",
    "pathway_tpu_torch.serving",
    "pathway_tpu_torch.serving.admission",
    "pathway_tpu_torch.serving.batcher",
    "pathway_tpu_torch.serving.config",
    "pathway_tpu_torch.serving.deadline",
    "pathway_tpu_torch.serving.degrade",
    "pathway_tpu_torch.serving.gate",
    "pathway_tpu_torch.serving.metrics",
    "pathway_tpu_torch.serving.tenancy",
    "pathway_tpu_torch.xpacks.llm.servers",
]

# the replicated read plane: each imports with pandas and the clients
# (aiohttp, requests) blocked — its HTTP server and client are the
# standard library's
REPLICATION_MODULES = [
    "pathway_tpu_torch.io.http._web_client",
    "pathway_tpu_torch.parallel",
    "pathway_tpu_torch.parallel.host_exchange",
    "pathway_tpu_torch.parallel.wire",
    "pathway_tpu_torch.parallel.replicate",
    "pathway_tpu_torch.parallel.standby",
    "pathway_tpu_torch.parallel.supervisor",
    "pathway_tpu_torch.serving.replica",  # python -m pathway_tpu_torch.serving.replica
    "pathway_tpu_torch.serving.router",
    "pathway_tpu_torch.serving.result_cache",
    "pathway_tpu_torch.generate.serving",
]

# persistence and the file connectors: each imports with pandas and fsspec
# blocked
PERSISTENCE_MODULES = [
    "pathway_tpu_torch.persistence",
    "pathway_tpu_torch.persistence._pickle",
    "pathway_tpu_torch.persistence._runtime_glue",
    "pathway_tpu_torch.persistence.backends",
    "pathway_tpu_torch.persistence.cached_object_storage",
    "pathway_tpu_torch.io._utils",
    "pathway_tpu_torch.io.csv",
    "pathway_tpu_torch.io.fs",
    "pathway_tpu_torch.io.jsonlines",
    "pathway_tpu_torch.io.null",
    "pathway_tpu_torch.io.plaintext",
]

# every connector of pw.io: each imports with the lake, object-store and
# service clients blocked
CONNECTOR_MODULES = ["pathway_tpu_torch.io"] + [
    f"pathway_tpu_torch.io.{name}" for name in (
        "airbyte", "bigquery", "debezium", "deltalake", "elasticsearch", "gdrive", "iceberg", "kafka",
        "logstash", "minio", "mongodb", "nats", "postgres", "pubsub", "pyfilesystem", "redpanda", "s3",
        "s3_csv", "sharepoint", "slack", "sqlite")
]

# the card's CDC path at a small size, on the CPU: chip_smoke.cdc_pipeline
# through tests/torch_parity.cdc_run, with the connector clients blocked
_CDC_RUN = """
import sys, tempfile
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, "tests")
import torch
import pathway_tpu_torch as pw
from chip_smoke import cdc_stream, signed64
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from torch_parity import cdc_run

s = cdc_stream(3, 64, 2, 8, 4, 4, 3, 3)
emb = SentenceTransformerEmbedder(dim=16, depth=1, heads=2, max_len=32, device="cpu")
got = cdc_run(pw, tempfile.mkdtemp(), s, emb, 16, {{"device": "cpu"}})
final = got["snaps"][-1]
assert len(got["snaps"]) == 3 and final["changes"] == final["docs"] and got["static"] == final["docs"]
assert sorted(r[0] for r in final["docs"].values()) == sorted(s["live"][-1])
assert {{key: (q, d, x) for q, d, x, key in got["written"]}} == {{signed64(k): v for k, v in final["pairs"].items()}}
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""

# the rest of the Table API: each imports with pandas blocked
CORE_API_MODULES = [
    "pathway_tpu_torch.internals.arg_tuple",
    "pathway_tpu_torch.internals.iterate",
    "pathway_tpu_torch.internals.row_transformer",
    "pathway_tpu_torch.internals.sql",
    "pathway_tpu_torch.stdlib.utils",
    "pathway_tpu_torch.stdlib.utils.async_transformer",
    "pathway_tpu_torch.stdlib.utils.col",
    "pathway_tpu_torch.stdlib.utils.filtering",
    "pathway_tpu_torch.stdlib.utils.pandas_transformer",
    "pathway_tpu_torch.udfs",
    "pathway_tpu_torch.universes",
]

# ``pw.live``, ``pw.demo``, ``pw.load_yaml``, the rest of ``pw.debug`` and
# the rest of ``pw.stdlib.ml``: each imports with pandas, yaml, pyarrow and
# sklearn blocked
ML_REST_MODULES = [
    "pathway_tpu_torch.debug",
    "pathway_tpu_torch.demo",
    "pathway_tpu_torch.internals.interactive",
    "pathway_tpu_torch.internals.yaml_loader",
    "pathway_tpu_torch.stdlib.ml",
    "pathway_tpu_torch.stdlib.ml.classifiers",
    "pathway_tpu_torch.stdlib.ml.classifiers._clustering_via_lsh",
    "pathway_tpu_torch.stdlib.ml.classifiers._lsh",
    "pathway_tpu_torch.stdlib.ml.datasets",
    "pathway_tpu_torch.stdlib.ml.datasets.classification",
    "pathway_tpu_torch.stdlib.ml.hmm",
    "pathway_tpu_torch.stdlib.ml.smart_table_ops",
    "pathway_tpu_torch.stdlib.ml.smart_table_ops._fuzzy_join",
]

# the temporal operators (``pw.temporal``, ``.dt``, ``pw.ordered``,
# ``pw.stateful``, ``pw.statistical``): each imports with pandas blocked
TEMPORAL_MODULES = [
    "pathway_tpu_torch.engine.temporal_nodes",
    "pathway_tpu_torch.internals.expressions",
    "pathway_tpu_torch.internals.expressions.date_time",
    "pathway_tpu_torch.stdlib.ordered",
    "pathway_tpu_torch.stdlib.stateful",
    "pathway_tpu_torch.stdlib.statistical",
    "pathway_tpu_torch.stdlib.temporal",
    "pathway_tpu_torch.stdlib.temporal._asof_join",
    "pathway_tpu_torch.stdlib.temporal._asof_now_join",
    "pathway_tpu_torch.stdlib.temporal._interval_join",
    "pathway_tpu_torch.stdlib.temporal._window",
    "pathway_tpu_torch.stdlib.temporal._window_join",
    "pathway_tpu_torch.stdlib.temporal.temporal_behavior",
    "pathway_tpu_torch.stdlib.temporal.time_utils",
    "pathway_tpu_torch.stdlib.temporal.utils",
]

# windows under a behavior, an interval join and an asof join over int
# times: what the card's machine runs, with pandas blocked
_TEMPORAL_RUN = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import pathway_tpu_torch as pw

t = pw.debug.table_from_markdown(
    "t | k | v | __time__\\n1 | 0 | 5 | 2\\n3 | 1 | 7 | 2\\n4 | 0 | 1 | 4\\n9 | 1 | 2 | 6\\n12 | 0 | 3 | 8")
w = t.windowby(t.t, window=pw.temporal.tumbling(duration=4), instance=t.k,
               behavior=pw.temporal.common_behavior(delay=1, cutoff=6, keep_results=False)
               ).reduce(pw.this._pw_window_start, n=pw.reducers.count())
j = t.interval_join(t.copy(), t.t, t.t, pw.temporal.interval(-2, 0)).select(a=pw.left.v, b=pw.right.v)
a = t.asof_join(t.copy(), t.t, t.t).select(pw.this.t, v=pw.left.v)
res = {{}}
for name, table in (("w", w), ("j", j), ("a", a)):
    pw.io.subscribe(table, on_change=lambda key, row, time, is_addition, name=name:
                    res.setdefault(name, []).append(is_addition))
pw.run()
assert all(res.get(n) for n in "wja"), res
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""

# the in-process device mesh: each imports with pandas and the clients
# blocked, and a sharded run (engine shards, a sharded index, a mesh
# encoder) runs without loading either
MESH_MODULES = [
    "pathway_tpu_torch.parallel.mesh",
    "pathway_tpu_torch.parallel.exchange",
    "pathway_tpu_torch.parallel.collectives",
    "pathway_tpu_torch.engine.sharded",
    "pathway_tpu_torch.ops.knn",
    "pathway_tpu_torch.stdlib.indexing._index_impls",
    "pathway_tpu_torch.xpacks.llm._encoder",
]

_MESH_RUN = """
import os, sys
for name in {blocked!r}:
    sys.modules[name] = None
os.environ["PATHWAY_ENGINE_SHARDS"] = "4"
os.environ["PATHWAY_MESH_DEVICE"] = "cpu"
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.sharded import ShardedGroupByExec
from pathway_tpu_torch.parallel import make_mesh
from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn
from pathway_tpu_torch.xpacks.llm._encoder import EncoderRuntime

t = pw.debug.table_from_rows(pw.schema_from_types(g=int, v=float), [(i % 7, i / 3) for i in range(700)])
agg = t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))
docs = pw.debug.table_from_rows(pw.schema_from_types(vec=np.ndarray),
                                [(np.eye(4, dtype=np.float32)[i],) for i in range(4)])
ix = DataIndex(docs, TpuKnn(docs.vec, dimensions=4, mesh=make_mesh(2, device="cpu"), device="cpu"))
res = ix.query_as_of_now(docs.vec, number_of_matches=1).select(r=pw.right._pw_index_reply_id)
got = {{}}
pw.io.subscribe(agg, on_change=lambda key, row, time, is_addition: got.setdefault("agg", []).append(row))
pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: got.setdefault("ix", []).append(row))
pw.run()
rt = pw.internals.parse_graph.G.last_runtime
assert any(isinstance(e, ShardedGroupByExec) for e in rt.execs.values()) and rt.frontier_syncs > 0
assert len(got["agg"]) == 7 and len(got["ix"]) == 4, got
enc = EncoderRuntime(vocab_size=50, dim=8, depth=1, heads=2, max_len=16, mesh=make_mesh(3, device="cpu"))
assert enc.forward_ids(np.ones((5, 4), np.int32), np.ones((5, 4), np.float32)).shape == (5, 8)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""

_LIVE_CLASSIFY_RUN = """
import csv, sys, tempfile
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.stdlib.ml.classifiers import knn_lsh_classifier_train
from pathway_tpu_torch.stdlib.ml.smart_table_ops import fuzzy_self_match

path = tempfile.mkdtemp() + "/train.csv"
with open(path, "w", newline="") as f:
    w = csv.writer(f)
    w.writerow(["doc", "label", "x", "y"])
    w.writerows([(i, "east" if i % 2 else "west", (1.0 if i % 2 else -1.0) + i / 100, i / 50) for i in range(20)])

class Doc(pw.Schema):
    doc: int = pw.column_definition(primary_key=True)
    label: str
    x: float
    y: float

class Query(pw.Schema):
    x: float
    y: float

train = pw.demo.replay_csv(path, schema=Doc, input_rate=0)
vectors = train.select(train.label, data=pw.apply(lambda x, y: np.array([x, y]), train.x, train.y))
model = knn_lsh_classifier_train(vectors, type="cosine", d=2, device="cpu")
asked = pw.debug.StreamGenerator().table_from_list_of_batches([[{{"x": 2.0, "y": 0.1}}], [{{"x": -2.0, "y": 0.1}}]], Query)
pred = model(asked.select(data=pw.apply(lambda x, y: np.array([x, y]), asked.x, asked.y)), k=3)
lt = pw.live(pred)
assert lt.wait(60) and not lt.failed
assert sorted(v[0] for v in lt.snapshot()[1].values()) == ["east", "west"], lt.snapshot()
lt.stop()
pw.internals.parse_graph.G.clear()
names = pw.debug.table_from_markdown("name\\nann lee\\nlee ann\\nbob")
_k, cols = pw.debug.table_to_dicts(fuzzy_self_match(names.name))
assert len(cols["left"]) == 1, cols
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""

_CORE_API_RUN = """
import asyncio, sys
for name in {blocked!r}:
    sys.modules[name] = None
import pathway_tpu_torch as pw

edges = pw.debug.table_from_markdown("u | w\\n1 | 2\\n2 | 3\\n7 | 8")
both = edges.select(a=edges.u, b=edges.w).concat_reindex(edges.select(a=edges.w, b=edges.u))
labels0 = both.groupby(both.a).reduce(v=both.a, label=both.a)

def step(labels):
    nb = both.join(labels, both.a == labels.v).select(v=both.b, label=labels.label)
    cand = nb.concat_reindex(labels.select(labels.v, labels.label))
    return cand.groupby(cand.v).reduce(cand.v, label=pw.reducers.min(cand.label))

comps = pw.iterate(step, labels=labels0)
sizes = pw.sql("SELECT label, COUNT(*) AS size FROM c GROUP BY label", c=comps)

@pw.transformer
class double:
    class table(pw.ClassArg):
        size = pw.input_attribute()

        @pw.output_attribute
        def twice(self) -> int:
            return 2 * self.size

class Out(pw.Schema):
    ret: int

class Inc(pw.AsyncTransformer, output_schema=Out):
    async def invoke(self, label, size) -> dict:
        return {{"ret": label + size}}

best = pw.utils.filtering.argmax_rows(sizes, what=sizes.size)
res = {{}}
for name, t in [("sizes", sizes), ("twice", double(sizes.select(sizes.size)).table),
                ("inc", Inc(input_table=sizes).successful), ("best", best)]:
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition, name=name:
                    res.setdefault(name, []).append(tuple(sorted(row.items()))))
pw.run()
assert sorted(res["sizes"]) == [(("label", 1), ("size", 3)), (("label", 7), ("size", 2))], res
assert sorted(res["twice"]) == [(("twice", 4),), (("twice", 6),)], res
assert sorted(res["inc"]) == [(("ret", 4),), (("ret", 9),)] and len(res["best"]) == 1, res
pw.internals.parse_graph.G.clear()

class O(pw.Schema):
    x: int

@pw.pandas_transformer(output_schema=O)
def f(df):
    return df

edges = pw.debug.table_from_markdown("u | w\\n1 | 2")
pw.io.subscribe(f(edges.select(x=edges.u)), on_change=lambda **kw: None)
try:
    pw.run()
except ImportError:
    pass
else:
    raise AssertionError("pandas_transformer ran without pandas")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""

_PERSISTED_RUN = """
import json, os, sys, tempfile, threading, time
for name in {blocked!r}:
    sys.modules[name] = None
import pathway_tpu_torch as pw

base = tempfile.mkdtemp()
os.makedirs(base + "/in")
with open(base + "/in/f1.jsonl", "w") as f:
    f.write("".join(json.dumps({{"word": w}}) + "\\n" for w in "a b a".split()))
cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(base + "/p"), snapshot_every=1)

class S(pw.Schema):
    word: str

def run(out, want):
    pw.internals.parse_graph.G.clear()
    t = pw.io.fs.read(base + "/in", format="json", schema=S, mode="streaming")
    pw.io.jsonlines.write(t.groupby(t.word).reduce(t.word, n=pw.reducers.count()), out)
    th = threading.Thread(target=lambda: pw.run(persistence_config=cfg, autocommit_duration_ms=20))
    th.start()
    deadline = time.time() + 30
    while time.time() < deadline:
        if os.path.exists(out) and want in open(out).read():
            break
        time.sleep(0.02)
    pw.internals.parse_graph.G.runtime.stop()
    th.join(10)
    return pw.internals.parse_graph.G.last_runtime.persistence_driver

run(base + "/a.jsonl", '"a", "n": 2')
with open(base + "/in/f2.jsonl", "w") as f:
    f.write(json.dumps({{"word": "c"}}) + "\\n")
drv = run(base + "/b.jsonl", '"c", "n": 1')
assert drv.restored_from_snapshot and drv.replayed_events == 0
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""

_SERVE_WITHOUT_CLIENTS = """
import http.client, json, socket, sys, threading, time
for name in {blocked!r}:
    sys.modules[name] = None
import pathway_tpu_torch as pw
from pathway_tpu_torch.io.http import rest_connector
from pathway_tpu_torch.serving import QoSConfig

def free_port():
    s = socket.socket(); s.bind(("127.0.0.1", 0)); p = s.getsockname()[1]; s.close(); return p

ports = []
for qos in (None, QoSConfig(max_batch_size=4, max_wait_ms=2)):
    port = free_port(); ports.append(port)
    q, writer = rest_connector(host="127.0.0.1", port=port, schema=pw.schema_from_types(text=str),
                               route="/up", qos=qos)
    writer(q.select(query_id=q.id, result=pw.apply(str.upper, q.text)))
t = threading.Thread(target=pw.run, daemon=True)
t.start()
for port in ports:
    for _ in range(200):
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            c.request("POST", "/up", body=json.dumps({{"text": "ok"}}))
            r = c.getresponse()
            assert r.status == 200 and json.loads(r.read()) == "OK", r.status
            break
        except ConnectionRefusedError:
            time.sleep(0.05)
    else:
        raise AssertionError("no server")
pw.internals.parse_graph.G.runtime.stop()
t.join(10)
assert not t.is_alive()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""


_PLANE_WITHOUT_CLIENTS = """
import http.client, json, os, sys
for name in {blocked!r}:
    sys.modules[name] = None
os.environ["PATHWAY_DCN_SECRET"] = "no-clients"
import numpy as np
from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.parallel.replicate import DeltaStreamServer
from pathway_tpu_torch.serving import FailoverRouter, ReplicaServer, ResultCache
from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex

srv = DeltaStreamServer(0)
vecs = np.eye(4, dtype=np.float32)
srv.publish(0, [DiffBatch.from_rows([(k, 1, (vecs[k], None)) for k in range(4)], ("_data", "_meta"))])
rep = ReplicaServer(replica_id=0, index_factory=lambda: TpuDenseKnnIndex(dimensions=4, device="cpu"),
                    writer_port=srv.port, dim=4, device="cpu").start()
cache = ResultCache(dim=4)
cache.attach_stream("127.0.0.1", srv.port)
router = FailoverRouter(["http://127.0.0.1:%d" % rep.http_port], health_interval_ms=50, cache=cache).start()
import time
t_end = time.time() + 30
while not (rep.ready and router.endpoints[0].ready) and time.time() < t_end:
    time.sleep(0.02)
answers = []
for _ in range(2):
    c = http.client.HTTPConnection("127.0.0.1", router.port, timeout=10)
    c.request("POST", "/query", body=json.dumps({{"vec": [0, 1, 0, 0], "k": 1}}))
    r = c.getresponse()
    answers.append((r.status, r.getheader("x-pathway-cache"), json.loads(r.read())["matches"][0][0]))
    c.close()
assert answers == [(200, None, 1), (200, "hit", 1)], answers
router.stop(); rep.stop(); srv.close()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""


def _run(code, blocked=BLOCKED, **fmt):
    return subprocess.run(
        [sys.executable, "-c", code.format(blocked=blocked, **fmt)],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_every_port_module_imports_without_jax():
    r = _run(_IMPORT_ALL, blocked=BLOCKED + CLIENTS)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 29 + len(ENGINE_MODULES)


@pytest.fixture(scope="module")
def imported_with_jax_blocked():
    r = _run(_IMPORT_EACH, mods=DURABLE_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", DURABLE_MODULES)
def test_durability_module_imports_without_jax(imported_with_jax_blocked, mod):
    assert mod in imported_with_jax_blocked


@pytest.fixture(scope="module")
def imported_with_pandas_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_PANDAS, mods=ENGINE_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", ENGINE_MODULES)
def test_engine_module_imports_without_jax_or_pandas(imported_with_pandas_blocked, mod):
    assert mod in imported_with_pandas_blocked


@pytest.fixture(scope="module")
def imported_with_clients_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_CLIENTS, mods=RAG_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", RAG_MODULES)
def test_rag_module_imports_without_jax_pandas_or_clients(imported_with_clients_blocked, mod):
    assert mod in imported_with_clients_blocked


@pytest.fixture(scope="module")
def rest_imported_with_clients_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_CLIENTS, mods=REST_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", REST_MODULES)
def test_rest_module_imports_without_jax_pandas_or_clients(rest_imported_with_clients_blocked, mod):
    assert mod in rest_imported_with_clients_blocked


@pytest.fixture(scope="module")
def persistence_imported_with_fsspec_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_FSSPEC, mods=PERSISTENCE_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", PERSISTENCE_MODULES)
def test_persistence_module_imports_without_jax_pandas_or_fsspec(persistence_imported_with_fsspec_blocked, mod):
    assert mod in persistence_imported_with_fsspec_blocked


@pytest.fixture(scope="module")
def connectors_imported_with_clients_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_CONNECTOR_CLIENTS, mods=CONNECTOR_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", CONNECTOR_MODULES)
def test_connector_module_imports_without_its_clients(connectors_imported_with_clients_blocked, mod):
    assert mod in connectors_imported_with_clients_blocked


@pytest.fixture(scope="module")
def compiled_imported_with_viz_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_VIZ, mods=COMPILED_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", COMPILED_MODULES)
def test_compiled_tick_module_imports_without_jax_pandas_rich_or_bokeh(compiled_imported_with_viz_blocked, mod):
    assert mod in compiled_imported_with_viz_blocked


_COMPILED_RUN = """
import os, sys
for name in {blocked!r}:
    sys.modules[name] = None
os.environ.update(PATHWAY_COMPILED_TICK="1", PATHWAY_COMPILED_DEVICE="cpu", PATHWAY_COMPILED_MIN_ROWS="1")
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import native
assert native.get_native() is not None, native.build_log
t = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=float), [(i, i / 2) for i in range(100)])
out = t.select(x=t.a * 3 + 1, y=t.b - t.a).filter(pw.this.x > 50)
keys, cols = pw.debug.table_to_dicts(out.groupby(pw.this.x % 2 == 0).reduce(n=pw.reducers.count()))
rt = pw.internals.parse_graph.G.last_runtime
assert sum(s.compiled_ticks for s in rt.compiled_plan.segments) == 1
pw.internals.parse_graph.G.clear()
edges = pw.debug.T("u | v\\n a | b\\n b | a\\n c | a")
ranks = pw.debug.table_to_dicts(pw.graphs.pagerank(edges, steps=10))[1]["rank"]
assert len(ranks) == 3
try:
    pw.viz.plot(edges)
except ImportError as e:
    assert "bokeh" in str(e)
else:
    raise AssertionError("plot ran without bokeh")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""


# the rest of observability: the Graph Doctor and the launch ledger, the
# debug surfaces, signals and fleet, the monitoring server and dashboard
# (``rich`` is imported only when the dashboard renders)
OBSERVABILITY_MODULES = [
    "pathway_tpu_torch.analysis",
    "pathway_tpu_torch.analysis.__main__",
    "pathway_tpu_torch.analysis.diagnostics",
    "pathway_tpu_torch.analysis.doctor",
    "pathway_tpu_torch.analysis.graph_facts",
    "pathway_tpu_torch.analysis.lowering",
    "pathway_tpu_torch.analysis.plane",
    "pathway_tpu_torch.analysis.rules",
    "pathway_tpu_torch.elastic.planner",
    "pathway_tpu_torch.internals.monitoring",
    "pathway_tpu_torch.internals.monitoring_server",
    "pathway_tpu_torch.observability.debug",
    "pathway_tpu_torch.observability.fleet",
    "pathway_tpu_torch.observability.signals",
]


@pytest.fixture(scope="module")
def observability_imported_with_rich_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_VIZ, mods=OBSERVABILITY_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", OBSERVABILITY_MODULES)
def test_observability_module_imports_without_jax_pandas_or_rich(observability_imported_with_rich_blocked, mod):
    assert mod in observability_imported_with_rich_blocked


_MONITORED_RUN = """
import json, os, sys, urllib.request
for name in {blocked!r}:
    sys.modules[name] = None
os.environ.update(PATHWAY_SIGNALS_INTERVAL_MS="100")
import pathway_tpu_torch as pw
from pathway_tpu_torch.analysis import lowering
t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(i,) for i in range(10)])
out = t.select(b=t.a * 2).filter(pw.this.b > 4)
pw.io.subscribe(out, on_change=lambda **kw: None)
pw.run(with_http_server=True, diagnostics="warn", monitoring_level=pw.MonitoringLevel.ALL)
srv = pw.internals.parse_graph.G.last_runtime.http_server
port = srv.server_address[1]
for route in ("/metrics", "/debug/graph", "/debug/signals", "/debug/tick", "/fleet/metrics"):
    with urllib.request.urlopen(f"http://127.0.0.1:{{port}}{{route}}", timeout=30) as resp:
        assert resp.status == 200, route
srv.shutdown()
report = pw.debug.diagnose(out)
assert report.by_rule("graph-stats")
assert not lowering.prove_lowering().findings
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print("ok")
"""


def test_monitored_run_and_doctor_run_with_jax_pandas_and_rich_blocked():
    r = _run(_MONITORED_RUN, blocked=BLOCKED_WITH_VIZ)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_compiled_path_graphs_and_viz_run_with_pandas_rich_and_bokeh_blocked():
    r = _run(_COMPILED_RUN, blocked=BLOCKED_WITH_VIZ)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_cdc_path_runs_with_the_connector_clients_blocked():
    r = _run(_CDC_RUN, blocked=BLOCKED_WITH_CONNECTOR_CLIENTS)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


@pytest.fixture(scope="module")
def core_api_imported_with_pandas_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_PANDAS, mods=CORE_API_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", CORE_API_MODULES)
def test_core_api_module_imports_without_jax_or_pandas(core_api_imported_with_pandas_blocked, mod):
    assert mod in core_api_imported_with_pandas_blocked


@pytest.fixture(scope="module")
def ml_rest_imported_with_ml_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_ML, mods=ML_REST_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", ML_REST_MODULES)
def test_ml_rest_module_imports_without_jax_pandas_yaml_pyarrow_or_sklearn(ml_rest_imported_with_ml_blocked, mod):
    assert mod in ml_rest_imported_with_ml_blocked


@pytest.fixture(scope="module")
def temporal_imported_with_pandas_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_PANDAS, mods=TEMPORAL_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", TEMPORAL_MODULES)
def test_temporal_module_imports_without_jax_or_pandas(temporal_imported_with_pandas_blocked, mod):
    assert mod in temporal_imported_with_pandas_blocked


@pytest.fixture(scope="module")
def mesh_imported_with_clients_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_CLIENTS, mods=MESH_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", MESH_MODULES)
def test_mesh_module_imports_without_jax_pandas_or_clients(mesh_imported_with_clients_blocked, mod):
    assert mod in mesh_imported_with_clients_blocked


def test_sharded_run_with_jax_pandas_and_clients_blocked():
    r = _run(_MESH_RUN, blocked=BLOCKED_WITH_CLIENTS)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_temporal_pipeline_runs_with_pandas_blocked():
    r = _run(_TEMPORAL_RUN, blocked=BLOCKED_WITH_PANDAS)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_live_classifier_runs_with_pandas_yaml_pyarrow_and_sklearn_blocked():
    r = _run(_LIVE_CLASSIFY_RUN, blocked=BLOCKED_WITH_ML)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_stdlib_utils_import_loads_no_pandas():
    code = "import sys\nimport pathway_tpu_torch.stdlib.utils\nprint('pandas' in sys.modules)"
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False"


def test_core_api_pipeline_runs_with_pandas_blocked():
    r = _run(_CORE_API_RUN, blocked=BLOCKED_WITH_PANDAS)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_persisted_fs_run_restores_with_pandas_and_fsspec_blocked():
    r = _run(_PERSISTED_RUN, blocked=BLOCKED_WITH_FSSPEC)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_port_server_answers_with_aiohttp_and_requests_blocked():
    r = _run(_SERVE_WITHOUT_CLIENTS, blocked=BLOCKED_WITH_CLIENTS)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_supervised_group_runs_with_jax_pandas_and_clients_blocked(tmp_path):
    """``spawn -n 2 --supervise``: incarnation 0's rank 1 dies by the fault
    plan at its first tick, the supervisor restarts the group, and both
    incarnations' ranks run with jax, pandas and the clients blocked."""
    import os

    from pathway_tpu_torch.testing.chaos import free_dcn_port

    script = tmp_path / "rank.py"
    script.write_text(_GROUP_RANK.format(blocked=BLOCKED_WITH_CLIENTS).replace(
        'sys.stdout.write(f"RANK-OK', 'sys.stdout.write(f"INC-{os.environ[\'PATHWAY_MESH_INCARNATION\']} RANK-OK'))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "", "PATHWAY_DCN_PORT": str(free_dcn_port(2)),
           "PATHWAY_FAULTS": "kill=tick:1,pid:1", "PATHWAY_MESH_LIVENESS_TIMEOUT_MS": "5000"}
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", "2", "--backend", "gloo",
                        "--supervise", "--max-restarts", "1", "--first-port", str(free_dcn_port(1)),
                        "--timeout", "200", "--", sys.executable, str(script)],
                       cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "fault forge: injected death" in r.stderr, r.stderr[-3000:]
    lines = [ln.split() for ln in r.stdout.splitlines() if "RANK-OK" in ln]
    assert sorted(x[0] for x in lines) == ["INC-1", "INC-1"] and sum(int(x[2]) for x in lines) == 40, r.stdout


@pytest.fixture(scope="module")
def replication_imported_with_clients_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_CLIENTS, mods=REPLICATION_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", REPLICATION_MODULES)
def test_replication_module_imports_without_jax_pandas_or_clients(replication_imported_with_clients_blocked, mod):
    assert mod in replication_imported_with_clients_blocked


def test_replicated_plane_serves_with_aiohttp_and_requests_blocked():
    """A writer's stream, a replica, a router and its result cache answer
    (a miss, then a hit) without loading aiohttp or requests."""
    r = _run(_PLANE_WITHOUT_CLIENTS, blocked=BLOCKED_WITH_CLIENTS)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("mod", REPLICATION_MODULES)
def test_replication_module_imports_neither_aiohttp_nor_requests_anywhere(mod):
    path = ROOT / (mod.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / mod.replace(".", "/") / "__init__.py"
    assert not _imported_roots(path) & {"aiohttp", "requests"}


def _module_level_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_only_the_datetime_namespace_imports_pandas_at_module_level():
    offenders = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py")
        if "pandas" in _module_level_roots(p)
    }
    assert offenders <= PANDAS_MODULES, offenders
    assert "pandas" not in _module_level_roots(ROOT / "chip_smoke.py")


def test_no_port_module_imports_a_client_at_module_level():
    offenders = {
        str(p.relative_to(ROOT))
        for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        if _module_level_roots(p) & {*CLIENTS, *CONNECTOR_CLIENTS, "google", "fsspec", "pyarrow", "rich", "bokeh"}
    }
    assert not offenders, offenders


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & set(BLOCKED)


def test_default_device_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(_DEFAULT_DEVICE_RAISES)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


# the multi-process engine: each imports with pandas and the clients
# blocked, and a spawned two-process group runs with them blocked
MULTI_PROCESS_MODULES = [
    "pathway_tpu_torch.parallel.host_exchange",
    "pathway_tpu_torch.parallel.distributed",
    "pathway_tpu_torch.engine.dcn",
    "pathway_tpu_torch.cli",
    "pathway_tpu_torch.testing.chaos",
    "pathway_tpu_torch.persistence._runtime_glue",
    "pathway_tpu_torch.parallel.supervisor",
    "pathway_tpu_torch.parallel.standby",
    "pathway_tpu_torch.elastic",
    "pathway_tpu_torch.elastic.ferry",
    "pathway_tpu_torch.elastic.handover",
    "pathway_tpu_torch.elastic.mesh",
    "pathway_tpu_torch.autoscale",
    "pathway_tpu_torch.autoscale.controller",
    "pathway_tpu_torch.autoscale.policy",
    "pathway_tpu_torch.autoscale.predictor",
]


@pytest.fixture(scope="module")
def multi_process_imported_with_clients_blocked():
    r = _run(_IMPORT_EACH, blocked=BLOCKED_WITH_CLIENTS, mods=MULTI_PROCESS_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", MULTI_PROCESS_MODULES)
def test_multi_process_module_imports_without_jax_pandas_or_clients(multi_process_imported_with_clients_blocked, mod):
    assert mod in multi_process_imported_with_clients_blocked


_GROUP_RANK = """
import json, os, sys
for name in {blocked!r}:
    sys.modules[name] = None
import numpy as np
import pathway_tpu_torch as pw
from pathway_tpu_torch.engine.dcn import DcnGroupByExec, DcnJoinExec
from pathway_tpu_torch.parallel import distributed as dist

pid, n = int(os.environ["PATHWAY_PROCESS_ID"]), int(os.environ["PATHWAY_PROCESSES"])
t = pw.debug.table_from_rows(pw.schema_from_types(g=int, v=int), [(i % 5, i) for i in range(40) if i % n == pid])
agg = t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))
j = agg.join(t, agg.g == t.g).select(t.v, agg.s)
keys, cols = pw.debug.table_to_dicts(j)
rt = pw.internals.parse_graph.G.last_runtime
assert {{DcnGroupByExec, DcnJoinExec}} <= {{type(e) for e in rt.execs.values()}}
assert dist.maybe_initialize(device="cpu")
rng = np.random.default_rng(1)
corpus = rng.normal(size=(2048, 8)).astype(np.float32)
sc, ix = dist.sharded_topk_global(corpus[:2], corpus[pid * 1024:(pid + 1) * 1024], np.ones(1024, bool), 3,
                                  device="cpu")
assert ix[:, 0].tolist() == [0, 1], ix
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
# one write of the whole line: the ranks share spawn's stdout
sys.stdout.write(f"RANK-OK {{len(keys)}}\\n")
sys.stdout.flush()
"""


def test_spawned_group_runs_with_jax_pandas_and_clients_blocked(tmp_path):
    import os
    import socket

    from pathway_tpu_torch.testing.chaos import free_dcn_port

    script = tmp_path / "rank.py"
    script.write_text(_GROUP_RANK.format(blocked=BLOCKED_WITH_CLIENTS))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    store = s.getsockname()[1]
    s.close()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "", "PATHWAY_DCN_PORT": str(free_dcn_port(2))}
    r = subprocess.run([sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", "2", "--backend", "gloo",
                        "--first-port", str(store), "--timeout", "200", "--", sys.executable, str(script)],
                       cwd=ROOT, capture_output=True, text=True, timeout=240, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [ln.split() for ln in r.stdout.splitlines() if ln.startswith("RANK-OK")]
    assert len(lines) == 2 and sum(int(x[1]) for x in lines) == 40


_FERRY_PEER = """
import json, os, sys
for name in {blocked!r}:
    sys.modules[name] = None
from pathway_tpu_torch.elastic.ferry import FerryReceiver, ferry_files
if sys.argv[1] == "receive":
    recv = FerryReceiver(sys.argv[2])
    print(recv.port, flush=True)
    sys.stdin.readline()  # the sender has committed
    recv.close()
    print(json.dumps(recv.received), flush=True)
else:
    stats = ferry_files("127.0.0.1", int(sys.argv[2]), [("a/seg0", b"x" * 4096), ("manifest.json", b"{{}}")],
                        transfer_id="no-jax")
    print(json.dumps(stats), flush=True)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
"""


def test_spawned_ferry_sender_and_receiver_run_with_jax_pandas_and_clients_blocked(tmp_path):
    """A segment ferry between two processes of the port, each with jax,
    the JAX package, pandas and the clients blocked: the transfer commits
    and places both files."""
    import os

    code = _FERRY_PEER.format(blocked=BLOCKED_WITH_CLIENTS)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PATHWAY_DCN_SECRET": "no-jax-ferry"}
    recv = subprocess.Popen([sys.executable, "-c", code, "receive", str(tmp_path / "dst")], cwd=ROOT, env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = recv.stdout.readline().strip()
        assert port.isdigit(), recv.stderr.read()
        send = subprocess.run([sys.executable, "-c", code, "send", port], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert send.returncode == 0, send.stderr[-3000:]
        assert json.loads(send.stdout.strip().splitlines()[-1])["committed"]
        out, err = recv.communicate("done\n", timeout=60)
        assert recv.returncode == 0, err[-3000:]
        assert sorted(json.loads(out.strip().splitlines()[-1])["no-jax"]) == ["a/seg0", "manifest.json"]
        assert (tmp_path / "dst" / "a" / "seg0").read_bytes() == b"x" * 4096
    finally:
        if recv.poll() is None:
            recv.kill()
            recv.wait()
