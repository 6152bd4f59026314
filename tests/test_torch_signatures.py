"""Constructors and functions of the port take the reference's keywords.

``EncoderRuntime``, ``SentenceTransformerEmbedder`` and
``TpuDenseKnnIndex`` take ``mesh=``/``axis=`` where the reference does:
``mesh=None`` builds as if it were left out, and a mesh builds and runs
(a corpus searched across its shards, batches split over them). The
embedder
takes extra keywords and ignores them, as the reference does.
``split_kv_store`` takes ``transfer_id=`` and splits a store as the
reference does. The multi-process engine, the elastic resizing (the ferry,
the handover, ``reshard_stores``) and the autoscaler take the reference's
parameters, and their classes' public methods do too. Embeddings are compared exactly within the port; the split
counts across the packages exactly."""

import inspect

import numpy as np
import pytest

from pathway_tpu.elastic.kv import split_kv_store as jax_split_kv_store
from pathway_tpu.stdlib.indexing._index_impls import TpuDenseKnnIndex as JaxIndex
from pathway_tpu.xpacks.llm._encoder import EncoderRuntime as JaxRuntime
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JaxEmbedder
from pathway_tpu_torch.elastic.kv import split_kv_store
from pathway_tpu_torch.generate.kv_cache import KvLedger
from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
from pathway_tpu_torch.xpacks.llm._encoder import EncoderRuntime
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

SMALL = dict(dim=8, depth=1, heads=2, max_len=16)
CONSTRUCTORS = [
    (EncoderRuntime, JaxRuntime, dict(vocab_size=50, **SMALL)),
    (SentenceTransformerEmbedder, JaxEmbedder, SMALL),
    (TpuDenseKnnIndex, JaxIndex, dict(dimensions=8)),
]
IDS = ["EncoderRuntime", "SentenceTransformerEmbedder", "TpuDenseKnnIndex"]


def _names(cls):
    return [p for p in inspect.signature(cls).parameters if p != "device"]


@pytest.mark.parametrize("port,ref,kw", CONSTRUCTORS, ids=IDS)
def test_constructor_takes_the_reference_parameters(port, ref, kw):
    # the port adds only ``device=``; the names and their order are the
    # reference's (the JAX index's ``kernel`` values differ: xla/pallas)
    assert _names(port) == _names(ref)


@pytest.mark.parametrize("port,ref,kw", CONSTRUCTORS, ids=IDS)
def test_constructor_mesh_none_builds_and_a_mesh_raises(port, ref, kw):
    """``mesh=`` raised [mesh] until the mesh was ported: a mesh now builds
    and searches (or embeds) as the unsharded object does."""
    from pathway_tpu_torch.parallel import make_mesh

    plain = port(mesh=None, axis="data", device="cpu", **kw)
    sharded = port(mesh=make_mesh(2, device="cpu"), axis="data", device="cpu", **kw)
    if port is TpuDenseKnnIndex:
        vecs = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
        for ix in (plain, sharded):
            for i, v in enumerate(vecs):
                ix.upsert(i, v, None)
        ask = [(vecs[5], 3, None)]
        assert [k for k, _s in sharded.search(ask)[0]] == [k for k, _s in plain.search(ask)[0]]
        return
    if port is EncoderRuntime:
        ids = np.random.default_rng(0).integers(2, 50, size=(5, 8)).astype(np.int32)
        mask = np.ones((5, 8), np.float32)
        got, want = sharded.forward_ids(ids, mask), plain.forward_ids(ids, mask)
    else:
        texts = ["a seeded sentence", "another one", "and a third"]
        got, want = np.stack(sharded.embed_batch(texts)), np.stack(plain.embed_batch(texts))
    # bf16 forwards on other batch shapes: unit vectors, cosine >= 0.999
    assert got.shape == want.shape and (np.sum(got * want, axis=-1) >= 0.999).all()


def test_embedder_ignores_extra_init_kwargs():
    JaxEmbedder(trust_remote_code=True, **SMALL)  # the reference builds
    plain = SentenceTransformerEmbedder(device="cpu", **SMALL)
    extra = SentenceTransformerEmbedder(device="cpu", trust_remote_code=True, revision="main", **SMALL)
    texts = ["a seeded sentence", "another one"]
    np.testing.assert_array_equal(
        np.stack(plain.embed_batch(texts)), np.stack(extra.embed_batch(texts))
    )


def test_split_kv_store_takes_transfer_id_like_the_reference(tmp_path):
    led = KvLedger()
    for seq_id in range(1, 9):
        led.put_seq(seq_id, {"seq_id": seq_id})
    src = str(tmp_path / "src")
    led.snapshot(src)
    results = {}
    for name, split in (("jax", jax_split_kv_store), ("torch", split_kv_store)):
        dests = [str(tmp_path / f"{name}-{i}") for i in range(3)]
        stats = split(src, dests, transfer_id="kv-move-1")
        results[name] = (
            stats["n_new"], stats["total_seqs"], stats["bytes_ferried"],
            [d["seqs"] for d in stats["destinations"]],
            [sorted(KvLedger.restore(d).live_seqs()) for d in dests],
        )
    assert results["torch"] == results["jax"]
    assert results["torch"][1] == 8 and results["torch"][2] == 0


# the replicated read plane, its group supervisor and its standby writer:
# every ported class and function takes the reference's parameters, in its
# order, with its defaults (the port adds only ``device=``, to
# ``ReplicaServer``)
PLANE = [
    ("parallel.replicate", "DeltaStreamServer"),
    ("parallel.replicate", "DeltaStreamClient"),
    ("parallel.replicate", "publisher"),
    ("parallel.replicate", "reset_publisher"),
    ("parallel.replicate", "consolidate_rows"),
    ("parallel.replicate", "shards_env"),
    ("parallel.replicate", "corpus_shard_of"),
    ("parallel.replicate", "ring_ticks_env"),
    ("parallel.wire", "encode_frame"),
    ("parallel.wire", "decode_frame"),
    ("parallel.wire", "tap_frame"),
    ("parallel.wire", "batches_equal"),
    ("parallel.wire", "pack_uints"),
    ("parallel.wire", "unpack_uints"),
    ("serving.replica", "ReplicaServer"),
    ("serving.replica", "text_vector"),
    ("serving.replica", "staleness_bound_exceeded"),
    ("serving.replica", "hydrate_index_state"),
    ("serving.replica", "default_knn_responder"),
    ("serving.replica", "main"),
    ("serving.router", "FailoverRouter"),
    ("serving.router", "ReplicaEndpoint"),
    ("serving.router", "merge_topk"),
    ("serving.router", "validate_shard_map"),
    ("serving.router", "shard_map_from_env"),
    ("serving.router", "replicas_from_env"),
    ("serving.router", "hedge_ms_env"),
    ("serving.router", "_WfqDispatch"),
    ("serving.result_cache", "ResultCache"),
    ("serving.result_cache", "cache_from_env"),
    ("serving.result_cache", "cache_enabled_via_env"),
    ("serving.result_cache", "fingerprint"),
    ("generate.serving", "attach_generate"),
    ("generate.serving", "assemble_prompt"),
    ("generate.serving", "is_generate_route"),
    ("generate.scheduler", "generate_enabled_via_env"),
    ("persistence._runtime_glue", "state_key"),
    ("persistence._runtime_glue", "segment_key"),
    # the group supervisor and the standby writer
    ("parallel.supervisor", "GroupSupervisor"),
    ("parallel.supervisor", "max_restarts_env"),
    ("parallel.supervisor", "main"),
    ("parallel.standby", "StandbyWriter"),
    ("parallel.standby", "grace_env"),
    ("parallel.standby", "main"),
]


def _default(value):
    # an object of either package (the process registry) compares by its
    # class's name, not its address
    if type(value).__module__.startswith("pathway_tpu"):
        return type(value).__qualname__
    return repr(value)


def _plane_params(obj):
    return [
        (p.name, p.kind, _default(p.default))
        for p in inspect.signature(obj).parameters.values()
        if p.name != "device"
    ]


@pytest.mark.parametrize("module,name", PLANE, ids=[f"{m}.{n}" for m, n in PLANE])
def test_read_plane_takes_the_reference_parameters(module, name):
    import importlib

    ref = getattr(importlib.import_module(f"pathway_tpu.{module}"), name)
    port = getattr(importlib.import_module(f"pathway_tpu_torch.{module}"), name)
    assert _plane_params(port) == _plane_params(ref)
    if isinstance(ref, type):
        public = [n for n, v in vars(ref).items() if callable(v) and not n.startswith("__")]
        for method in public:
            assert _plane_params(getattr(port, method)) == _plane_params(getattr(ref, method)), method


# the multi-process engine: the host mesh, the DCN execs, the device group
# (whose functions add ``device=``, ``backend=`` and ``group=``), the CLI
# and the chaos helpers
MESH_HOST = [
    ("parallel.host_exchange", n)
    for n in ("HostMesh", "HostMeshError", "process_env", "dcn_active", "get_host_mesh", "_flush_mesh_at_exit")
] + [
    ("engine.dcn", n)
    for n in ("_DcnRouter", "_OriginTracker", "DcnGroupByExec", "DcnJoinExec", "DcnDeduplicateExec",
              "DcnSortExec", "DcnUpdateRowsExec", "DcnUniverseSetOpExec", "DcnIxExec",
              "DcnGradualBroadcastExec", "DcnExternalIndexExec", "DcnIterateExec", "DcnWatermarkExec")
] + [
    ("parallel.distributed", n)
    for n in ("process_env", "maybe_initialize", "is_multiprocess", "global_mesh", "from_process_local",
              "replicated", "to_host", "sharded_topk_global")
] + [("cli", "main")] + [
    ("testing.chaos", n) for n in ("wait_snapshot_covered", "free_dcn_port", "fold_diff_stream")
]
_PORT_ONLY = {"device", "backend", "group"}


# the elastic resizing and the autoscaler
ELASTIC = [
    ("elastic.ferry", n) for n in ("FerryReceiver", "FerryError", "ferry_files", "blob_digest")
] + [
    ("elastic.handover", n) for n in ("OwnershipMap", "TwoPhaseHandover", "HandoverError", "load_ownership")
] + [("elastic.mesh", "reshard_stores"), ("elastic.kv", "split_kv_store")] + [
    ("autoscale.policy", n) for n in ("AutoscaleConfig", "PlaneObservation", "Decision", "AutoscalePolicy")
] + [("autoscale.predictor", "LoadForecaster")] + [
    ("autoscale.controller", n)
    for n in ("ActuationError", "CallbackActuator", "SupervisorActuator", "ServingPlaneActuator",
              "AutoscaleController", "arm_controller", "get_controller", "reset_controller")
]
MESH_HOST += ELASTIC


@pytest.mark.parametrize("module,name", MESH_HOST, ids=[f"{m}.{n}" for m, n in MESH_HOST])
def test_multi_process_engine_takes_the_reference_parameters(module, name):
    import importlib

    ref = getattr(importlib.import_module(f"pathway_tpu.{module}"), name)
    port = getattr(importlib.import_module(f"pathway_tpu_torch.{module}"), name)
    assert port.__module__ == f"pathway_tpu_torch.{module}"

    def params(obj):
        return [p for p in _plane_params(obj) if p[0] not in _PORT_ONLY]

    if isinstance(ref, type) and issubclass(ref, BaseException):
        assert issubclass(port, BaseException)
        return
    assert params(port) == params(ref)
    if isinstance(ref, type):
        public = [n for n, v in vars(ref).items() if callable(v) and not n.startswith("__")]
        for method in public:
            assert params(getattr(port, method)) == params(getattr(ref, method)), method
