"""Multi-process execution — the device group, the port's own copy of
``pathway_tpu/parallel/distributed.py`` on ``torch.distributed``.

The reference scales past one process by spawning PATHWAY_PROCESSES OS
processes (upstream Pathway: src/engine/dataflow/config.rs:88-121, env
contract PATHWAY_PROCESSES/PATHWAY_PROCESS_ID/PATHWAY_FIRST_PORT). The JAX
package joins them through ``jax.distributed``; this package joins a
``torch.distributed`` process group with the same env: the rank is
``PATHWAY_PROCESS_ID``, the world size ``PATHWAY_PROCESSES`` and the
coordinator ``MASTER_ADDR:MASTER_PORT`` (what ``cli spawn`` sets), else
``127.0.0.1:PATHWAY_FIRST_PORT`` as the reference's default.

The backend is chosen explicitly and never swapped quietly:

* ``device="cpu"``: gloo (the reference selects gloo for its CPU
  collectives);
* ``device="cuda"``: NCCL, one rank per card. NCCL refuses two ranks on one
  card, so :func:`maybe_initialize` raises naming the cause when the ranks
  on this host (``LOCAL_WORLD_SIZE``, else the whole group when the
  coordinator is local) outnumber its cards, before NCCL fails opaquely;
* ``backend="gloo"`` with ``device="cuda"``: ranks that share one card
  (``spawn --backend gloo``); collectives then stage their tensors to the
  host.

What runs multi-process on the device is corpus sharding for retrieval
(:func:`sharded_topk_global`: the block top-k kernel once per rank on its
shard, the candidates all-gathered and merged); host-side keyed engine
state spans processes over the host mesh (``parallel/host_exchange.py`` and
``engine/dcn.py``). ``pw.run`` joins this group when
``PATHWAY_JAX_DISTRIBUTED=1`` (the reference's variable); the host mesh
joins whenever PATHWAY_PROCESSES > 1. The device and backend ``pw.run``
uses come from ``PATHWAY_DIST_DEVICE`` (default ``cuda``) and
``PATHWAY_DIST_BACKEND`` (default: gloo on the CPU, NCCL on a card).
"""

from __future__ import annotations

import atexit
import os
from datetime import timedelta
from typing import Any

import numpy as np
import torch

_initialized = False


def process_env() -> tuple[int, int, str]:
    """(num_processes, process_id, coordinator) from the reference env
    contract; the coordinator is ``MASTER_ADDR:MASTER_PORT`` when both are
    set, else localhost at PATHWAY_FIRST_PORT."""
    n = int(os.environ.get("PATHWAY_PROCESSES", "1") or 1)
    pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
    first_port = int(os.environ.get("PATHWAY_FIRST_PORT", "10000") or 10000)
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    coord = f"{addr}:{port}" if addr and port else f"127.0.0.1:{first_port}"
    return n, pid, coord


def _device(device: str | torch.device | None) -> torch.device:
    dev = torch.device(device if device is not None else os.environ.get("PATHWAY_DIST_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the device group was asked for on {str(dev)!r} but torch.cuda.is_available() "
            "is False; pass device='cpu' for a gloo group on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def _local_rank(pid: int) -> int:
    return int(os.environ.get("LOCAL_RANK", pid) or pid)


def rank_device(rank: int, device: str | torch.device | None = None) -> torch.device:
    """The device rank ``rank`` of this host uses: its card
    (``local rank % cards``) for ``cuda``, the CPU for ``cpu``."""
    dev = _device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _host_ranks(n: int) -> int | None:
    """How many of the group's ``n`` ranks run on this host:
    ``LOCAL_WORLD_SIZE`` when set (``cli spawn`` sets it), else all ``n``
    when the coordinator is this host, else unknown (None: a multi-host
    group launched through the env contract, one rank per host)."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local:
        return int(local)
    host = process_env()[2].rsplit(":", 1)[0].strip("[]")
    return n if host in ("127.0.0.1", "localhost", "::1") else None


def _backend(dev: torch.device, backend: str | None, n: int) -> str:
    backend = backend or os.environ.get("PATHWAY_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unsupported torch.distributed backend {backend!r} (gloo or nccl)")
    if backend == "nccl":
        if dev.type != "cuda":
            raise RuntimeError("the NCCL backend needs device='cuda'; a CPU group runs on gloo")
        cards = torch.cuda.device_count()
        local = _host_ranks(n)
        if local is not None and local > cards:
            raise RuntimeError(
                f"NCCL cannot run {local} ranks on {cards} card(s) of this host: NCCL refuses "
                "two ranks on one card. Give each rank its own card, or name the gloo backend "
                "for ranks that share one (backend='gloo', `spawn --backend gloo`, or "
                "PATHWAY_DIST_BACKEND=gloo)"
            )
    return backend


def maybe_initialize(device: str | torch.device | None = None, backend: str | None = None) -> bool:
    """Join the process group when PATHWAY_PROCESSES > 1 (idempotent).
    Returns True when running multi-process. ``device`` defaults to
    ``PATHWAY_DIST_DEVICE`` (else ``cuda``, which raises without a card);
    ``backend`` to ``PATHWAY_DIST_BACKEND`` (else gloo on the CPU, NCCL on
    a card)."""
    global _initialized
    n, pid, coord = process_env()
    if n <= 1:
        return False
    if _initialized:
        return True
    import torch.distributed as dist

    dev = _device(device)
    name = _backend(dev, backend, n)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(_local_rank(pid), dev))
    timeout = timedelta(seconds=float(os.environ.get("PATHWAY_DCN_TIMEOUT", "300") or 300))
    try:
        dist.init_process_group(name, init_method=f"tcp://{coord}", world_size=n, rank=pid, timeout=timeout)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"PATHWAY_PROCESSES={n} but the torch.distributed process group ({name} at "
            f"tcp://{coord}, rank {pid}) could not be joined: {e}"
        ) from e
    _initialized = True
    atexit.register(_teardown)
    return True


def _teardown() -> None:
    """Destroy the group this process joined, at exit (a ``cli spawn`` rank
    exits the same way). A gloo group still open while the interpreter
    tears torch down can abort the process ("terminate called without an
    active exception") after it has done its work. A group that is already
    destroyed is left alone; an error the rank raised keeps its exit code,
    as ``atexit`` runs after it was reported."""
    global _initialized
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return _initialized or (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1)


def _group_size_rank() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(axis: str = "data", device: str | torch.device | None = "cuda"):
    """The port's ``Mesh`` over the GLOBAL device set: one entry per rank of
    the group, naming the device that rank computes on (as the ranks of one
    host resolve it). Only this rank's own entry is addressable here; the
    mesh describes the group, as the reference's global mesh does."""
    from pathway_tpu_torch.parallel.mesh import Mesh

    world, _rank = _group_size_rank()
    devices = np.empty(world, dtype=object)
    devices[:] = [rank_device(r, device) for r in range(world)]
    return Mesh(devices, (axis,))


def from_process_local(local: Any, mesh: Any, axis: str = "data", *, device: str | torch.device | None = "cuda"):
    """This rank's rows of a globally sharded array. In torch each rank holds
    its own slice as a plain tensor: this is the move of ``local`` onto the
    rank's device (the reference assembles a global ``jax.Array``); with
    ``mesh`` None, the device this rank resolves from ``device``."""
    dev = _my_device(mesh, axis, device)
    t = local if isinstance(local, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(local))
    return t.to(dev)


def replicated(value: Any, mesh: Any, *, device: str | torch.device | None = "cuda"):
    """A replicated value (every rank passes equal data): the move of
    ``value`` onto this rank's device."""
    return from_process_local(value, mesh, device=device)


def to_host(x) -> np.ndarray:
    """A result on this rank as a host array (``x.cpu().numpy()``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _my_device(mesh: Any, axis: str, device) -> torch.device:
    _world, rank = _group_size_rank()
    if mesh is not None:
        return mesh.device_of(rank, axis)
    return rank_device(_local_rank(rank), device)


def local_topk(queries: torch.Tensor, corpus: torch.Tensor, valid: torch.Tensor, k: int, *,
               metric: str = "cosine", bf16: bool = True, offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's candidates: the top ``min(k, rows)`` of its shard with ids
    offset by ``offset`` (process-major global ids), through the per-shard
    step ``ops/knn.sharded_topk`` takes (the block top-k kernel for cosine
    or dot with ``k <= 1024``, else the plain ``dense_topk_prepared``)."""
    from pathway_tpu_torch.ops.knn import _local_candidates, prepare_corpus

    prep, c2 = prepare_corpus(corpus, metric, bf16)
    q = queries.to(prep.device, torch.float32)
    return _local_candidates(q, prep, c2, valid, min(k, corpus.shape[0]), metric, bf16, offset)


def gather_merge(sc: torch.Tensor, ix: torch.Tensor, k: int, group: Any = None) -> tuple[torch.Tensor, torch.Tensor]:
    """All-gather every rank's ``[B, kk]`` candidates over the group (staged
    to the host on gloo, whose all-gather takes no CUDA tensors) and merge
    them in rank order: a stable descending top-k, so ties keep the lowest
    global id, as the kernel's tie rule. Returns (scores, ids) on ``sc``'s
    device, ids of non-finite scores -1."""
    from pathway_tpu_torch.ops.knn import _merge_shards

    world, _rank = _group_size_rank()
    if world == 1:
        return _merge_shards([(sc, ix)], k, sc.device)
    return _merge_shards(list(zip(_all_gather(sc, group), _all_gather(ix, group))), k, sc.device)


def _all_gather(t: torch.Tensor, group: Any = None) -> list[torch.Tensor]:
    """Every rank's ``t`` in rank order; on gloo a CUDA tensor is staged to
    the host first (gloo's all-gather takes CPU tensors only)."""
    import torch.distributed as dist

    world, _rank = _group_size_rank()
    send = t.cpu() if dist.get_backend(group) == "gloo" and t.is_cuda else t.contiguous()
    out = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(out, send, group=group)
    return out


def sharded_topk_global(
    queries: Any,  # [B, D] f32 — identical on every process
    corpus_local: Any,  # [n_local, D] this process's corpus rows
    valid_local: Any,  # [n_local] bool
    k: int,
    *,
    mesh: Any = None,
    axis: str = "data",
    metric: str = "cosine",
    bf16: bool = True,
    device: str | torch.device | None = "cuda",
    group: Any = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Multi-host KNN (BASELINE: 1M docs sharded across processes): each
    process contributes its corpus shard, the queries are replicated. Each
    rank runs the block top-k kernel on its shard on its device, offsets
    its ids process-major (rank * n_local, as the reference's
    ``shard_base_indices``), and the ``[B, k]`` candidates all-gather over
    the group and merge with the lowest global id first on ties. Every
    shard must hold the same row count (pad + mask). Returns host (scores,
    ids) with ids indexing the GLOBAL corpus."""
    dev = _my_device(mesh, axis, device)
    corpus = from_process_local(corpus_local, None, device=dev)
    valid = from_process_local(np.asarray(valid_local, bool) if not isinstance(valid_local, torch.Tensor)
                               else valid_local, None, device=dev).bool()
    if corpus.dtype != torch.float32:
        corpus = corpus.float()
    n_local = corpus.shape[0]
    world, rank = _group_size_rank()
    if world > 1:
        sizes = _all_gather(torch.tensor([n_local], dtype=torch.int64, device=dev), group)
        if len({int(s) for s in sizes}) != 1:
            raise ValueError(f"every shard must hold the same row count, got {[int(s) for s in sizes]}")
    q = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(np.asarray(queries, np.float32))
    sc, ix = local_topk(q.to(dev), corpus, valid, k, metric=metric, bf16=bf16, offset=rank * n_local)
    sc, ix = gather_merge(sc, ix, k, group)
    return to_host(sc), to_host(ix)
