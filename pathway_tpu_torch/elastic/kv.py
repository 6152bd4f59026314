"""Generation-plane resharding — own copy of ``pathway_tpu/elastic/kv.py``.

The decode scheduler's in-flight state — KV pages + resumable sequence
metadata — lives in arrangement ledgers keyed by the sequence's jk hash
(``generate/kv_cache.py``), which is the ownership function the rest of the
system reshards by. ``split_kv_store`` re-partitions a generation member's
snapshot directory into per-new-owner snapshot directories: each new owner's
``DecodeScheduler(store_root=..., restore=True)`` then resumes the in-flight
decodes it now owns, token streams continuing as they would have. A
destination given as a ferry endpoint receives its snapshot over the
authenticated SegmentFerry wire (per-segment MACs, resume) — the new owner
can live on another host.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any

import numpy as np

from pathway_tpu_torch.elastic.handover import HandoverError
from pathway_tpu_torch.engine.sharded import shard_of
from pathway_tpu_torch.generate.kv_cache import KvLedger, seq_jk


def seq_owner(seq_id: int, n_shards: int) -> int:
    """The shard owning one in-flight sequence — the sequence's ledger jk
    (``kv_cache.seq_jk``) through the system-wide jk-hash partition."""
    jk = np.asarray([seq_jk(seq_id)], dtype=np.uint64)
    return int(shard_of(jk, n_shards)[0])


def split_ledger(led: KvLedger, n_new: int) -> list[KvLedger]:
    """Split one KV ledger's live state into one ledger per new owner.
    Rebuilt through the mirror API, so each part is consolidated (only
    live pages/seqs — a handoff never carries retracted history)."""
    parts = [KvLedger() for _ in range(n_new)]
    for seq_id, meta in led.live_seqs().items():
        parts[seq_owner(seq_id, n_new)].put_seq(seq_id, dict(meta))
    for (seq_id, page_idx), cols in led.live_pages().items():
        k_page, v_page = cols[0], cols[1]
        parts[seq_owner(seq_id, n_new)].put_page(
            seq_id, page_idx, np.array(k_page), np.array(v_page)
        )
    return parts


def _snapshot_files(root: str) -> list[tuple[str, bytes]]:
    files = []
    for base, _dirs, names in os.walk(root):
        for f in names:
            full = os.path.join(base, f)
            rel = os.path.relpath(full, root)
            with open(full, "rb") as fh:
                files.append((rel, fh.read()))
    return files


def split_kv_store(
    src_root: str,
    destinations: list[Any],
    *,
    transfer_id: str | None = None,
) -> dict:
    """Re-partition a generation snapshot directory into per-owner
    stores (index = new shard).  Each destination is either a local
    directory path (written directly — the same-filesystem O(copy)
    path) or a ``(host, port)`` ferry endpoint whose
    :class:`~pathway_tpu_torch.elastic.ferry.FerryReceiver` roots the remote
    owner's store.  Raises when ``src_root`` holds no snapshot."""
    from pathway_tpu_torch.elastic.ferry import ferry_files

    led = KvLedger.restore(src_root)
    if led is None:
        raise HandoverError(
            f"{src_root} holds no committed generation snapshot"
        )
    n_new = len(destinations)
    parts = split_ledger(led, n_new)
    tid = transfer_id or f"kv-reshard-{n_new}"
    out: dict[str, Any] = {"n_new": n_new, "destinations": []}
    moved_bytes = 0
    for p, (part, dest) in enumerate(zip(parts, destinations)):
        n_seqs = len(part.live_seqs())
        ferry = None
        if isinstance(dest, (tuple, list)):
            host, port = dest
            tmp = tempfile.mkdtemp(prefix="pw-kv-ferry-")
            try:
                stats = part.snapshot(tmp)
                ferry = ferry_files(
                    host,
                    int(port),
                    _snapshot_files(tmp),
                    transfer_id=f"{tid}-p{p}",
                )
                moved_bytes += ferry["bytes_sent"]
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            where = f"{host}:{port}"
        else:
            os.makedirs(dest, exist_ok=True)
            stats = part.snapshot(dest)
            where = str(dest)
        out["destinations"].append(
            {
                "dest": where,
                "seqs": n_seqs,
                "snapshot": stats,
                "ferry": ferry,
            }
        )
    out["total_seqs"] = len(led.live_seqs())
    out["bytes_ferried"] = moved_bytes
    return out
