"""Generation-plane resharding — counterpart of ``pathway_tpu/elastic/kv.py``.

The decode scheduler's in-flight state — KV pages + resumable sequence
metadata — lives in arrangement ledgers keyed by the sequence's jk hash
(``generate/kv_cache.py``), which is the ownership function the rest of the
system reshards by. ``split_kv_store`` re-partitions a generation member's
snapshot directory into per-new-owner snapshot directories: each new owner's
``DecodeScheduler(store_root=..., restore=True)`` then resumes the in-flight
decodes it now owns, token streams continuing as they would have.

Not ported: a destination given as a ``(host, port)`` ferry endpoint needs
``elastic/ferry.py`` and the wire it rides (``parallel/wire.py``,
``parallel/host_exchange.py``); it raises ``NotImplementedError`` naming
[mesh] instead of writing anything. ``transfer_id=`` is accepted as in the
reference; it names only ferry transfers, so local destinations ignore it.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from pathway_tpu_torch._unported import MESH, unported
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


def split_kv_store(
    src_root: str,
    destinations: list[Any],
    *,
    transfer_id: str | None = None,
) -> dict:
    """Re-partition a generation snapshot directory into per-owner stores
    (index = new shard). Each destination is a local directory path.
    Raises ``HandoverError`` when ``src_root`` holds no snapshot, and
    ``NotImplementedError`` for a ``(host, port)`` ferry endpoint, before
    anything is written. The result has the reference's keys (``ferry``
    None and ``bytes_ferried`` 0 for local destinations)."""
    remote = [d for d in destinations if isinstance(d, (tuple, list))]
    if remote:
        raise unported(
            f"split_kv_store to ferry destinations {remote} (elastic/ferry.py)", MESH
        )
    led = KvLedger.restore(src_root)
    if led is None:
        raise HandoverError(
            f"{src_root} holds no committed generation snapshot"
        )
    n_new = len(destinations)
    parts = split_ledger(led, n_new)
    out: dict[str, Any] = {"n_new": n_new, "destinations": []}
    for part, dest in zip(parts, destinations):
        os.makedirs(dest, exist_ok=True)
        out["destinations"].append(
            {
                "dest": str(dest),
                "seqs": len(part.live_seqs()),
                "snapshot": part.snapshot(dest),
                "ferry": None,
            }
        )
    out["total_seqs"] = len(led.live_seqs())
    out["bytes_ferried"] = 0
    return out
