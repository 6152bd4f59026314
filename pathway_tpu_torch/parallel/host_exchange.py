"""The replication handshake's share of ``pathway_tpu/parallel/host_exchange.py``:
the HMAC frame and nonce sizes, the reject sentinel, the per-frame MAC and
the job key derived from ``PATHWAY_DCN_SECRET``. The constants and the key
derivation are the reference's, so a writer of one package authenticates a
replica of the other.

The host mesh itself (``HostMesh``, ``process_env``, ``dcn_active``,
``get_host_mesh``) is the multi-process engine, not ported: each raises
``NotImplementedError`` naming [mesh].
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

from pathway_tpu_torch._unported import MESH, package_getattr

_MAC_LEN = 32  # HMAC-SHA256
_NONCE_LEN = 32
# explicit (necessarily unauthenticated) rejection sentinel: the dialer
# fails fast with an auth diagnosis instead of retrying a close it cannot
# interpret
_REJECT = b"PWNO" + b"\x00" * (_MAC_LEN - 4)


def _frame_mac(key: bytes, src: int, dst: int, seq: int, body: bytes) -> bytes:
    ctx = struct.pack("<iiQ", src, dst, seq)
    return hmac.new(key, ctx + body, "sha256").digest()


def _job_key() -> bytes:
    secret = os.environ.get("PATHWAY_DCN_SECRET", "")
    if not secret:
        raise HostMeshError(
            "PATHWAY_DCN_SECRET is not set. The delta stream moves pickled "
            "frames between processes and refuses to run unauthenticated; "
            "export the same random PATHWAY_DCN_SECRET on every process."
        )
    return hashlib.sha256(("pathway-dcn:" + secret).encode()).digest()


class HostMeshError(RuntimeError):
    pass


__getattr__ = package_getattr(
    "parallel.host_exchange",
    dict.fromkeys(("HostMesh", "process_env", "dcn_active", "get_host_mesh"), MESH),
)
