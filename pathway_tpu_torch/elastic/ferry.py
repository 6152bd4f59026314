"""Own copy of ``pathway_tpu/elastic/ferry.py`` over the port's host-exchange
helpers: the same ``PWFY1`` handshake, frames and segment MACs, so a sender
of either package commits into a receiver of the other.

SegmentFerry — stream arrangement segments to their new owners.

The transfer rides the PWHX wire family: the same per-job shared-secret
nonce challenge-response as the host mesh and the replication stream
(parallel/host_exchange.py, parallel/replicate.py), length-prefixed
frames each MAC'd over (src, dst, seq, body).  On top of the framed
link every SEGMENT carries its own integrity MAC — HMAC-SHA256 over
(transfer id, blob name, payload) — so a blob staged on disk across a
reconnect is still provably the bytes the sender meant, not just the
bytes the link delivered.

Resumability is content-addressed, like everything else in the State
Ledger lineage: the sender OFFERS the manifest (names + digests), the
receiver answers with what it already staged, and only the missing
blobs cross the wire.  A transfer killed mid-flight (the Fault Forge
``kill=ferry:N`` directive counts segments sent, so chaos tests land
the death deterministically) leaves staged blobs under the transfer's
staging directory; a retry ships only the remainder; ``commit`` moves
the staged set into place atomically per blob and only then reports
success — the two-phase handover (elastic/handover.py) never commits
an ownership map over a half-arrived transfer.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import socket
import struct
import threading
from typing import Any

from pathway_tpu_torch.parallel import wire
from pathway_tpu_torch.parallel.host_exchange import (
    _MAC_LEN,
    _NONCE_LEN,
    _REJECT,
    _frame_mac,
    _job_key,
)

_FERRY_MAGIC = b"PWFY1"  # segment-ferry protocol lane (sits beside the
# mesh's PWHX7 and the replication stream's PWRP2: a ferry peer is
# neither a rank nor a subscriber, so it gets its own handshake magic)
_OK_TAG = b"PWFO"
_FERRY_SRC = -7  # reserved src id for ferry frame MACs (never a rank)


class FerryError(RuntimeError):
    pass


def _segment_mac(key: bytes, transfer_id: str, name: str, blob: bytes) -> bytes:
    return hmac.new(
        key, transfer_id.encode() + b"\x00" + name.encode() + b"\x00" + blob,
        "sha256",
    ).digest()


def blob_digest(blob: bytes) -> str:
    """Content address of one ferried blob (resume identity)."""
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def _read_exact(conn: socket.socket, count: int) -> bytes | None:
    buf = b""
    while len(buf) < count:
        try:
            chunk = conn.recv(count - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


class _Framed:
    """One authenticated framed link (either side): seq-MAC'd frames of
    pickled control tuples / raw segment payloads."""

    def __init__(self, conn: socket.socket, key: bytes):
        self.conn = conn
        self.key = key
        self.send_seq = 0
        self.recv_seq = 0

    def send(self, frame: tuple) -> None:
        body, _stats = wire.encode_frame(frame, "pickle", None)
        mac = _frame_mac(self.key, _FERRY_SRC, _FERRY_SRC, self.send_seq, body)
        self.send_seq += 1
        self.conn.sendall(struct.pack("<I", len(body)) + mac + body)

    def recv(self) -> tuple | None:
        head = _read_exact(self.conn, 4 + _MAC_LEN)
        if head is None:
            return None
        (length,) = struct.unpack("<I", head[:4])
        body = _read_exact(self.conn, length)
        if body is None:
            return None
        if not hmac.compare_digest(
            head[4:],
            _frame_mac(self.key, _FERRY_SRC, _FERRY_SRC, self.recv_seq, body),
        ):
            return None  # forged/replayed frame: drop the link
        self.recv_seq += 1
        try:
            return wire.decode_frame(body)
        except Exception:
            return None


class FerryReceiver:
    """New-owner side: accepts authenticated transfers into a staging
    area, commits them into ``dest_dir`` on the sender's commit frame.

    ``received`` maps transfer_id -> {name: path} for committed
    transfers; ``staged(transfer_id)`` lists what a torn transfer left
    behind (the resume inventory).  ``abort(transfer_id)`` discards a
    rolled-back transfer's staging."""

    def __init__(self, dest_dir: str, host: str = "127.0.0.1", port: int = 0):
        self.dest_dir = dest_dir
        self._staging = os.path.join(dest_dir, ".ferry-staging")
        os.makedirs(self._staging, exist_ok=True)
        self._key = _job_key()
        self._lock = threading.Lock()
        self.received: dict[str, dict[str, str]] = {}
        self.committed: list[str] = []
        self._closed = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self.host = host
        self.port = self._listener.getsockname()[1]
        self._listener.listen(8)
        threading.Thread(
            target=self._accept_loop, daemon=True, name="pw-ferry-accept"
        ).start()

    # --- staging inventory ------------------------------------------------

    def _stage_dir(self, transfer_id: str) -> str:
        safe = hashlib.blake2b(
            transfer_id.encode(), digest_size=8
        ).hexdigest()
        return os.path.join(self._staging, safe)

    def staged(self, transfer_id: str) -> set[str]:
        """Digests already staged for a transfer (the resume set)."""
        d = self._stage_dir(transfer_id)
        if not os.path.isdir(d):
            return set()
        return {f for f in os.listdir(d) if not f.endswith(".tmp")}

    def abort(self, transfer_id: str) -> None:
        """Roll back: discard everything a torn transfer staged."""
        import shutil

        shutil.rmtree(self._stage_dir(transfer_id), ignore_errors=True)

    # --- wire -------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            nonce = os.urandom(_NONCE_LEN)
            conn.settimeout(30.0)
            conn.sendall(nonce)
            hello = _read_exact(conn, len(_FERRY_MAGIC) + _MAC_LEN)
            if hello is None or hello[: len(_FERRY_MAGIC)] != _FERRY_MAGIC:
                conn.close()
                return
            claimed, mac = hello[:-_MAC_LEN], hello[-_MAC_LEN:]
            if not hmac.compare_digest(
                mac, hmac.new(self._key, claimed + nonce, "sha256").digest()
            ):
                try:
                    conn.sendall(_REJECT)
                except OSError:
                    pass
                conn.close()
                return
            conn.sendall(
                hmac.new(
                    self._key, _OK_TAG + nonce + claimed, "sha256"
                ).digest()
            )
            conn.settimeout(None)
            link = _Framed(conn, self._key)
            self._transfer_loop(link)
        except Exception:
            pass  # fail-stop the link; the sender resumes
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _transfer_loop(self, link: _Framed) -> None:
        transfer_id: str | None = None
        manifest: dict[str, str] = {}  # digest -> name
        while True:
            frame = link.recv()
            if frame is None:
                return
            kind = frame[0]
            if kind == "offer":
                # ("offer", transfer_id, [(name, digest), ...])
                _k, transfer_id, entries = frame
                manifest = {dig: name for name, dig in entries}
                os.makedirs(self._stage_dir(transfer_id), exist_ok=True)
                link.send(("have", sorted(self.staged(transfer_id))))
            elif kind == "seg":
                # ("seg", transfer_id, name, digest, payload, seg_mac)
                _k, tid, name, dig, payload, seg_mac = frame
                if tid != transfer_id:
                    return
                expect = _segment_mac(self._key, tid, name, payload)
                if not hmac.compare_digest(seg_mac, expect):
                    return  # tampered segment: drop the link, no ack
                if blob_digest(payload) != dig:
                    return
                path = os.path.join(self._stage_dir(tid), dig)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)
                link.send(("ack", dig))
            elif kind == "commit":
                # ("commit", transfer_id): every manifest digest staged →
                # move blobs into dest_dir under their offered names
                _k, tid = frame
                if tid != transfer_id:
                    return
                have = self.staged(tid)
                missing = set(manifest) - have
                if missing:
                    link.send(("incomplete", sorted(missing)))
                    continue
                placed: dict[str, str] = {}
                # manifests last: a crash mid-placement must never leave
                # a manifest naming segment files not yet in place
                ordered = sorted(
                    manifest.items(),
                    key=lambda kv: (kv[1].endswith("manifest.json"), kv[1]),
                )
                for dig, name in ordered:
                    final = os.path.join(self.dest_dir, name)
                    os.makedirs(os.path.dirname(final), exist_ok=True)
                    os.replace(
                        os.path.join(self._stage_dir(tid), dig), final
                    )
                    placed[name] = final
                with self._lock:
                    self.received[tid] = placed
                    self.committed.append(tid)
                self.abort(tid)  # clear the (now empty) staging dir
                link.send(("committed", tid))
            else:
                return

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass


def ferry_files(
    host: str,
    port: int,
    files: list[tuple[str, bytes]],
    *,
    transfer_id: str,
    connect_timeout: float = 30.0,
    commit: bool = True,
) -> dict[str, Any]:
    """Old-owner side: ship ``files`` (name, blob) to a
    :class:`FerryReceiver` and (by default) commit the transfer.

    Returns stats: segments offered/sent/skipped (resume hits) and
    bytes sent.  The Fault Forge ``kill=ferry:N`` directive fires on
    the deterministic sent-segment counter — BEFORE the commit frame,
    so an injected death always leaves a rollback-able transfer.

    The whole transfer is a ``ferry.transfer`` root span (Fleet Lens:
    the previously-untraced hop of a reshard), carrying the resume
    arithmetic as attributes."""
    from pathway_tpu_torch.observability.tracing import get_tracer

    with get_tracer().span(
        "ferry.transfer",
        root=True,
        transfer_id=transfer_id,
        segments=len(files),
    ) as span:
        stats = _ferry_files(
            host,
            port,
            files,
            transfer_id=transfer_id,
            connect_timeout=connect_timeout,
            commit=commit,
        )
        span.set_attribute("segments_sent", stats["segments_sent"])
        span.set_attribute("segments_resumed", stats["segments_resumed"])
        span.set_attribute("bytes_sent", stats["bytes_sent"])
        return stats


def _ferry_files(
    host: str,
    port: int,
    files: list[tuple[str, bytes]],
    *,
    transfer_id: str,
    connect_timeout: float = 30.0,
    commit: bool = True,
) -> dict[str, Any]:
    from pathway_tpu_torch.testing import faults

    key = _job_key()
    s = socket.create_connection((host, port), timeout=connect_timeout)
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(30.0)
        nonce = _read_exact(s, _NONCE_LEN)
        if nonce is None:
            raise FerryError("receiver closed during handshake")
        hello = _FERRY_MAGIC
        s.sendall(hello + hmac.new(key, hello + nonce, "sha256").digest())
        ok = _read_exact(s, _MAC_LEN)
        if ok is None:
            raise FerryError("receiver closed during handshake")
        if ok == _REJECT:
            raise FerryError(
                "ferry receiver rejected the handshake — authentication "
                "failed (is PATHWAY_DCN_SECRET identical on both ends?)"
            )
        expected = hmac.new(key, _OK_TAG + nonce + hello, "sha256").digest()
        if not hmac.compare_digest(ok, expected):
            raise FerryError("unexpected ferry handshake response")
        s.settimeout(None)
        link = _Framed(s, key)
        digests = [(name, blob_digest(blob)) for name, blob in files]
        link.send(("offer", transfer_id, digests))
        frame = link.recv()
        if frame is None or frame[0] != "have":
            raise FerryError("ferry offer was not answered")
        have = set(frame[1])
        plan = faults.active()
        sent = 0
        skipped = 0
        bytes_sent = 0
        for (name, blob), (_n, dig) in zip(files, digests):
            if dig in have:
                skipped += 1
                continue
            link.send(
                (
                    "seg",
                    transfer_id,
                    name,
                    dig,
                    blob,
                    _segment_mac(key, transfer_id, name, blob),
                )
            )
            ack = link.recv()
            if ack is None or ack[0] != "ack" or ack[1] != dig:
                raise FerryError(f"segment {name} was not acknowledged")
            sent += 1
            bytes_sent += len(blob)
            if plan is not None:
                # deterministic chaos clock: fires AFTER the ack, BEFORE
                # any commit — a kill here always leaves a resumable,
                # rollback-able transfer
                plan.on_ferry_segment(sent)
        committed = False
        if commit:
            link.send(("commit", transfer_id))
            frame = link.recv()
            if frame is None:
                raise FerryError("ferry commit was not answered")
            if frame[0] == "incomplete":
                raise FerryError(
                    f"ferry commit refused: missing segments {frame[1]}"
                )
            if frame[0] != "committed":
                raise FerryError(f"unexpected ferry commit reply {frame[0]!r}")
            committed = True
        return {
            "transfer_id": transfer_id,
            "segments_offered": len(files),
            "segments_sent": sent,
            "segments_resumed": skipped,
            "bytes_sent": bytes_sent,
            "committed": committed,
        }
    finally:
        try:
            s.close()
        except OSError:
            pass
