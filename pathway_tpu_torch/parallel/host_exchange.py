"""Cross-process host-row exchange — the port's own copy of
``pathway_tpu/parallel/host_exchange.py``: the same hello, MACs, frames,
heartbeats and env contract, so a mesh of this package and one of the
JAX package authenticate each other and exchange the same values. The
mesh is host-only (sockets and threads); no device is touched.

The reference moves *all* dataflow records between worker processes over
timely's TCP mesh (reference:
external/timely-dataflow/communication/src/networking.rs:16-33 — one
framed socket per process pair, handshake magic + peer id;
src/engine/dataflow/config.rs:88-121 — PATHWAY_PROCESSES/PROCESS_ID/
FIRST_PORT env contract). The device data stays on the device collectives
(``parallel/distributed.py``) and *host* keyed rows take this mesh: every process
pair holds a framed TCP connection, DiffBatch partitions travel as
typed columnar frames (parallel/wire.py — delta-varint keys, packed
diffs, raw/optionally-quantized value columns; PATHWAY_DCN_WIRE=pickle
restores the PWHX5 whole-frame pickle), and a value-exchange barrier
doubles as the lockstep tick scheduler (the frontier consensus of
timely's progress tracking).

Overlap: ``send`` enqueues the frame onto a bounded per-peer outbox
drained by one sender thread per peer, which does the encode + MAC +
``sendall`` off the caller's thread — so encoding and TCP of one
channel's partitions overlap the next channel's partition/compute, and
the old serialize-under-lock critical section is gone. Per-peer frame
order (and therefore the MAC sequence) is the enqueue order; a full
outbox back-pressures the producer instead of buffering unboundedly.
A send failure fail-stops exactly like a dead reader: the peer is
marked dead and the next gather/barrier raises HostMeshError.

Failure model (Phoenix Mesh): peer death is DETECTED, not merely
stumbled into. Every connection carries periodic heartbeat frames
(PATHWAY_MESH_HEARTBEAT_MS); a liveness monitor marks a peer dead when
nothing — data, barrier or heartbeat — has arrived within
PATHWAY_MESH_LIVENESS_TIMEOUT_MS (socket EOF and send failures mark it
dead immediately). Registered ``FailureListener`` callbacks fire the
moment a peer is declared dead, so the runtime (and the serving
degradation controller) learn about the failure instead of discovering
it inside a gather; any pending gather/barrier then raises
HostMeshError naming the dead peer and the recorded cause. The process
exits nonzero, and the group supervisor (parallel/supervisor.py)
restarts the WHOLE group, which restores the latest group-committed
snapshot generation (persistence/_runtime_glue.py) — the reference's
recovery model (whole-cluster restart from the persisted frontier,
src/persistence/state.rs:291), now with bounded detection latency and a
bounded restart budget (PATHWAY_MESH_MAX_RESTARTS).

Authentication: frames carry pickled payloads, which execute code on
load, so the mesh authenticates under a per-job shared secret
(PATHWAY_DCN_SECRET — the CLI `spawn` generates one per job; manual
launches must export it on every process). The hello is a
challenge-response (acceptor sends a random nonce, dialer answers with
an HMAC over it — a captured hello cannot be replayed to frame a peer
as dead; the acceptor then returns an authenticated OK so a secret
mismatch fails fast at dial time), and every frame MAC covers
(src, dst, sequence number, body),
so frames cannot be forged, reflected to a different peer, or replayed
out of order. Unauthenticated bytes are dropped before they ever reach
pickle.loads. The reference's timely mesh is unauthenticated but
deserializes data-only bincode; pickle needs the stronger gate.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import queue
import socket
import struct
import threading
import time
from typing import Any

from pathway_tpu_torch.observability.tracing import (
    get_tracer,
    pending_traceparent,
    propagation_traceparent,
)
from pathway_tpu_torch.parallel import wire

_HELLO_MAGIC = b"PWHX7"  # protocol version tag (networking.rs handshake
# analog); v7 adds per-peer heartbeat control frames ("hb") and the
# failure-listener liveness contract (Phoenix Mesh) — a v6 peer would
# treat heartbeats as unknown frames, so the version bump fails fast via
# the established PWVN reject; v6 switched frame bodies to the tagged
# columnar wire codec (parallel/wire.py — a leading 'C'/'P' byte
# self-describes each frame, so codec and pickle frames interoperate
# inside one connection); v5 appended the W3C traceparent slot that
# stitches traces across processes (Trace Weaver)
_MAC_LEN = 32  # HMAC-SHA256
_NONCE_LEN = 32
_OK_TAG = b"PWOK"  # acceptor's authenticated handshake acknowledgment
# explicit (necessarily unauthenticated — we don't share a key with a
# mismatched dialer) rejection sentinel: lets the dialer fail fast with
# an auth diagnosis instead of retrying a close it can't interpret. A
# forged reject is at worst a startup DoS an on-path attacker could
# already cause with a TCP reset.
_REJECT = b"PWNO" + b"\x00" * (_MAC_LEN - 4)
# version-mismatch sentinel: a peer that shares the PWHX prefix but
# speaks another protocol version gets told so explicitly — the dialer
# fails fast with a clear diagnosis instead of retrying a silent close
# until the connect deadline. Carries the acceptor's magic so the error
# can name both versions. Same threat model note as _REJECT: forging it
# is at worst a startup DoS an on-path attacker already has via RST.
_VREJECT_TAG = b"PWVN"


def _version_reject() -> bytes:
    out = _VREJECT_TAG + _HELLO_MAGIC
    return out + b"\x00" * (_MAC_LEN - len(out))


def _frame_mac(key: bytes, src: int, dst: int, seq: int, body: bytes) -> bytes:
    ctx = struct.pack("<iiQ", src, dst, seq)
    return hmac.new(key, ctx + body, "sha256").digest()


def _job_key() -> bytes:
    secret = os.environ.get("PATHWAY_DCN_SECRET", "")
    if not secret:
        raise HostMeshError(
            "PATHWAY_DCN_SECRET is not set. The host mesh moves pickled "
            "frames between processes and refuses to run unauthenticated; "
            "launch the job with `python -m pathway_tpu_torch.cli spawn` "
            "(which generates a per-job secret) or export the same random "
            "PATHWAY_DCN_SECRET on every process."
        )
    return hashlib.sha256(("pathway-dcn:" + secret).encode()).digest()


class HostMeshError(RuntimeError):
    pass


def process_env() -> tuple[int, int, int, str]:
    """(n_processes, process_id, base_port, host) from the reference env
    contract."""
    n = int(os.environ.get("PATHWAY_PROCESSES", "1") or 1)
    pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
    port = int(os.environ.get("PATHWAY_DCN_PORT", "10700") or 10700)
    host = os.environ.get("PATHWAY_DCN_HOST", "127.0.0.1")
    return n, pid, port, host


class HostMesh:
    """Full TCP mesh between N engine processes.

    Each process listens on base_port+pid and dials every peer; the dialing
    side sends a hello frame carrying its process id, so each ordered pair
    (src -> dst) has exactly one connection used for src's sends. Frames
    are length-prefixed tagged bodies (parallel/wire.py — columnar codec
    for DiffBatch payloads, pickle for everything else) logically shaped:

      ("data", src, channel, tick, payload, tp)  — DiffBatch partitions
      ("bar",  src, round, value, tp)            — barrier value exchange

    Sends are asynchronous: ``send``/``barrier`` enqueue onto the
    destination's bounded outbox and the per-peer sender thread performs
    encode + MAC + sendall, so wire work overlaps the caller's compute.
    The payload's ownership transfers to the mesh at enqueue — callers
    must not mutate a sent batch.

    `tp` is the sender's W3C traceparent (or None): cross-host context
    propagation for the Trace Weaver. ``barrier()`` records the group's
    traceparents in ``last_barrier_tps`` — the lockstep tick scheduler
    reads it to agree on ONE tick trace group-wide (engine/runtime.py);
    ``gather()`` records them in ``last_gather_tps`` for the DCN
    exchange spans.
    """

    def __init__(
        self,
        n: int,
        pid: int,
        base_port: int,
        host: str = "127.0.0.1",
        connect_timeout: float = 60.0,
    ):
        self.n = n
        self.pid = pid
        self.base_port = base_port
        self.host = host
        self._key = _job_key()
        # wire-format knobs, resolved once per mesh: PATHWAY_DCN_WIRE
        # picks the data-frame encoding (codec|pickle), PATHWAY_DCN_QUANT
        # opts value columns into the lossy tier (bf16|int8; keys, diffs
        # and non-float columns stay lossless regardless — wire.py never
        # quantizes them)
        self.wire_format = os.environ.get("PATHWAY_DCN_WIRE", "codec")
        if self.wire_format not in ("codec", "pickle"):
            raise HostMeshError(
                f"PATHWAY_DCN_WIRE={self.wire_format!r}: expected "
                "'codec' or 'pickle'"
            )
        self.wire_quant = os.environ.get("PATHWAY_DCN_QUANT", "") or None
        if self.wire_quant not in (None, "bf16", "int8"):
            raise HostMeshError(
                f"PATHWAY_DCN_QUANT={self.wire_quant!r}: expected "
                "'bf16', 'int8', or unset (lossless)"
            )
        # Flight Recorder: DCN traffic accounting. Peer cardinality is the
        # process-group size (small); every process also exposes its own
        # id via the `process` label on pathway_build_info-adjacent scrape
        # configs, so multi-host dashboards aggregate by (job, process).
        from pathway_tpu_torch.observability import REGISTRY

        self._m_sent_bytes = REGISTRY.counter(
            "pathway_host_exchange_sent_bytes_total",
            "framed bytes sent over the host mesh, by destination peer",
            labelnames=("peer",),
        )
        self._m_sent_msgs = REGISTRY.counter(
            "pathway_host_exchange_sent_messages_total",
            "frames sent over the host mesh, by destination peer",
            labelnames=("peer",),
        )
        self._m_recv_bytes = REGISTRY.counter(
            "pathway_host_exchange_recv_bytes_total",
            "framed bytes received over the host mesh, by source peer",
            labelnames=("peer",),
        )
        self._m_recv_msgs = REGISTRY.counter(
            "pathway_host_exchange_recv_messages_total",
            "frames received over the host mesh, by source peer",
            labelnames=("peer",),
        )
        self._m_barrier_seconds = REGISTRY.histogram(
            "pathway_host_exchange_barrier_seconds",
            "barrier round-trip: send-to-all until all peers' values "
            "arrive (the lockstep tick scheduler's cadence)",
        )
        self._m_gather_seconds = REGISTRY.histogram(
            "pathway_host_exchange_gather_seconds",
            "wait for one payload from every peer on a data channel",
        )
        self._m_encode_seconds = REGISTRY.histogram(
            "pathway_host_exchange_encode_seconds",
            "wire-encode time per frame, by the format actually used "
            "(barrier/scalar frames ride the pickle path even under "
            "PATHWAY_DCN_WIRE=codec)",
            labelnames=("wire",),
        )
        self._m_decode_seconds = REGISTRY.histogram(
            "pathway_host_exchange_decode_seconds",
            "wire-decode time per received frame, by format",
            labelnames=("wire",),
        )
        self._m_ratio = REGISTRY.gauge(
            "pathway_host_exchange_compression_ratio",
            "dense in-memory bytes / wire bytes of the most recent codec "
            "data frame, by exchange channel",
            labelnames=("channel",),
        )
        self._m_outbox_depth = REGISTRY.gauge(
            "pathway_host_exchange_outbox_depth",
            "frames waiting on the per-peer sender outbox (bounded by "
            "PATHWAY_DCN_OUTBOX; a full outbox back-pressures the tick)",
            labelnames=("peer",),
        )
        self._cv = threading.Condition()
        # (channel, tick) -> {src: payload}
        self._data: dict[tuple[str, int], dict[int, Any]] = {}
        # round -> {src: value}
        self._bars: dict[int, dict[int, Any]] = {}
        # received traceparents, keyed like their payloads; gather moves
        # its key's entry into _gathered_tps for take_gather_tps (keyed,
        # not a shared "last" slot — concurrent gathers on different
        # channels must not clobber each other's remote traces)
        self._data_tps: dict[tuple[str, int], dict[int, str]] = {}
        self._bar_tps: dict[int, dict[int, str]] = {}
        self._gathered_tps: dict[tuple[str, int], dict[int, str]] = {}
        # {pid: traceparent|None} of the last completed barrier (barriers
        # are lockstep on one thread, so a single slot is race-free)
        self.last_barrier_tps: dict[int, str | None] = {}
        self._round = 0
        self._dead: set[int] = set()
        # peer pid -> human-readable cause recorded when the peer was
        # declared dead (EOF, send failure, liveness timeout) — surfaced
        # in every subsequent HostMeshError so the supervisor log names
        # the root cause, not just the gather that tripped over it
        self._dead_reason: dict[int, str] = {}
        # Phoenix Mesh: failure listeners fire (peer, reason) the moment
        # a peer is declared dead — the runtime and the serving
        # degradation controller subscribe so recovery starts at
        # detection time, not at the next gather
        self._failure_listeners: list = []
        # liveness: last monotonic instant ANY frame (data/bar/hb)
        # arrived from each peer; heartbeats keep this fresh on idle
        # connections so the monitor can tell "slow tick" from "dead or
        # wedged peer"
        _hb_ms = float(
            os.environ.get("PATHWAY_MESH_HEARTBEAT_MS", "1000") or 1000
        )
        # floor at 50 ms: a zero/tiny interval would busy-spin the
        # heartbeat thread and flood every outbox (disable monitoring
        # with PATHWAY_MESH_LIVENESS_TIMEOUT_MS=0, not by zeroing the
        # send interval)
        self.heartbeat_s = max(_hb_ms, 50.0) / 1000.0
        # generous default: a long GIL-holding kernel build on the peer
        # can starve its heartbeat thread for seconds — the timeout must
        # catch dead/wedged peers, not slow ones (0 disables monitoring;
        # socket EOF and send failures still detect clean deaths fast)
        self.liveness_timeout_s = (
            float(
                os.environ.get("PATHWAY_MESH_LIVENESS_TIMEOUT_MS", "30000")
                or 30000
            )
            / 1000.0
        )
        self._last_heard: dict[int, float] = {}
        # peer pid -> its PWHX magic, recorded when a peer running a
        # DIFFERENT protocol version dials us with a valid job-secret
        # MAC (a genuinely old build cannot understand our PWVN reject,
        # but its authenticated hello proves the skew — our own dial
        # loop for that peer aborts with the version diagnosis instead
        # of retrying into the connect deadline)
        self._version_skew: dict[int, bytes] = {}
        self._out: dict[int, socket.socket] = {}
        self._closed = False
        # receive-side decode pool (wide fan-in long tail): each peer
        # already has its own reader thread, but that thread decodes a
        # frame before it can recv the NEXT one — on wide fan-ins the
        # per-link decode serializes behind the gather wait.  A small
        # shared pool takes (MAC-verified) bodies off the readers so
        # recv and decode overlap across peers.  Safe to run unordered:
        # every delivery slot is keyed (channel, tick, src) and written
        # once.  PATHWAY_DCN_DECODE_POOL: "" = auto (pool of
        # min(4, n-1) threads once the fan-in is ≥ 3 peers), 0 = inline
        # decode (the pre-pool behavior), N = N threads.
        pool_raw = os.environ.get("PATHWAY_DCN_DECODE_POOL", "") or ""
        if pool_raw:
            try:
                pool_n = int(pool_raw)
            except ValueError:
                raise HostMeshError(
                    f"PATHWAY_DCN_DECODE_POOL={pool_raw!r} is not an int"
                ) from None
        else:
            pool_n = min(4, n - 1) if n - 1 >= 3 else 0
        self._decode_pool = None
        self._decode_slots: threading.Semaphore | None = None
        if pool_n > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._decode_pool = ThreadPoolExecutor(
                max_workers=pool_n,
                thread_name_prefix=f"pw-dcn-decode-{pid}",
            )
            # BOUNDED pending-decode backlog: the inline path's natural
            # backpressure (reader busy decoding → kernel socket buffer
            # fills → sender blocks) must survive the pool, or
            # undecoded bodies accumulate without limit under a gather
            # storm — readers block here instead, like every other
            # bounded queue in this subsystem
            self._decode_slots = threading.Semaphore(pool_n * 8)
        # per-peer overlapped delivery: bounded outbox + one sender
        # thread per peer (owns that connection's MAC sequence counter)
        depth = int(os.environ.get("PATHWAY_DCN_OUTBOX", "32") or 32)
        self._outbox: dict[int, queue.Queue] = {}
        self._senders: dict[int, threading.Thread] = {}
        self._send_failed: dict[int, BaseException] = {}

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, base_port + pid))
        self._listener.listen(n)
        threading.Thread(target=self._accept_loop, daemon=True).start()

        deadline = time.monotonic() + connect_timeout
        for peer in range(n):
            if peer == pid:
                continue
            self._out[peer] = self._dial(peer, deadline)
            q: queue.Queue = queue.Queue(maxsize=max(1, depth))
            self._outbox[peer] = q
            self._m_outbox_depth.labels(str(peer)).set_function(q.qsize)
            th = threading.Thread(
                target=self._sender_loop,
                args=(peer,),
                daemon=True,
                name=f"pw-dcn-send-{pid}to{peer}",
            )
            self._senders[peer] = th
            th.start()
        # the liveness clock starts once the full mesh is dialed — a
        # peer that was reachable at startup but never speaks again is
        # exactly what the monitor exists to catch
        now = time.monotonic()
        for peer in range(n):
            if peer != pid:
                self._last_heard[peer] = now
        # the heartbeat SENDER always runs (peers with monitoring on
        # must keep hearing us even when our own timeout is 0 =
        # monitoring disabled); only the timeout CHECK is conditional
        threading.Thread(
            target=self._heartbeat_loop,
            daemon=True,
            name=f"pw-dcn-heartbeat-{pid}",
        ).start()

    # --- wiring -----------------------------------------------------------

    def _dial(self, peer: int, deadline: float) -> socket.socket:
        """Dial one peer until the MONOTONIC deadline (wall-clock jumps
        must neither expire nor extend connection budgets) with jittered
        exponential backoff between attempts — a whole group restarting
        at once must not hammer a still-booting peer in lockstep."""
        import random as _random

        last_err: Exception | None = None
        attempt = 0
        while time.monotonic() < deadline:
            skew = self._version_skew.get(peer)
            if skew is not None:
                raise HostMeshError(
                    f"process {self.pid}: protocol version mismatch — "
                    f"peer {peer} speaks "
                    f"{skew.decode('ascii', 'replace')}, this process "
                    f"speaks {_HELLO_MAGIC.decode('ascii')} (detected "
                    "from the peer's authenticated hello); run every "
                    "process of the job from the same build"
                )
            s: socket.socket | None = None
            try:
                s = socket.create_connection(
                    (self.host, self.base_port + peer), timeout=5.0
                )
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(10.0)
                # challenge-response: answer the acceptor's random nonce so
                # a captured hello cannot be replayed. The hello names BOTH
                # endpoints — the acceptor checks dst == its own pid, so a
                # rogue listener cannot relay our answer to a third peer
                # (HMAC-oracle connection forwarding).
                nonce = self._read_exact(s, _NONCE_LEN)
                if nonce is None:
                    raise OSError("peer closed during handshake")
                hello = _HELLO_MAGIC + struct.pack("<ii", self.pid, peer)
                s.sendall(
                    hello + hmac.new(self._key, hello + nonce, "sha256").digest()
                )
                # wait for the acceptor's authenticated OK (MAC over its
                # own nonce + our hello): a PATHWAY_DCN_SECRET mismatch
                # fails HERE with a clear auth error instead of surfacing
                # later as a confusing EPIPE on the first large send
                ok = self._read_exact(s, _MAC_LEN)
                if ok is None:
                    # clean close mid-handshake (peer tearing down, or an
                    # older-protocol acceptor dropping the unknown magic):
                    # a retryable startup race, NOT an auth verdict
                    raise OSError("peer closed during handshake")
                if ok == _REJECT:
                    s.close()
                    raise HostMeshError(
                        f"process {self.pid}: peer {peer} rejected the "
                        "handshake — authentication failed (is "
                        "PATHWAY_DCN_SECRET identical on every process?)"
                    )
                if ok[: len(_VREJECT_TAG)] == _VREJECT_TAG:
                    peer_magic = (
                        ok[len(_VREJECT_TAG) : len(_VREJECT_TAG) + 5]
                        .rstrip(b"\x00")
                        .decode("ascii", "replace")
                    )
                    s.close()
                    raise HostMeshError(
                        f"process {self.pid}: protocol version mismatch "
                        f"— peer {peer} speaks {peer_magic}, this process "
                        f"speaks {_HELLO_MAGIC.decode('ascii')}; run every "
                        "process of the job from the same build"
                    )
                expected = hmac.new(
                    self._key, _OK_TAG + nonce + hello, "sha256"
                ).digest()
                if not hmac.compare_digest(ok, expected):
                    # a garbled (not explicitly rejected) response: treat
                    # like a transport fault and retry within the deadline
                    raise OSError("unexpected handshake response")
                s.settimeout(None)
                return s
            except OSError as e:
                last_err = e
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
                attempt += 1
                backoff = min(2.0, 0.05 * (2**min(attempt, 6)))
                delay = backoff * (0.5 + _random.random())
                delay = min(delay, max(0.0, deadline - time.monotonic()))
                if delay > 0:
                    time.sleep(delay)
        raise HostMeshError(
            f"process {self.pid}: could not reach peer {peer} at "
            f"{self.host}:{self.base_port + peer} ({last_err})"
        )

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._reader, args=(conn,), daemon=True
            ).start()

    def _read_exact(self, conn: socket.socket, count: int) -> bytes | None:
        buf = b""
        while len(buf) < count:
            chunk = conn.recv(count - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _reader(self, conn: socket.socket) -> None:
        src = -1
        dec_codec = self._m_decode_seconds.labels("codec")
        dec_pickle = self._m_decode_seconds.labels("pickle")
        try:
            nonce = os.urandom(_NONCE_LEN)
            conn.settimeout(30.0)  # handshake must complete promptly
            conn.sendall(nonce)
            hello = self._read_exact(conn, len(_HELLO_MAGIC) + 8 + _MAC_LEN)
            if hello is None:
                conn.close()
                return
            magic = hello[: len(_HELLO_MAGIC)]
            if magic != _HELLO_MAGIC:
                if magic[: len(_VREJECT_TAG)] == _HELLO_MAGIC[
                    : len(_VREJECT_TAG)
                ]:
                    # a PWHX peer speaking another protocol version:
                    # tell it explicitly so a PWVN-aware build fails
                    # fast with a version diagnosis instead of retrying
                    # until its deadline
                    try:
                        conn.sendall(_version_reject())
                    except OSError:
                        pass
                    # a genuinely OLD build cannot parse PWVN — but if
                    # its hello authenticates under the job secret (the
                    # MAC scheme predates the version split), that
                    # PROVES a same-job peer on another version: record
                    # the skew so our own dial loop for that peer
                    # aborts with the clear diagnosis. Unauthenticated
                    # probers must not be able to plant skew (that
                    # would let any off-path connect kill the job).
                    claimed, mac = hello[:-_MAC_LEN], hello[-_MAC_LEN:]
                    if hmac.compare_digest(
                        mac,
                        hmac.new(
                            self._key, claimed + nonce, "sha256"
                        ).digest(),
                    ):
                        skew_src, skew_dst = struct.unpack(
                            "<ii", claimed[len(_HELLO_MAGIC) :]
                        )
                        if skew_dst == self.pid and 0 <= skew_src < self.n:
                            self._version_skew[skew_src] = magic
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
            hello_src, dst = struct.unpack(
                "<ii", hello[len(_HELLO_MAGIC) : -_MAC_LEN]
            )
            if dst != self.pid:
                # answer relayed from a different handshake; close WITHOUT
                # assigning src — the genuine peer must not be framed dead
                conn.close()
                return
            # authenticated OK: proves to the dialer that WE hold the job
            # key too (mutual auth) and that its hello was accepted
            conn.sendall(
                hmac.new(
                    self._key, _OK_TAG + nonce + claimed, "sha256"
                ).digest()
            )
            src = hello_src
            conn.settimeout(None)
            recv_seq = 0
            while True:
                head = self._read_exact(conn, 4 + _MAC_LEN)
                if head is None:
                    break
                (length,) = struct.unpack("<I", head[:4])
                body = self._read_exact(conn, length)
                if body is None:
                    break
                if not hmac.compare_digest(
                    head[4:], _frame_mac(self._key, src, self.pid, recv_seq, body)
                ):
                    break  # forged/reflected/replayed frame: drop the link
                recv_seq += 1
                self._last_heard[src] = time.monotonic()
                self._m_recv_bytes.labels(str(src)).inc(len(head) + len(body))
                self._m_recv_msgs.labels(str(src)).inc()
                pool = self._decode_pool
                if pool is not None:
                    # overlap: the reader goes straight back to recv
                    # while a pool worker decodes + delivers.  Unordered
                    # delivery is safe — every slot is keyed
                    # (channel, tick, src) and written once — and the
                    # MAC sequence was already verified in order above.
                    # The slot acquire bounds the pending backlog
                    # (released by the worker).
                    self._decode_slots.acquire()
                    pool.submit(
                        self._decode_deliver,
                        conn,
                        body,
                        dec_codec,
                        dec_pickle,
                    )
                else:
                    self._decode_deliver(conn, body, dec_codec, dec_pickle)
        except Exception:
            # transport faults AND decode failures (wire.WireError, a
            # struct/pickle error from a codec bug or a version skew
            # the handshake missed) take the same clean fail-stop path:
            # drop the link, mark the peer dead below — never kill the
            # reader thread with an unhandled-exception traceback
            pass
        finally:
            conn.close()
            if src >= 0:
                self._mark_dead(
                    src, "connection closed (peer EOF or corrupt frame)"
                )

    def _decode_deliver(
        self, conn: socket.socket, body: bytes, dec_codec, dec_pickle
    ) -> None:
        """Decode one MAC-verified frame body and deliver it under the
        condition variable.  Runs inline (reader thread) or on the
        decode pool; a decode failure on the pool path closes the link
        so the reader fail-stops exactly like an inline failure."""
        try:
            t0 = time.perf_counter()
            frame = wire.decode_frame(body)
            (
                dec_codec
                if body[:1] == wire.FRAME_CODEC
                else dec_pickle
            ).observe(time.perf_counter() - t0)
            kind = frame[0]
            if kind == "hb":
                return  # liveness already refreshed by the reader
            with self._cv:
                if kind == "data":
                    _k, fsrc, channel, tick, payload, tp = frame
                    self._data.setdefault((channel, tick), {})[
                        fsrc
                    ] = payload
                    if tp is not None:
                        self._data_tps.setdefault(
                            (channel, tick), {}
                        )[fsrc] = tp
                elif kind == "bar":
                    _k, fsrc, rnd, value, tp = frame
                    self._bars.setdefault(rnd, {})[fsrc] = value
                    if tp is not None:
                        self._bar_tps.setdefault(rnd, {})[fsrc] = tp
                self._cv.notify_all()
        except Exception:
            if self._decode_pool is None:
                raise  # inline path: the reader's fail-stop handler
            # pool path: tear the link so the reader fail-stops.
            # shutdown() BEFORE close(): the reader is blocked in
            # recv() on this socket, and a bare close() neither wakes
            # it (the in-flight syscall pins the description) nor is
            # safe against the freed fd being reused by a new accept
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        finally:
            if self._decode_pool is not None:
                self._decode_slots.release()

    # --- liveness (Phoenix Mesh) ------------------------------------------

    def add_failure_listener(self, fn) -> None:
        """Register ``fn(peer: int, reason: str)``, fired once per peer
        the moment it is declared dead (EOF, send failure, or liveness
        timeout). Fired from mesh internal threads — listeners must be
        quick and must not call back into the mesh."""
        with self._cv:
            self._failure_listeners.append(fn)
            already = [
                (p, self._dead_reason.get(p, "unknown")) for p in self._dead
            ]
        # a listener registered after a failure still learns about it
        for peer, reason in already:
            try:
                fn(peer, reason)
            except Exception:
                pass

    def _mark_dead(self, peer: int, reason: str) -> None:
        with self._cv:
            if peer in self._dead:
                return
            self._dead.add(peer)
            self._dead_reason.setdefault(peer, reason)
            # a peer going away while WE are tearing down is the normal
            # end of a clean run, not a failure: keep the dead-set
            # bookkeeping (stray gathers must still error) but skip the
            # alarm and the recovery listeners
            listeners = (
                [] if self._closed else list(self._failure_listeners)
            )
            self._cv.notify_all()
        if self._closed:
            return
        import logging

        logging.getLogger("pathway_tpu_torch").warning(
            "host mesh: process %d declared peer %d dead (%s)",
            self.pid,
            peer,
            reason,
        )
        for fn in listeners:
            try:
                fn(peer, reason)
            except Exception:
                logging.getLogger("pathway_tpu_torch").exception(
                    "host mesh failure listener raised"
                )

    def _heartbeat_loop(self) -> None:
        """Send a heartbeat frame to every live peer each interval and
        declare peers dead when nothing has arrived within the liveness
        timeout. Heartbeats ride the normal outbox (so they share the
        MAC sequence) but never block: a full outbox means data frames
        are flowing, which is liveness enough."""
        while not self._closed:
            time.sleep(self.heartbeat_s)
            if self._closed:
                return
            now = time.monotonic()
            for peer, q in self._outbox.items():
                if peer in self._dead:
                    continue
                try:
                    q.put_nowait(("hb", self.pid))
                except queue.Full:
                    pass
                if self.liveness_timeout_s <= 0:
                    continue  # monitoring disabled; keep sending
                heard = self._last_heard.get(peer)
                if (
                    heard is not None
                    and now - heard > self.liveness_timeout_s
                ):
                    self._mark_dead(
                        peer,
                        f"liveness timeout: no frames for "
                        f"{now - heard:.1f}s "
                        f"(> {self.liveness_timeout_s:.1f}s)",
                    )

    # --- send/recv --------------------------------------------------------

    _STOP = object()  # outbox sentinel: sender thread exits

    def _enqueue_frame(self, dst: int, frame: tuple) -> None:
        """Hand a frame to dst's sender thread. Bounded: a full outbox
        blocks (back-pressure against a slow peer) but keeps polling the
        failure flags so a dead peer cannot wedge the producer."""
        q = self._outbox[dst]
        while True:
            if self._closed:
                raise HostMeshError(
                    f"process {self.pid}: mesh is closed"
                )
            err = self._send_failed.get(dst)
            if err is not None:
                raise HostMeshError(
                    f"process {self.pid}: send to peer {dst} failed "
                    f"({err})"
                )
            try:
                q.put(frame, timeout=0.2)
                return
            except queue.Full:
                continue

    def _sender_loop(self, dst: int) -> None:
        """Drain dst's outbox: encode + MAC + sendall, off the caller's
        thread, so wire work overlaps the next channel's partitioning
        and compute. Owns the connection's MAC sequence counter (frames
        leave in enqueue order, so the receiver's recv_seq matches)."""
        from pathway_tpu_torch.testing import faults

        q = self._outbox[dst]
        sock = self._out[dst]
        seq = 0
        plan = faults.active()
        # bind label children once: the per-frame path pays attribute
        # loads, not registry lock + dict lookups
        enc_codec = self._m_encode_seconds.labels("codec")
        enc_pickle = self._m_encode_seconds.labels("pickle")
        sent_bytes = self._m_sent_bytes.labels(str(dst))
        sent_msgs = self._m_sent_msgs.labels(str(dst))
        while True:
            frame = q.get()
            if frame is self._STOP:
                return
            try:
                repeats = 1
                if plan is not None:
                    kind = frame[0]
                    channel = frame[2] if kind == "data" else kind
                    action = plan.on_wire_send(str(channel))
                    if action is not None:
                        if action[0] == "drop":
                            continue
                        if action[0] == "dup":
                            repeats = 2
                        elif action[0] == "delay":
                            time.sleep(action[1])
                t0 = time.perf_counter()
                body, stats = wire.encode_frame(
                    frame, self.wire_format, self.wire_quant
                )
                (enc_codec if stats is not None else enc_pickle).observe(
                    time.perf_counter() - t0
                )
                if stats is not None and stats["raw_bytes"]:
                    self._m_ratio.labels(frame[2]).set(
                        stats["raw_bytes"] / max(len(body) - 1, 1)
                    )
                if frame[0] == "data":
                    # Tick Scope wire tap: per-channel encoded bytes —
                    # the sender thread is off the tick hot loop, so the
                    # tap's small lock is free concurrency-wise
                    wire.tap_frame(str(frame[2]), len(body), stats)
                for _ in range(repeats):
                    mac = _frame_mac(self._key, self.pid, dst, seq, body)
                    seq += 1
                    msg = struct.pack("<I", len(body)) + mac + body
                    sock.sendall(msg)
                    sent_bytes.inc(len(msg))
                    sent_msgs.inc()
            except Exception as e:  # OSError or an encode bug: fail-stop
                self._send_failed[dst] = e
                self._mark_dead(dst, f"send failed: {e}")
                # unblock producers stuck on the (now doomed) outbox
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                return

    def _dead_detail(self, pids) -> str:
        notes = []
        for p in sorted(pids):
            if p in self._send_failed:
                notes.append(f"peer {p} send failed: {self._send_failed[p]}")
            elif p in self._dead_reason:
                notes.append(f"peer {p}: {self._dead_reason[p]}")
        return (" [" + "; ".join(notes) + "]") if notes else ""

    @staticmethod
    def _default_timeout(timeout: float | None) -> float:
        """gather/barrier wait budget: explicit argument, else
        PATHWAY_DCN_TIMEOUT seconds (default 300). Chaos tests shrink it
        so a dropped frame surfaces in seconds, not minutes."""
        if timeout is not None:
            return timeout
        return float(os.environ.get("PATHWAY_DCN_TIMEOUT", "300") or 300)

    def send(self, dst: int, channel: str, tick: int, payload: Any) -> None:
        # disabled tracing must not cost a contextvar read + pending-lock
        # acquisition per frame on the mesh hot path
        tp = propagation_traceparent() if get_tracer().enabled else None
        self._enqueue_frame(
            dst, ("data", self.pid, channel, tick, payload, tp)
        )

    def gather(
        self, channel: str, tick: int, timeout: float | None = None
    ) -> dict[int, Any]:
        """Wait for one payload from every other process on (channel, tick)."""
        want = self.n - 1
        t0 = time.perf_counter()
        deadline = time.monotonic() + self._default_timeout(timeout)
        key = (channel, tick)
        with self._cv:
            while True:
                got = self._data.get(key, {})
                if len(got) >= want:
                    self._m_gather_seconds.observe(
                        time.perf_counter() - t0
                    )
                    tps = self._data_tps.pop(key, None)
                    if tps:
                        self._gathered_tps[key] = tps
                        # bound the stash: a caller that never takes its
                        # entry must not leak memory over a long run
                        while len(self._gathered_tps) > 1024:
                            self._gathered_tps.pop(
                                next(iter(self._gathered_tps))
                            )
                    return self._data.pop(key)
                if self._dead:
                    missing = set(range(self.n)) - {self.pid} - set(got)
                    if missing & self._dead:
                        raise HostMeshError(
                            f"process {self.pid}: peer(s) "
                            f"{sorted(missing & self._dead)} died before "
                            f"delivering {channel}@{tick}"
                            + self._dead_detail(missing & self._dead)
                        )
                left = deadline - time.monotonic()
                if left <= 0:
                    raise HostMeshError(
                        f"process {self.pid}: timeout waiting for "
                        f"{channel}@{tick} (have {sorted(got)})"
                    )
                self._cv.wait(timeout=min(left, 1.0))

    def barrier(
        self, value: Any, timeout: float | None = None
    ) -> dict[int, Any]:
        """Exchange `value` with every process; returns {pid: value} for all
        N processes (including self). Must be called in lockstep — the
        internal round counter is the channel. ``last_barrier_tps`` holds
        every participant's traceparent afterwards (None for processes
        with no active trace).

        Barriers carry the PENDING-request traceparent only, never the
        ambient span: the barrier is the lockstep tick scheduler, and the
        trace the next tick should serve is the oldest in-flight REST
        request. The ambient context on the run-loop thread is the
        whole-run ``pathway.run`` span — adopting it would collapse every
        tick of every process into one giant run-long trace and starve
        request attribution."""
        rnd = self._round
        self._round += 1
        t0 = time.perf_counter()
        own_tp = pending_traceparent() if get_tracer().enabled else None
        for peer in range(self.n):
            if peer != self.pid:
                self._enqueue_frame(
                    peer, ("bar", self.pid, rnd, value, own_tp)
                )
        want = self.n - 1
        deadline = time.monotonic() + self._default_timeout(timeout)
        with self._cv:
            while True:
                got = self._bars.get(rnd, {})
                if len(got) >= want:
                    out = self._bars.pop(rnd)
                    out[self.pid] = value
                    tps = self._bar_tps.pop(rnd, {})
                    tps[self.pid] = own_tp
                    self.last_barrier_tps = tps
                    self._m_barrier_seconds.observe(
                        time.perf_counter() - t0
                    )
                    return out
                if self._dead:
                    missing = set(range(self.n)) - {self.pid} - set(got)
                    if missing & self._dead:
                        raise HostMeshError(
                            f"process {self.pid}: peer(s) "
                            f"{sorted(missing & self._dead)} died at "
                            f"barrier {rnd}"
                            + self._dead_detail(missing & self._dead)
                        )
                left = deadline - time.monotonic()
                if left <= 0:
                    raise HostMeshError(
                        f"process {self.pid}: timeout at barrier {rnd}"
                    )
                self._cv.wait(timeout=min(left, 1.0))

    def take_gather_tps(self, channel: str, tick: int) -> dict[int, str]:
        """Remove and return the remote traceparents that arrived with the
        (channel, tick) payloads of a completed gather. Keyed per gather,
        so concurrent exchanges on different channels stay isolated."""
        with self._cv:
            return self._gathered_tps.pop((channel, tick), {})

    def group_traceparent(self) -> str | None:
        """The group's agreed trace context for the round the last barrier
        scheduled: the lowest-pid non-None traceparent (deterministic —
        every process sees the same set, so every process picks the same
        one and the whole group's tick spans join one trace)."""
        tps = self.last_barrier_tps
        for pid in sorted(tps):
            if tps[pid] is not None:
                return tps[pid]
        return None

    def close(self) -> None:
        self._closed = True
        # FLUSH-then-stop each outbox: the sentinel queues BEHIND any
        # pending frames so the sender delivers them first — a barrier
        # frame still in flight must reach the peer or its next barrier
        # sees a spurious dead-peer EOF. Producers blocked on a full
        # outbox unblock via the closed flag (their next 0.2 s poll
        # raises), freeing a slot; a sender that already fail-stopped
        # has undeliverable frames, so skip the sentinel and just join
        # (the thread is gone). Bounded retries keep close() from
        # wedging on a hung peer; the socket close below aborts any
        # still-blocked sendall.
        for dst, q in self._outbox.items():
            for _ in range(50):
                if self._send_failed.get(dst) is not None:
                    break
                try:
                    q.put(self._STOP, timeout=0.2)
                    break
                except queue.Full:
                    continue
        for th in self._senders.values():
            th.join(timeout=2.0)
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=False)
        try:
            self._listener.close()
        except OSError:
            pass
        for s in self._out.values():
            try:
                s.close()
            except OSError:
                pass


_mesh: HostMesh | None = None
_mesh_lock = threading.Lock()


def dcn_active() -> bool:
    """True when this process is part of a multi-process engine group."""
    n, _pid, _port, _host = process_env()
    return n > 1 and os.environ.get("PATHWAY_DCN", "1") != "0"


def _flush_mesh_at_exit() -> None:
    """atexit hook: flush-close the mesh singleton before the
    interpreter kills its daemon sender threads.

    Nothing else ever closes the singleton, and the PR-6 overlapped
    sender means a rank can COMPLETE its last barrier/gather (it only
    needs the peers' frames) while its own final frame still sits in an
    outbox queue — process exit then kills the sender mid-queue, the
    frame is never delivered, and the slower peer blocks until the
    socket EOF declares this rank dead (the load-flaky
    test_two_process_wordcount_wire_formats failure: under contention
    the sender thread loses the race with interpreter teardown).
    ``close()`` queues the stop sentinel BEHIND pending frames and
    joins the senders, so every frame a completed tick produced is on
    the wire before the sockets go down.  Injected deaths (os._exit /
    SIGKILL) bypass atexit, so Fault Forge kills stay abrupt."""
    with _mesh_lock:
        m = _mesh
    if m is not None and not m._closed:
        try:
            m.close()
        except Exception:
            pass  # exit path: never mask the process's real outcome


def get_host_mesh() -> HostMesh:
    """Process-wide mesh singleton (daemon threads live for the process)."""
    global _mesh
    with _mesh_lock:
        if _mesh is None:
            n, pid, port, host = process_env()
            if n <= 1:
                raise HostMeshError("PATHWAY_PROCESSES must be > 1")
            _mesh = HostMesh(n, pid, port, host)
            import atexit

            atexit.register(_flush_mesh_at_exit)
        return _mesh
