"""The port's host mesh (``pathway_tpu_torch/parallel/host_exchange.py``)
held against the JAX package's: the reference's in-process cases of the
mesh (the unauthenticated client dropped before any unpickling, the atexit
flush hook, queued frames delivered on close, the failure listener and
the liveness timeout, the version reject and skew handling, the per-peer
outbox order) run against the port, and a mixed pair — one mesh of each
package — authenticates, agrees on barrier and gather values and moves a
``DiffBatch`` frame the other package decodes into its own batch with the
same keys, diffs and columns. Everything here is sockets and threads on
the CPU."""

from __future__ import annotations

import hmac
import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest

from pathway_tpu.parallel import host_exchange as ref_hx
from pathway_tpu_torch.parallel import host_exchange as hx
from pathway_tpu_torch.testing.chaos import free_dcn_port


def _pair(base, mods=(hx, hx), **kw):
    meshes = [None, None]
    errors: list = []

    def build(pid):
        try:
            meshes[pid] = mods[pid].HostMesh(2, pid, base, connect_timeout=30.0, **kw)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(p,)) for p in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errors:
        raise errors[0]
    assert meshes[0] is not None and meshes[1] is not None
    return meshes


def test_wire_constants_are_the_references():
    """The hello magic, tags and sizes the bytes on the socket carry."""
    for name in ("_HELLO_MAGIC", "_MAC_LEN", "_NONCE_LEN", "_OK_TAG", "_REJECT", "_VREJECT_TAG"):
        assert getattr(hx, name) == getattr(ref_hx, name), name
    assert hx._version_reject() == ref_hx._version_reject()
    key = b"k" * 32
    assert hx._frame_mac(key, 1, 0, 7, b"body") == ref_hx._frame_mac(key, 1, 0, 7, b"body")


def test_process_env_defaults(monkeypatch):
    for k in ("PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID", "PATHWAY_DCN_PORT", "PATHWAY_DCN_HOST"):
        monkeypatch.delenv(k, raising=False)
    assert hx.process_env() == ref_hx.process_env() == (1, 0, 10700, "127.0.0.1")
    assert not hx.dcn_active()
    monkeypatch.setenv("PATHWAY_PROCESSES", "3")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "2")
    monkeypatch.setenv("PATHWAY_DCN_PORT", "12000")
    monkeypatch.setenv("PATHWAY_DCN_HOST", "10.0.0.5")
    assert hx.process_env() == ref_hx.process_env() == (3, 2, 12000, "10.0.0.5")
    assert hx.dcn_active() and ref_hx.dcn_active()
    monkeypatch.setenv("PATHWAY_DCN", "0")
    assert not hx.dcn_active() and not ref_hx.dcn_active()


@pytest.mark.parametrize("order", ["reference_at_0", "port_at_0"])
def test_mixed_pair_authenticates_and_agrees(monkeypatch, order):
    """One mesh of each package in one group: the hello, the OK and every
    frame MAC check out both ways, barriers return the same {pid: value}
    on both sides, and gathers deliver what the other side sent."""
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "mixed-pair")
    mods = (ref_hx, hx) if order == "reference_at_0" else (hx, ref_hx)
    m0, m1 = _pair(free_dcn_port(2), mods)
    try:
        out = [None, None]

        def bar(i, m, v):
            out[i] = m.barrier(v, timeout=30)

        for rnd in range(3):
            ts = [threading.Thread(target=bar, args=(i, m, ("tick", 100 * i + rnd)))
                  for i, m in enumerate((m0, m1))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            want = {0: ("tick", rnd), 1: ("tick", 100 + rnd)}
            assert out[0] == out[1] == want
        m0.send(1, "ch", 5, {"a": [1, 2, 3]})
        m1.send(0, "ch", 5, ("b", 4.5))
        assert m1.gather("ch", 5, timeout=30) == {0: {"a": [1, 2, 3]}}
        assert m0.gather("ch", 5, timeout=30) == {1: ("b", 4.5)}
    finally:
        m0.close()
        m1.close()


def test_mixed_pair_moves_diff_batches_in_the_codec(monkeypatch):
    """A ``DiffBatch`` partition the port sends is a codec frame the JAX
    package decodes into its own batch, and back: keys, diffs and columns
    equal."""
    from pathway_tpu.engine.batch import DiffBatch as RefBatch
    from pathway_tpu_torch.engine.batch import DiffBatch

    monkeypatch.setenv("PATHWAY_DCN_SECRET", "mixed-codec")
    m_ref, m_port = _pair(free_dcn_port(2), (ref_hx, hx))
    rng = np.random.default_rng(0)
    rows = [(int(k), 1 if i % 3 else -1, (int(rng.integers(-9, 9)), f"s{i}", float(rng.normal())))
            for i, k in enumerate(rng.integers(0, 2**63, 50))]
    try:
        m_port.send(0, "gb1", 3, [DiffBatch.from_rows(rows, ["a", "b", "c"])])
        got = m_ref.gather("gb1", 3, timeout=30)[1]
        m_ref.send(1, "gb1", 4, [RefBatch.from_rows(rows, ["a", "b", "c"])])
        back = m_port.gather("gb1", 4, timeout=30)[0]
    finally:
        m_ref.close()
        m_port.close()
    assert isinstance(got[0], RefBatch) and isinstance(back[0], DiffBatch)
    for b in (got[0], back[0]):
        assert b.keys.tolist() == [r[0] for r in rows]
        assert b.diffs.tolist() == [r[1] for r in rows]
        assert [tuple(v) for v in zip(*(b.columns[c].tolist() for c in "abc"))] == [r[2] for r in rows]


def test_mixed_pair_refuses_a_wrong_secret(monkeypatch):
    """A port dialer with another secret is rejected by a JAX-package
    acceptor with the reference's diagnosis."""
    base = free_dcn_port(2)
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "right")
    holder: list = []

    def acceptor():
        try:
            holder.append(ref_hx.HostMesh(2, 1, base, connect_timeout=5.0))
        except Exception as e:  # noqa: BLE001
            holder.append(e)

    th = threading.Thread(target=acceptor, daemon=True)
    th.start()
    time.sleep(0.3)
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "wrong")
    with pytest.raises(hx.HostMeshError, match="authentication failed"):
        hx.HostMesh(2, 0, base, connect_timeout=10.0)
    th.join(20)


def test_host_mesh_rejects_unauthenticated_frames(monkeypatch):
    """A client without the per-job PATHWAY_DCN_SECRET never gets its bytes
    near pickle.loads (pickle over TCP is code execution without
    authentication)."""
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "mesh-auth-test")
    base = free_dcn_port(2)
    m0, m1 = _pair(base)
    try:
        body = pickle.dumps(("data", 1, "evil", 0, "boom"))
        rogue = socket.create_connection(("127.0.0.1", base), timeout=5)
        rogue.settimeout(5)
        nonce = rogue.recv(hx._NONCE_LEN)
        assert len(nonce) == hx._NONCE_LEN
        rogue.sendall(hx._HELLO_MAGIC + struct.pack("<ii", 1, 0) + b"\0" * hx._MAC_LEN)
        rogue.sendall(struct.pack("<I", len(body)) + b"\0" * hx._MAC_LEN + body)
        rogue.close()
        # legitimate traffic still flows
        m0.send(1, "ch", 0, {"ok": True})
        assert m1.gather("ch", 0, timeout=30) == {0: {"ok": True}}
        time.sleep(0.3)
        assert ("evil", 0) not in m1._data and ("evil", 0) not in m0._data
        # a mesh without the secret refuses to construct at all
        monkeypatch.delenv("PATHWAY_DCN_SECRET")
        with pytest.raises(hx.HostMeshError, match="PATHWAY_DCN_SECRET"):
            hx.HostMesh(2, 0, free_dcn_port(2))
    finally:
        m0.close()
        m1.close()


def test_mesh_atexit_flush_hook():
    """The atexit hook flush-closes the mesh singleton exactly once, so a
    rank's last frame is on the wire before the interpreter kills the
    sender threads."""

    class _Stub:
        def __init__(self):
            self._closed = False
            self.closes = 0

        def close(self):
            self.closes += 1
            self._closed = True

    stub = _Stub()
    old = hx._mesh
    try:
        hx._mesh = stub
        hx._flush_mesh_at_exit()
        assert stub.closes == 1
        hx._flush_mesh_at_exit()  # already closed: no double close
        assert stub.closes == 1
        hx._mesh = None
        hx._flush_mesh_at_exit()  # no mesh: no-op
    finally:
        hx._mesh = old


def test_mesh_close_delivers_queued_frames(monkeypatch):
    """Frames already queued on an outbox are on the wire before close()
    returns: the stop sentinel queues behind them."""
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "flush-test")
    m0, m1 = _pair(free_dcn_port(2))
    try:
        for i in range(8):
            m0.send(1, "flushch", i, {"i": i})
        m0.close()
        for i in range(8):
            assert m1.gather("flushch", i, timeout=30) == {0: {"i": i}}
    finally:
        m1.close()


def test_outbox_overlapped_sends_preserve_order(monkeypatch):
    """Many enqueued frames arrive complete and in order through the sender
    threads under back-pressure (the MAC sequence would drop the link
    otherwise)."""
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "wire-outbox")
    monkeypatch.setenv("PATHWAY_DCN_OUTBOX", "4")
    m0, m1 = _pair(free_dcn_port(2))
    try:
        for i in range(64):
            m0.send(1, "ord", i, list(range(i)))
        for i in range(64):
            assert m1.gather("ord", i, timeout=30) == {0: list(range(i))}
    finally:
        m0.close()
        m1.close()


def test_failure_listener_fires_on_peer_eof(monkeypatch):
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "phoenix-eof-test")
    m0, m1 = _pair(free_dcn_port(2))
    failures: list = []
    try:
        m0.add_failure_listener(lambda peer, reason: failures.append((peer, reason)))
        m1.close()  # peer death: EOF on m0's reader
        deadline = time.monotonic() + 10
        while not failures and time.monotonic() < deadline:
            time.sleep(0.05)
        assert failures and failures[0][0] == 1
        # the pending gather names the dead peer and the recorded cause
        with pytest.raises(hx.HostMeshError, match="peer"):
            m0.gather("ch", 0, timeout=5)
        # a listener registered late still hears about it
        late: list = []
        m0.add_failure_listener(lambda p, r: late.append(p))
        assert late == [1]
    finally:
        m0.close()


def test_liveness_timeout_detects_wedged_peer(monkeypatch):
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "phoenix-liveness-test")
    monkeypatch.setenv("PATHWAY_MESH_HEARTBEAT_MS", "100")
    monkeypatch.setenv("PATHWAY_MESH_LIVENESS_TIMEOUT_MS", "700")
    m0, m1 = _pair(free_dcn_port(2))
    failures: list = []
    try:
        m0.add_failure_listener(lambda peer, reason: failures.append((peer, reason)))
        # wedge peer 1 without closing its sockets: only the liveness
        # monitor can catch this
        m1._closed = True
        deadline = time.monotonic() + 10
        while not failures and time.monotonic() < deadline:
            time.sleep(0.05)
        assert failures, "liveness monitor never fired"
        peer, reason = failures[0]
        assert peer == 1 and "liveness timeout" in reason
    finally:
        m1._closed = False
        m0.close()
        m1.close()


def test_dialer_fails_fast_on_version_reject(monkeypatch):
    """A PWHX peer speaking another version answers the hello with the
    explicit version reject: the dialer raises at once, not at its connect
    deadline."""
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "wire-vtest")
    base = free_dcn_port(2)
    lst = socket.socket()
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lst.bind(("127.0.0.1", base + 1))
    lst.listen(1)

    def fake_acceptor():
        conn, _ = lst.accept()
        conn.sendall(b"\x01" * hx._NONCE_LEN)
        hello = b""
        while len(hello) < len(hx._HELLO_MAGIC) + 8 + hx._MAC_LEN:
            chunk = conn.recv(64)
            if not chunk:
                break
            hello += chunk
        reject = hx._VREJECT_TAG + b"PWHX5"
        conn.sendall(reject + b"\x00" * (hx._MAC_LEN - len(reject)))
        time.sleep(0.5)
        conn.close()

    threading.Thread(target=fake_acceptor, daemon=True).start()
    t0 = time.monotonic()
    try:
        with pytest.raises(hx.HostMeshError, match="version mismatch"):
            hx.HostMesh(2, 0, base, connect_timeout=30.0)
    finally:
        lst.close()
    assert time.monotonic() - t0 < 10.0


def test_acceptor_detects_old_dialer_and_aborts_own_dial(monkeypatch):
    """An authenticated hello with an older magic gets the version reject
    naming this version, and the skew aborts this mesh's own dial."""
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "wire-vtest2")
    base = free_dcn_port(2)
    err_holder: list = []

    def build():
        try:
            hx.HostMesh(2, 0, base, connect_timeout=30.0)
        except Exception as e:  # noqa: BLE001
            err_holder.append(e)

    th = threading.Thread(target=build, daemon=True)
    th.start()
    time.sleep(0.3)
    t0 = time.monotonic()
    dialer = socket.create_connection(("127.0.0.1", base), timeout=5)
    dialer.settimeout(5)
    nonce = b""
    while len(nonce) < hx._NONCE_LEN:
        nonce += dialer.recv(hx._NONCE_LEN - len(nonce))
    hello = b"PWHX5" + struct.pack("<ii", 1, 0)
    dialer.sendall(hello + hmac.new(hx._job_key(), hello + nonce, "sha256").digest())
    resp = b""
    while len(resp) < hx._MAC_LEN:
        chunk = dialer.recv(hx._MAC_LEN - len(resp))
        if not chunk:
            break
        resp += chunk
    dialer.close()
    assert resp[: len(hx._VREJECT_TAG)] == hx._VREJECT_TAG and hx._HELLO_MAGIC in resp
    th.join(20)
    assert err_holder and isinstance(err_holder[0], hx.HostMeshError)
    assert "version mismatch" in str(err_holder[0])
    assert time.monotonic() - t0 < 15.0


def test_unauthenticated_old_hello_cannot_plant_version_skew(monkeypatch):
    """A prober without the secret sending an old hello cannot abort the
    mesh's construction: it gets the version reject and nothing else."""
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "wire-vtest3")
    base = free_dcn_port(2)
    holder: list = []

    def build():
        try:
            holder.append(hx.HostMesh(2, 0, base, connect_timeout=6.0))
        except Exception as e:  # noqa: BLE001
            holder.append(e)

    th = threading.Thread(target=build, daemon=True)
    th.start()
    time.sleep(0.3)
    rogue = socket.create_connection(("127.0.0.1", base), timeout=5)
    rogue.settimeout(5)
    nonce = b""
    while len(nonce) < hx._NONCE_LEN:
        nonce += rogue.recv(hx._NONCE_LEN - len(nonce))
    rogue.sendall(b"PWHX5" + struct.pack("<ii", 1, 0) + b"\x00" * hx._MAC_LEN)
    rogue.close()
    th.join(20)
    assert holder and isinstance(holder[0], hx.HostMeshError)
    assert "version mismatch" not in str(holder[0])


def test_get_host_mesh_needs_a_group(monkeypatch):
    monkeypatch.setenv("PATHWAY_PROCESSES", "1")
    monkeypatch.setattr(hx, "_mesh", None)
    with pytest.raises(hx.HostMeshError, match="PATHWAY_PROCESSES must be > 1"):
        hx.get_host_mesh()
