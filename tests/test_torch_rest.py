"""The port's REST connector (``pathway_tpu_torch/io/http``, served on the
standard library's asyncio) against the JAX package's (served on aiohttp):
each package runs its own graph and server, both get the same raw requests
through ``http.client``, and the replies must agree in status, parsed body
and the named headers (``Date`` and ``Server`` differ by design).

Covered: the raw format and a custom schema, GET parameters merged with the
JSON body, a missing field (400), an unknown path (404), a wrong method
(405 with ``Allow``), ``/_schema``, ``traceparent`` in and out, a chunked
body, keep-alive, a small ``VectorStoreServer`` (``/v1/retrieve``,
``/v1/statistics``, ``/v1/inputs``; texts, metadata and order exact, ``dist``
within 1e-5 absolute: both encoders in float32, summing in another order),
``QARestServer`` over ``EchoChat``, and ``pw.io.http.read``/``write``
against a local server. The port side runs with ``device="cpu"``; the JAX
side runs its interpreter (``PATHWAY_COMPILED_TICK=0``)."""

import contextlib
import http.client
import http.server
import importlib
import json
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu_torch.internals import parse_graph as port_parse_graph

PKGS = ["pathway_tpu", "pathway_tpu_torch"]
DIST_ATOL = 1e-5
DIM, DEPTH, HEADS, MAXLEN = 32, 2, 2, 64
# what must agree besides status and body
NAMED_HEADERS = ("content-type", "allow", "retry-after", "x-pathway-stale")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _raw(port, method, target, body=None, headers=None, chunks=None, timeout=30.0):
    """One request; ``chunks`` sends the body with chunked encoding.
    Returns (status, lower-cased headers, parsed body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if chunks is None:
            conn.request(method, target, body=body, headers=headers or {})
        else:
            conn.putrequest(method, target)
            for k, v in (headers or {}).items():
                conn.putheader(k, v)
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            for c in chunks:
                conn.send(b"%x\r\n%s\r\n" % (len(c), c))
            conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        raw = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        if hdrs.get("content-type", "").startswith("application/json"):
            return resp.status, hdrs, json.loads(raw)
        return resp.status, hdrs, raw.decode()
    finally:
        conn.close()


def _wait_up(port, route="/_schema", timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            _raw(port, "GET", route, timeout=5)
            return
        except OSError:
            time.sleep(0.05)
    raise RuntimeError(f"server on {port} did not come up")


@contextlib.contextmanager
def _serving(build):
    """``build(pkg, pw, port)`` declares each package's graph; both run
    in threads. Yields {pkg: port}."""
    ports, threads = {}, {}
    try:
        for pkg in PKGS:
            pw = importlib.import_module(pkg)
            port = _free_port()
            t = build(pkg, pw, port)
            if t is None:
                t = threading.Thread(target=pw.run, daemon=True)
                t.start()
            ports[pkg], threads[pkg] = port, t
        for port in ports.values():
            _wait_up(port)
        yield ports
    finally:
        for pkg, t in threads.items():
            rt = importlib.import_module(f"{pkg}.internals.parse_graph").G.runtime
            if rt is not None:
                rt.stop()
            t.join(timeout=15)
            assert not t.is_alive()


def _both(ports, method, target, body=None, headers=None, chunks=None):
    ref = _raw(ports["pathway_tpu"], method, target, body, headers, chunks)
    got = _raw(ports["pathway_tpu_torch"], method, target, body, headers, chunks)
    return ref, got


def _assert_same(ref, got):
    assert got[0] == ref[0]
    assert got[2] == ref[2]
    for name in NAMED_HEADERS:
        assert got[1].get(name) == ref[1].get(name), name


def _echo_graph(routes):
    """Routes of an upper-casing echo: (route, schema or None, methods)."""

    def build(pkg, pw, port):
        http = importlib.import_module(f"{pkg}.io.http")
        ws = http.PathwayWebserver(host="127.0.0.1", port=port)
        for route, fields, methods in routes:
            schema = None if fields is None else pw.schema_from_types(**fields)
            q, writer = http.rest_connector(webserver=ws, route=route, schema=schema, methods=methods)
            if fields is None:
                result = pw.apply(lambda t: t.upper(), q.query)
            else:
                result = pw.apply(lambda t, n: f"{t.upper()}x{n}", q.text, q.n)
            writer(q.select(query_id=q.id, result=result))

    return build


ECHO = _echo_graph([
    ("/raw", None, ("POST",)),
    ("/typed", {"text": str, "n": int}, ("GET", "POST")),
])


def test_raw_and_custom_schema_round_trip():
    with _serving(ECHO) as ports:
        ref, got = _both(ports, "POST", "/raw", body=b"hello raw")
        _assert_same(ref, got)
        assert got[0] == 200 and got[2] == "HELLO RAW"
        ref, got = _both(ports, "POST", "/typed", body=json.dumps({"text": "ab", "n": 3}),
                         headers={"Content-Type": "application/json"})
        _assert_same(ref, got)
        assert got[2] == "ABx3"


def test_get_parameters_merge_with_body():
    with _serving(ECHO) as ports:
        ref, got = _both(ports, "GET", "/typed?text=qq&n=2")
        _assert_same(ref, got)
        assert got[2] == "QQx2"
        # the JSON body wins over a query parameter of the same name
        ref, got = _both(ports, "POST", "/typed?text=qq&n=2", body=json.dumps({"text": "body"}))
        _assert_same(ref, got)
        assert got[2] == "BODYx2"


@pytest.mark.parametrize(
    "method,target,body,status",
    [
        ("POST", "/typed", json.dumps({"text": "only"}), 400),
        ("POST", "/typed", b"not json", 400),
        ("POST", "/nowhere", b"{}", 404),
        ("PUT", "/typed", b"{}", 405),
        ("GET", "/raw", None, 405),
    ],
    ids=["missing-field", "bad-json", "unknown-path", "wrong-method", "get-on-post-route"],
)
def test_error_replies(method, target, body, status):
    with _serving(ECHO) as ports:
        ref, got = _both(ports, method, target, body=body)
        _assert_same(ref, got)
        assert got[0] == status


def test_schema_endpoint():
    with _serving(ECHO) as ports:
        ref, got = _both(ports, "GET", "/_schema")
        _assert_same(ref, got)
        assert set(got[2]["paths"]) == {"/raw", "/typed"}
        assert set(got[2]["paths"]["/typed"]) == {"get", "post"}


def test_traceparent_in_and_out():
    parent = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    with _serving(ECHO) as ports:
        ref, got = _both(ports, "POST", "/raw", body=b"t", headers={"traceparent": parent})
        _assert_same(ref, got)
        for reply in (ref, got):
            version, trace_id, span_id, flags = reply[1]["traceparent"].split("-")
            assert (version, trace_id, flags) == ("00", parent.split("-")[1], "01")
            assert span_id != parent.split("-")[2]  # the server's own span
        ref, got = _both(ports, "POST", "/raw", body=b"t")
        assert len(got[1]["traceparent"].split("-")[1]) == 32


def test_chunked_body_and_keep_alive():
    with _serving(ECHO) as ports:
        ref, got = _both(ports, "POST", "/typed", chunks=[b'{"text": "ch', b'unked", "n": 7}'])
        _assert_same(ref, got)
        assert got[2] == "CHUNKEDx7"
        # three requests on one connection
        conn = http.client.HTTPConnection("127.0.0.1", ports["pathway_tpu_torch"], timeout=30)
        try:
            for i in range(3):
                conn.request("POST", "/raw", body=f"k{i}".encode())
                resp = conn.getresponse()
                assert resp.status == 200 and json.loads(resp.read()) == f"K{i}"
        finally:
            conn.close()


# --- the RAG layer's servers ------------------------------------------------


@pytest.fixture(scope="module")
def embedders():
    from pathway_tpu.xpacks.llm._encoder import TransformerEncoder as JaxEncoder
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JaxEmbedder
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TorchEmbedder

    kw = dict(dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, batch_size=64)
    jemb = JaxEmbedder(**kw)
    jemb.runtime.model = JaxEncoder(
        vocab_size=30522, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, dtype=jnp.float32
    )
    temb = TorchEmbedder(device="cpu", **kw)
    temb.runtime.model.dtype = torch.float32
    return {"pathway_tpu": jemb, "pathway_tpu_torch": temb}


WORDS = [f"w{i}" for i in range(300)]


def _docs(n=48, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        text = " ".join(" ".join(rng.choice(WORDS, size=int(rng.integers(6, 14)))) + "."
                        for _ in range(int(rng.integers(2, 4))))
        out.append((i, text.encode(), {"path": f"dir{i % 3}/doc{i}.txt", "topic": ["a", "b"][i % 2]}))
    return out


def _store(pkg, pw, emb, docs):
    vs = importlib.import_module(f"{pkg}.xpacks.llm.vector_store")
    parsers = importlib.import_module(f"{pkg}.xpacks.llm.parsers")
    splitters = importlib.import_module(f"{pkg}.xpacks.llm.splitters")

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: bytes
        _metadata: pw.Json

    table = pw.debug.table_from_rows(DocSchema, docs)
    return vs.VectorStoreServer(
        table, embedder=emb, parser=parsers.Utf8Parser(),
        splitter=splitters.TokenCountSplitter(min_tokens=10, max_tokens=30),
        **({"device": "cpu"} if pkg == "pathway_tpu_torch" else {}),
    )


def _assert_replies_close(ref, got):
    assert got[0] == ref[0] == 200
    assert [(d["text"], d["metadata"]) for d in got[2]] == [(d["text"], d["metadata"]) for d in ref[2]]
    np.testing.assert_allclose([d["dist"] for d in got[2]], [d["dist"] for d in ref[2]],
                               atol=DIST_ATOL, rtol=0)


def test_vector_store_server_routes(embedders):
    docs = _docs()

    def build(pkg, pw, port):
        store = _store(pkg, pw, embedders[pkg], docs)
        return store.run_server("127.0.0.1", port, threaded=True)

    query = " ".join(docs[5][1].decode().split()[:12])
    with _serving(build) as ports:
        for body in (
            {"query": query, "k": 4},
            {"query": "w1 w2 w3", "k": 3, "metadata_filter": "topic == 'b'"},
            {"query": query, "k": 2, "filepath_globpattern": "dir2/*"},
        ):
            ref, got = _both(ports, "POST", "/v1/retrieve", body=json.dumps(body))
            _assert_replies_close(ref, got)
            assert len(got[2]) == body["k"]
        assert got[2][0]["metadata"]["path"] == "dir2/doc5.txt"
        ref, got = _both(ports, "GET", "/v1/retrieve?query=w7+w8&k=3")
        _assert_replies_close(ref, got)
        ref, got = _both(ports, "POST", "/v1/statistics", body=b"{}")
        _assert_same(ref, got)
        assert got[2]["file_count"] > 0
        ref, got = _both(ports, "POST", "/v1/inputs", body=json.dumps({"metadata_filter": "topic == 'a'"}))
        _assert_same(ref, got)
        assert {m["path"] for m in got[2]} == {d[2]["path"] for d in docs if d[2]["topic"] == "a"}


def test_qa_rest_server_over_echo_chat(embedders):
    docs = _docs(24, seed=1)
    prompt = " ".join(docs[3][1].decode().split()[:10])

    def build(pkg, pw, port):
        qa = importlib.import_module(f"{pkg}.xpacks.llm.question_answering")
        llms = importlib.import_module(f"{pkg}.xpacks.llm.llms")
        servers = importlib.import_module(f"{pkg}.xpacks.llm.servers")
        rag = qa.BaseRAGQuestionAnswerer(llms.EchoChat(), _store(pkg, pw, embedders[pkg], docs),
                                         search_topk=3)
        server = servers.QARestServer("127.0.0.1", port, rag)
        return server.run(threaded=True)

    with _serving(build) as ports:
        for route in ("/v1/pw_ai_answer", "/v2/answer"):
            ref, got = _both(ports, "POST", route, body=json.dumps({"prompt": prompt}))
            _assert_same(ref, got)
            assert got[0] == 200 and prompt in got[2]["response"]
        ref, got = _both(ports, "POST", "/v1/retrieve", body=json.dumps({"query": prompt, "k": 2}))
        _assert_replies_close(ref, got)
        ref, got = _both(ports, "POST", "/v1/pw_list_documents", body=b"{}")
        _assert_same(ref, got)
        assert len(got[2]) == len(docs)


# --- pw.io.http.read / write ------------------------------------------------


class _Peer(http.server.BaseHTTPRequestHandler):
    rows = [{"name": "a", "value": 1}, {"name": "b", "value": 2}, {"name": "c", "value": 3}]
    posted: list = []

    def do_GET(self):
        body = json.dumps(self.rows).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.posted.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


def _read_write(pkg, url):
    pw = importlib.import_module(pkg)
    table = pw.io.http.read(url, schema=pw.schema_from_types(name=str, value=int), mode="static")
    doubled = table.select(name=table.name, value=table.value * 2)
    pw.io.http.write(doubled, url + "/sink")
    pw.run()


def test_http_read_and_write_against_a_local_server():
    from pathway_tpu.internals import parse_graph as ref_parse_graph

    peer = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Peer)
    t = threading.Thread(target=peer.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{peer.server_address[1]}"
    try:
        posted = {}
        for pkg in PKGS:
            _Peer.posted = []
            _read_write(pkg, url)
            posted[pkg] = sorted(_Peer.posted, key=lambda r: r["name"])
            ref_parse_graph.G.clear()
            port_parse_graph.G.clear()
        assert posted["pathway_tpu_torch"] == posted["pathway_tpu"]
        assert posted["pathway_tpu_torch"] == [{"name": n, "value": 2 * v} for n, v in (("a", 1), ("b", 2), ("c", 3))]
    finally:
        peer.shutdown()
        peer.server_close()
        t.join(timeout=5)
