"""The broker, database and cloud connectors of the port against the JAX
package's, over in-process fakes of their clients (the reference's
``tests/test_connector_fakes.py`` as parity tests, plus redpanda and
postgres). Each fake (``confluent_kafka``, ``nats``, ``pymongo``,
``google.cloud.bigquery``, ``psycopg2``'s ``connect``, a pubsub publisher)
goes into ``sys.modules`` with ``monkeypatch.setitem``, as the
reference's tests do; the HTTP sinks (elasticsearch, logstash) post with
``requests`` to a local stdlib HTTP server; slack's fixed
``https://slack.com`` endpoint gets a fake ``requests.Session``, so nothing
leaves the machine. The same scenario runs through ``pathway_tpu``
(``PATHWAY_COMPILED_TICK=0``) and ``pathway_tpu_torch``: the update
streams equal in keys, diffs and rows, every sink writes the same
messages, documents, statements or rows, and the source offsets a resumed
consumer seeks to are the same."""

from __future__ import annotations

import json
import sys
import threading
import time
import types

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from test_torch_connectors import _Capture
from torch_parity import norm

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _in_schema(pw):
    class InSchema(pw.Schema):
        name: str
        n: int

    return InSchema


def _run_streaming_until(pw, res_table, n_rows, timeout_s=10.0):
    """The (key, is_addition, row) events of a streaming run, stopped once
    ``n_rows`` arrived."""
    seen = []

    def on_change(key, row, time, is_addition):
        seen.append((int(key), is_addition, tuple(sorted((k, norm(v)) for k, v in row.items()))))

    pw.io.subscribe(res_table, on_change)

    def stopper():
        deadline = time.time() + timeout_s
        while time.time() < deadline and len(seen) < n_rows:
            time.sleep(0.02)
        pw.internals.parse_graph.G.runtime.stop()

    threading.Thread(target=stopper, daemon=True).start()
    pw.run(monitoring_level=pw.MonitoringLevel.NONE)
    return sorted(seen)


def _each(build):
    """``build(name, pw)`` under each package on a fresh graph."""
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        out[name] = build(name, pw)
    return out["port"], out["jax"]


# --------------------------------------------------------------------------
# Kafka and redpanda


def _fake_confluent_kafka(broker: dict):
    mod = types.ModuleType("confluent_kafka")

    class _Msg:
        def __init__(self, topic, partition, offset, value):
            self._topic, self._partition = topic, partition
            self._offset, self._value = offset, value

        def value(self):
            return self._value

        def error(self):
            return None

        def partition(self):
            return self._partition

        def offset(self):
            return self._offset

    class TopicPartition:
        def __init__(self, topic, partition=0, offset=-1):
            self.topic, self.partition, self.offset = topic, partition, offset

    class Consumer:
        def __init__(self, settings):
            self.settings = settings
            self._topic = None
            self._pos = 0

        def subscribe(self, topics, on_assign=None):
            self._topic = topics[0]
            if on_assign is not None:
                on_assign(self, [TopicPartition(self._topic, 0)])

        def assign(self, partitions):
            # the seek offsets, as rdkafka's assign after on_assign honours them
            for p in partitions:
                if p.offset >= 0:
                    self._pos = p.offset

        def poll(self, timeout):
            msgs = broker.get(self._topic, [])
            if self._pos < len(msgs):
                m = _Msg(self._topic, 0, self._pos, msgs[self._pos])
                self._pos += 1
                return m
            time.sleep(min(timeout, 0.01))
            return None

        def close(self):
            pass

    class Producer:
        def __init__(self, settings):
            self.settings = settings

        def produce(self, topic, key=None, value=None):
            broker.setdefault(topic, []).append((key, value))

        def flush(self):
            pass

    mod.Consumer, mod.Producer, mod.TopicPartition = Consumer, Producer, TopicPartition
    return mod


KAFKA_JSON = [json.dumps({"name": "a", "n": 1}).encode(), json.dumps({"name": "b", "n": 2}).encode(),
              json.dumps({"name": "a", "n": 3}).encode()]


@pytest.mark.parametrize("connector", ["kafka", "redpanda"])
def test_kafka_read_json_roundtrip(monkeypatch, connector):
    def build(name, pw):
        monkeypatch.setitem(sys.modules, "confluent_kafka", _fake_confluent_kafka({"t1": list(KAFKA_JSON)}))
        t = getattr(pw.io, connector).read({"bootstrap.servers": "fake:9092", "group.id": "g"}, topic="t1",
                                           schema=_in_schema(pw), format="json")
        return _run_streaming_until(pw, t, 3)

    port, ref = _each(build)
    assert port == ref
    assert sorted((dict(r)["name"], dict(r)["n"]) for _k, add, r in port if add) == [("a", 1), ("a", 3), ("b", 2)]


def test_kafka_read_seek_offsets(monkeypatch):
    """The offset state the source keeps makes a resumed consumer skip the
    messages it already took (the reference's KafkaReader seek), and the
    state is the same in both packages."""
    def build(name, pw):
        monkeypatch.setitem(sys.modules, "confluent_kafka", _fake_confluent_kafka({"t2": [b"one", b"two", b"three"]}))
        t = pw.io.kafka.read({}, topic="t2", format="plaintext")
        t._node.source.seek({"offsets": {0: 2}})
        seen = _run_streaming_until(pw, t, 1)
        return seen, t._node.source.offset_state()

    port, ref = _each(build)
    assert port == ref
    assert [dict(r)["data"] for _k, add, r in port[0] if add] == ["three"] and port[1] == {"offsets": {0: 3}}


@pytest.mark.parametrize("connector", ["kafka", "redpanda"])
def test_kafka_write(monkeypatch, connector):
    def build(name, pw):
        broker: dict = {}
        monkeypatch.setitem(sys.modules, "confluent_kafka", _fake_confluent_kafka(broker))
        t = pw.debug.table_from_rows(_in_schema(pw), [("x", 1), ("y", 2)])
        getattr(pw.io, connector).write(t, {"bootstrap.servers": "fake"}, topic_name="out")
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        return sorted(broker["out"])

    port, ref = _each(build)
    assert port == ref
    payloads = sorted((json.loads(v)["name"], json.loads(v)["n"], json.loads(v)["diff"]) for _k, v in port)
    assert payloads == [("x", 1, 1), ("y", 2, 1)]


# --------------------------------------------------------------------------
# NATS


def _fake_nats(published: dict, queues: dict):
    mod = types.ModuleType("nats")

    class _Msg:
        def __init__(self, data):
            self.data = data

    class _Sub:
        def __init__(self, topic):
            self._topic = topic
            self._pos = 0

        async def next_msg(self, timeout=None):
            q = queues.get(self._topic, [])
            if self._pos < len(q):
                m = _Msg(q[self._pos])
                self._pos += 1
                return m
            import asyncio

            await asyncio.sleep(min(timeout or 0.01, 0.01))
            raise TimeoutError

    class _NC:
        async def subscribe(self, topic):
            return _Sub(topic)

        async def publish(self, topic, data):
            published.setdefault(topic, []).append(data)

        async def close(self):
            pass

    async def connect(uri):
        return _NC()

    mod.connect = connect
    return mod


def test_nats_read_and_write(monkeypatch):
    def build(name, pw):
        queues = {"in": [json.dumps({"name": "n1", "n": 5}).encode(), json.dumps({"name": "n2", "n": 6}).encode()]}
        published: dict = {}
        monkeypatch.setitem(sys.modules, "nats", _fake_nats(published, queues))
        t = pw.io.nats.read("nats://fake:4222", "in", schema=_in_schema(pw), format="json")
        pw.io.nats.write(t, "nats://fake:4222", "out")
        seen = _run_streaming_until(pw, t, 2)
        out = sorted(tuple(sorted((k, v) for k, v in json.loads(p).items() if k != "time")) for p in published["out"])
        return seen, out

    port, ref = _each(build)
    assert port == ref
    assert sorted(dict(r)["name"] for _k, add, r in port[0] if add) == ["n1", "n2"]
    assert [dict(p)["name"] for p in port[1]] == ["n1", "n2"]


# --------------------------------------------------------------------------
# Elasticsearch and Logstash over a local stdlib HTTP server


def test_elasticsearch_bulk_write():
    def build(name, pw):
        class S2(pw.Schema):
            i: int = pw.column_definition(primary_key=True)
            name: str

        cap = _Capture()
        try:
            rows = [(1, "a", 0, 1), (2, "b", 0, 1), (1, "a", 2, -1)]
            t = pw.debug.table_from_rows(S2, rows, is_stream=True)
            pw.io.elasticsearch.write(t, cap.url, auth=pw.io.elasticsearch.ElasticSearchAuth.apikey("id", "key"),
                                      index_name="idx", max_batch_size=1)
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        finally:
            cap.close()
        return cap.bodies

    port, ref = _each(build)
    assert port == ref
    actions = []
    for path, body, auth in port:
        assert path == "/_bulk" and auth.startswith("ApiKey ")
        lines = [json.loads(x) for x in body.decode().strip().split("\n")]
        actions += ["index" if "index" in x else "delete" for x in lines if "index" in x or "delete" in x]
    assert actions.count("index") == 2 and actions.count("delete") == 1


def test_logstash_write_with_retry():
    def build(name, pw):
        cap = _Capture(reply=b"ok", fail_first=1)
        try:
            t = pw.debug.table_from_rows(_in_schema(pw), [("l1", 1)])
            pw.io.logstash.write(t, cap.url + "/in", n_retries=2)
            pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        finally:
            cap.close()
        return [(path, json.loads(body)) for path, body, _auth in cap.bodies]

    port, ref = _each(build)
    assert port == ref
    assert [(p, d["name"], d["diff"]) for p, d in port] == [("/in", "l1", 1)]  # one failure, then the retry


# --------------------------------------------------------------------------
# MongoDB


def _fake_pymongo(written: list):
    mod = types.ModuleType("pymongo")

    class InsertOne:
        def __init__(self, doc):
            self.doc = doc

    class _Coll:
        def bulk_write(self, ops):
            written.append([op.doc for op in ops])

    class _Db(dict):
        def __getitem__(self, name):
            return _Coll()

    class MongoClient:
        def __init__(self, conn):
            self.conn = conn

        def __getitem__(self, name):
            return _Db()

        def close(self):
            pass

    mod.MongoClient, mod.InsertOne = MongoClient, InsertOne
    return mod


def test_mongodb_write(monkeypatch):
    def build(name, pw):
        written: list = []
        monkeypatch.setitem(sys.modules, "pymongo", _fake_pymongo(written))
        t = pw.debug.table_from_rows(_in_schema(pw), [("m1", 1), ("m2", 2), ("m3", 3)])
        pw.io.mongodb.write(t, "mongodb://fake", "db", "coll", max_batch_size=2)
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        return written

    port, ref = _each(build)
    assert port == ref
    docs = [d for batch in port for d in batch]
    assert sorted(d["name"] for d in docs) == ["m1", "m2", "m3"]
    assert all(d["diff"] == 1 and "key" in d and "time" in d for d in docs)


# --------------------------------------------------------------------------
# Slack: its endpoint is fixed, so a fake session takes the posts


def test_slack_alerts(monkeypatch):
    import requests

    def build(name, pw):
        posts = []

        class _Resp:
            def raise_for_status(self):
                pass

        class _Session:
            def __init__(self):
                self.headers = {}

            def post(self, url, json=None, timeout=None):
                posts.append((url, json, dict(self.headers)))
                return _Resp()

        monkeypatch.setattr(requests, "Session", _Session)

        class A(pw.Schema):
            message: str

        t = pw.debug.table_from_rows(A, [("disk full", 0, 1), ("cpu hot", 0, 1), ("disk full", 2, -1)],
                                     is_stream=True)
        pw.io.slack.send_alerts(t, "C12345", "xoxb-token")
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        return sorted(posts, key=repr)

    port, ref = _each(build)
    assert port == ref
    assert len(port) == 2  # a retraction posts nothing
    assert all(u.endswith("chat.postMessage") and j["channel"] == "C12345"
               and h.get("Authorization") == "Bearer xoxb-token" for u, j, h in port)
    assert sorted(j["text"] for _u, j, _h in port) == ["cpu hot", "disk full"]


# --------------------------------------------------------------------------
# BigQuery / PubSub


def test_bigquery_write(monkeypatch):
    def build(name, pw):
        inserted = []

        class _Client:
            def insert_rows_json(self, target, rows):
                inserted.append((target, rows))
                return []

            def close(self):
                pass

        bq_mod = types.ModuleType("google.cloud.bigquery")
        bq_mod.Client = _Client
        google = types.ModuleType("google")
        cloud = types.ModuleType("google.cloud")
        google.cloud = cloud
        cloud.bigquery = bq_mod
        monkeypatch.setitem(sys.modules, "google", google)
        monkeypatch.setitem(sys.modules, "google.cloud", cloud)
        monkeypatch.setitem(sys.modules, "google.cloud.bigquery", bq_mod)
        t = pw.debug.table_from_rows(_in_schema(pw), [("b1", 1), ("b2", 2)])
        pw.io.bigquery.write(t, "ds", "tbl")
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        return inserted

    port, ref = _each(build)
    assert port == ref
    assert port and port[0][0] == "ds.tbl"
    assert sorted(r["name"] for _t, rows in port for r in rows) == ["b1", "b2"]
    assert all("time" in r and "diff" in r for _t, rows in port for r in rows)


def test_pubsub_write():
    def build(name, pw):
        published = []

        class _Future:
            def result(self, timeout=None):
                return "msgid"

        class _Publisher:
            def topic_path(self, project, topic):
                return f"projects/{project}/topics/{topic}"

            def publish(self, topic_path, data, **attrs):
                published.append((topic_path, json.loads(data), attrs))
                return _Future()

        t = pw.debug.table_from_rows(_in_schema(pw), [("p1", 9), ("p2", 10)])
        pw.io.pubsub.write(t, publisher=_Publisher(), project_id="proj", topic_id="top")
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        return sorted(published, key=repr)

    port, ref = _each(build)
    assert port == ref
    path, doc, attrs = port[0]
    assert path == "projects/proj/topics/top" and doc["name"] == "p1" and doc["n"] == 9
    assert attrs["pathway_diff"] == "1" and "pathway_key" in attrs


# --------------------------------------------------------------------------
# Postgres over a fake psycopg2.connect


def _fake_psycopg2(log: list):
    mod = types.ModuleType("psycopg2")

    class _Cursor:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def execute(self, sql, params=None):
            log.append(("execute", sql, params))

    class _Conn:
        def cursor(self):
            return _Cursor()

        def commit(self):
            log.append(("commit",))

        def close(self):
            log.append(("close",))

    def connect(**settings):
        log.append(("connect", tuple(sorted(settings.items()))))
        return _Conn()

    mod.connect = connect
    return mod


@pytest.mark.parametrize("mode", ["updates", "snapshot"])
def test_postgres_write(monkeypatch, mode):
    """The stream of updates (rows with time and diff, ``init_mode``
    creating the table) and the snapshot (upsert on the primary key, delete
    on a retraction): the same statements, parameters and commits."""
    def build(name, pw):
        log: list = []
        monkeypatch.setitem(sys.modules, "psycopg2", _fake_psycopg2(log))

        class S(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        t = pw.debug.table_from_rows(S, [("a", 1, 0, 1), ("b", 2, 0, 1), ("a", 1, 2, -1), ("a", 5, 2, 1),
                                         ("b", 2, 4, -1)], is_stream=True)
        settings = {"host": "localhost", "dbname": "db"}
        if mode == "updates":
            pw.io.postgres.write(t, settings, "out", init_mode="create_if_not_exists")
        else:
            pw.io.postgres.write_snapshot(t, settings, "out", ["k"])
        pw.run(monitoring_level=pw.MonitoringLevel.NONE)
        return log

    port, ref = _each(build)
    assert [e for e in port if e[0] != "execute"] == [e for e in ref if e[0] != "execute"]
    # rows of one batch in the same order in both packages
    assert [e for e in port if e[0] == "execute"] == [e for e in ref if e[0] == "execute"]
    sqls = [e[1] for e in port if e[0] == "execute"]
    if mode == "updates":
        assert sqls[0].startswith('CREATE TABLE IF NOT EXISTS "out"') and len(sqls) == 6
    else:
        assert sum(s.startswith("DELETE") for s in sqls) == 2 and sum("ON CONFLICT" in s for s in sqls) == 3
