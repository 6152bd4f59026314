"""Shared helpers of the replicated read plane's parity tests
(``test_torch_replication.py``, ``test_torch_router.py``,
``test_torch_result_cache.py``): one namespace per package, so that a
scenario written once runs through the JAX package and through the port
and the two outcomes can be compared; the toy indexes and responders of the
reference's own tests; HTTP calls on the standard library, each with a
deadline."""

from __future__ import annotations

import http.client
import importlib
import json
import time

import numpy as np

MODULES = {
    "replicate": "parallel.replicate",
    "wire": "parallel.wire",
    "replica": "serving.replica",
    "router": "serving.router",
    "result_cache": "serving.result_cache",
    "batch_mod": "engine.batch",
    "backends": "persistence.backends",
    "glue": "persistence._runtime_glue",
    "tracing": "observability.tracing",
    "serving": "serving",
    "index_impls": "stdlib.indexing._index_impls",
    "gen_serving": "generate.serving",
    "scheduler": "generate.scheduler",
}


class Pkg:
    """The modules of one package under the names of ``MODULES``."""

    def __init__(self, name: str):
        self.name = name
        self.root = "pathway_tpu" if name == "jax" else "pathway_tpu_torch"
        for attr, mod in MODULES.items():
            setattr(self, attr, importlib.import_module(f"{self.root}.{mod}"))

    @property
    def device_kw(self) -> dict:
        """The port's entry points take ``device=`` (the CPU here)."""
        return {} if self.name == "jax" else {"device": "cpu"}

    def batch(self, rows):
        """A delta batch of ``(key, diff, (vector, meta))`` rows."""
        return self.batch_mod.DiffBatch.from_rows(rows, ("_data", "_meta"))

    def knn_index(self, dim: int, **kw):
        return self.index_impls.TpuDenseKnnIndex(dimensions=dim, **self.device_kw, **kw)

    def replica_server(self, **kw):
        return self.replica.ReplicaServer(**kw, **self.device_kw)

    def reset(self) -> None:
        self.replicate.reset_publisher()


_PKGS: dict[str, Pkg] = {}


def pkg(name: str) -> Pkg:
    if name not in _PKGS:
        _PKGS[name] = Pkg(name)
    return _PKGS[name]


def both(scenario, *args, **kw):
    """The scenario's outcome through each package: (jax, torch)."""
    return scenario(pkg("jax"), *args, **kw), scenario(pkg("torch"), *args, **kw)


class ToyIndex:
    """Dict-backed index: deterministic, no device work — the reference
    tests' stand-in for TpuDenseKnnIndex."""

    def __init__(self):
        self.d = {}

    def upsert(self, key, data, meta):
        self.d[key] = (data, meta)

    def remove(self, key):
        self.d.pop(key, None)

    def search(self, triples):
        return [tuple((key, 1.0) for key in sorted(self.d)[: int(k)]) for _q, k, _f in triples]


class ToyVecIndex:
    """Brute-force vector index with the (score desc, key asc) tie-break."""

    def __init__(self):
        self.d: dict[int, np.ndarray] = {}

    def keys(self):
        return list(self.d.keys())

    def __len__(self):
        return len(self.d)

    def upsert(self, key, data, meta):
        self.d[int(key)] = np.asarray(data, dtype=np.float32)

    def remove(self, key):
        self.d.pop(int(key), None)

    def filter_keys(self, pred):
        self.d = {k: v for k, v in self.d.items() if pred(k)}

    def search(self, triples):
        out = []
        for q, k, _f in triples:
            qv = np.asarray(q, dtype=np.float32)
            scored = sorted(((key, float(qv @ vec)) for key, vec in self.d.items()), key=lambda m: (-m[1], m[0]))
            out.append(tuple(scored[: int(k)]))
        return out


def toy_responder(server, values):
    delay = float(values.get("delay_s", 0.0))
    if delay:
        time.sleep(delay)
    res = server.search([(None, int(values.get("k", 3)), None)])[0]
    return {"matches": [[k, s] for k, s in res], "replica": server.replica_id}


def wait(pred, timeout: float = 15.0, interval: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class Reply:
    def __init__(self, status: int, headers: dict, body: bytes):
        self.status = status
        self.headers = headers  # lower-case names
        self.body = body

    def json(self):
        return json.loads(self.body)


def call(port: int, method: str, path: str, body=None, headers=None, timeout: float = 20.0) -> Reply:
    """One HTTP exchange on the standard library, with a deadline."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        hdrs = {"content-type": "application/json", **(headers or {})} if data is not None else dict(headers or {})
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        raw = resp.read()
        return Reply(resp.status, {k.lower(): v for k, v in resp.getheaders()}, raw)
    finally:
        conn.close()


def post(port: int, path: str = "/query", body=None, headers=None, timeout: float = 20.0) -> Reply:
    return call(port, "POST", path, {} if body is None else body, headers, timeout)


def get(port: int, path: str, timeout: float = 20.0) -> Reply:
    return call(port, "GET", path, None, None, timeout)


def same_matches(a, b, tol: float = 1e-5) -> bool:
    """Equal keys and scores within ``tol``, position by position."""
    return len(a) == len(b) and all(
        int(x[0]) == int(y[0]) and abs(float(x[1]) - float(y[1])) <= tol for x, y in zip(a, b)
    )
