"""``pw.graphs`` and ``pw.viz`` of the port against the JAX package: the
cases of ``tests/test_graphs.py`` (pagerank on a star, Louvain on two
cliques, modularity of a perfect split) run through both packages, seeded
random graphs through both (communities, shortest-path distances and
pagerank's ranks exact, as both packages add the same contributions in
the same order; modularity within ``FLOAT_TOL``), the incremental
pagerank of ``tests/test_iterate_incremental.py`` as an update stream
through both ``pw.iterate``s, and ``pw.viz`` with rich and bokeh blocked.
The JAX side runs with ``PATHWAY_COMPILED_TICK=0``."""

import inspect
import sys

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from torch_parity import streams

PACKAGES = {"port": tpw, "jax": jpw}
FLOAT_TOL = 1e-9


@pytest.fixture(autouse=True)
def _interpreters(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
    yield
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()


def _by(pw, table, key: str, val: str) -> dict:
    _keys, cols = pw.debug.table_to_dicts(table)
    return {cols[key][k]: cols[val][k] for k in cols[key]}


def _both(fn) -> tuple:
    out = []
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
        out.append(fn(pw))
    return tuple(out)


STAR = """
    u | v
    a | hub
    b | hub
    c | hub
    hub | a
"""


def test_pagerank_star():
    port, ref = _both(lambda pw: _by(pw, pw.graphs.pagerank(pw.debug.T(STAR), steps=60), "v", "rank"))
    assert port == ref
    # closed form: hub = 0.405 + 0.85*a, a = 0.15 + 0.85*hub
    assert abs(port["hub"] - 1.9189) < 1e-2 and abs(port["a"] - 1.7811) < 1e-2
    assert abs(port["b"] - 0.15) < 1e-9 and abs(port["c"] - 0.15) < 1e-9
    assert port["hub"] == max(port.values())


CLIQUES = """
    u | v
    a | b
    b | c
    a | c
    x | y
    y | z
    x | z
    c | x
"""


def _vertices_of(pw, edges_text: str):
    names = sorted({w.strip() for line in edges_text.strip().splitlines()[1:] for w in line.split("|")[:2]})
    return pw.debug.T("v\n" + "\n".join(names))


def test_louvain_two_cliques():
    port, ref = _both(lambda pw: _by(
        pw, pw.graphs.louvain_communities(_vertices_of(pw, CLIQUES), pw.debug.T(CLIQUES), iteration_limit=8),
        "v", "c"))
    assert port == ref
    assert port["a"] == port["b"] == port["c"] and port["x"] == port["y"] == port["z"]
    assert port["a"] != port["x"]


def test_modularity_of_perfect_split():
    def q(pw):
        edges = pw.debug.T("u | v | weight\n a | b | 1.0\n x | y | 1.0")
        comms = pw.debug.T("v | c\n a | 1\n b | 1\n x | 2\n y | 2")
        (val,) = pw.debug.table_to_dicts(pw.graphs.modularity(edges, comms))[1]["modularity"].values()
        return val

    port, ref = _both(q)
    assert abs(port - 0.5) < 1e-9 and abs(port - ref) <= FLOAT_TOL


def _random_graph(seed: int, n: int = 12, m: int = 30) -> str:
    rng = np.random.default_rng(seed)
    seen, lines = set(), []
    while len(lines) < m:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        if u == v or (u, v) in seen or (v, u) in seen:
            continue
        seen.add((u, v))
        lines.append(f"v{u} | v{v} | {float(rng.integers(1, 9))}")
    return "u | v | weight\n" + "\n".join(lines)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_random_graph_through_both_packages(seed):
    text = _random_graph(seed)

    def run(pw):
        edges = pw.debug.T(text)
        ranks = _by(pw, pw.graphs.pagerank(edges.select(pw.this.u, pw.this.v), steps=30), "v", "rank")
        pw.internals.parse_graph.G.clear()
        edges = pw.debug.T(text)
        comms = _by(pw, pw.graphs.louvain_communities(_vertices_of(pw, text), edges, iteration_limit=10), "v", "c")
        pw.internals.parse_graph.G.clear()
        edges = pw.debug.T(text)
        c_tab = pw.debug.T("v | c\n" + "\n".join(f"{v} | {c}" for v, c in sorted(comms.items())))
        (q,) = pw.debug.table_to_dicts(pw.graphs.modularity(edges, c_tab))[1]["modularity"].values()
        return ranks, comms, q

    (r_port, c_port, q_port), (r_ref, c_ref, q_ref) = _both(run)
    assert r_port == r_ref
    assert c_port == c_ref
    assert abs(q_port - q_ref) <= FLOAT_TOL


@pytest.mark.parametrize("seed", [3, 4])
def test_bellman_ford_through_both_packages(seed):
    """Shortest paths from two sources over a seeded weighted digraph whose
    edge ends are pointers to the vertex rows; distances are exact (sums of
    small integers as floats), unreachable vertices stay infinite."""
    rng = np.random.default_rng(seed)
    n = 10
    edges = [(f"v{int(u)}", f"v{int(v)}", float(rng.integers(1, 20)))
             for u, v in rng.integers(0, n, (24, 2)) if u != v]

    def run(pw):
        vertices = pw.debug.T("name | is_source\n" + "\n".join(
            f"v{i} | {i in (0, 5)}" for i in range(n))).with_id_from(pw.this.name)
        raw = pw.debug.T("su | sv | dist\n" + "\n".join(f"{u} | {v} | {d}" for u, v, d in edges))
        e = raw.select(u=vertices.pointer_from(pw.this.su), v=vertices.pointer_from(pw.this.sv),
                       dist=pw.this.dist)
        res = pw.graphs.bellman_ford(vertices, e)
        named = res.select(name=vertices.restrict(res).name, d=pw.this.dist_from_source)
        return _by(pw, named, "name", "d")

    port, ref = _both(run)
    assert port == ref
    assert port["v0"] == 0.0 and port["v5"] == 0.0


def _chain_edges(n, prefix, t):
    return [f"{prefix}{i} | {prefix}{i + 1} | {t}" for i in range(n - 1)]


def test_incremental_pagerank_stream_through_both_iterates():
    """The reference's incremental pagerank (three ticks of edges; the
    later two rewire a small component) as an update stream, per package:
    the same rows, ranks included, at the same times."""
    rows = _chain_edges(12, "big", 2) + ["s0 | s1 | 2", "s1 | s2 | 2", "s2 | s3 | 2", "s0 | s2 | 4",
                                          "s0 | s3 | 6"]
    text = "\n".join(["u | v | __time__"] + rows)
    port, ref = streams(PACKAGES, lambda pw: pw.graphs.pagerank(pw.debug.T(text), steps=20))
    assert port == ref and port


def test_viz_with_rich_and_bokeh_blocked(monkeypatch, capsys):
    """Without rich, ``show`` prints through ``compute_and_print`` as the
    reference does; without bokeh, ``plot`` refuses with ImportError in
    both packages; ``table_viz`` gives the same frame."""
    table = "a | b\n 1 | x\n 2 | y"
    frames = _both(lambda pw: pw.viz.table_viz(pw.debug.T(table)))
    assert frames[0].equals(frames[1])
    for name in ("rich", "rich.console", "rich.table", "bokeh", "bokeh.plotting"):
        monkeypatch.setitem(sys.modules, name, None)
    printed = []
    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()
        pw.viz.show(pw.debug.T(table))
        printed.append(capsys.readouterr().out)
        with pytest.raises(ImportError, match="requires bokeh"):
            pw.viz.plot(pw.debug.T(table))
    assert printed[0] == printed[1] and "x" in printed[0]


@pytest.mark.parametrize("module", ["graphs", "viz"])
def test_stdlib_rest_has_the_reference_signatures(module):
    ref, port = getattr(jpw.stdlib, module), getattr(tpw.stdlib, module)
    names = [n for n, v in vars(ref).items() if inspect.isfunction(v) and v.__module__ == ref.__name__]
    assert names
    for n in names:
        assert list(inspect.signature(getattr(port, n)).parameters) == list(inspect.signature(getattr(ref, n)).parameters)
