"""Helpers shared by the Table-API parity tests of the port
(``test_torch_iterate.py``, ``test_torch_sql.py``,
``test_torch_transformers.py``, ``test_torch_async_transformer.py``,
``test_torch_persistence.py``, ``test_torch_components.py``): seeded
``table_from_markdown`` streams, the update stream of a table, recorded
with ``pw.io.subscribe`` as (time, diff, id, values) events, and connected
components by ``pw.iterate`` (``chip_smoke.cc_components``)."""

import numpy as np

# the body the smoke's components phase runs on the card, so the parity
# tests hold that very body against the JAX package
from chip_smoke import cc_components as components  # noqa: F401

FLOAT_TOL = 1e-9


def norm(v):
    """A value in a form both packages' values compare equal in."""
    if isinstance(v, tuple):
        return tuple(norm(x) for x in v)
    if isinstance(v, np.generic):
        return v.item()
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if type(v).__name__ == "Json":
        return ("json", repr(v.value))
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def stream(pw, table, **run_kwargs):
    """Run the graph and return ``table``'s update stream, sorted."""
    events = []

    def on_change(key, row, time, is_addition):
        events.append(
            (time, 1 if is_addition else -1, int(key),
             tuple(sorted((k, norm(v)) for k, v in row.items())))
        )

    pw.io.subscribe(table, on_change=on_change)
    pw.run(**run_kwargs)
    return sorted(events, key=repr)


def streams(packages, build, **run_kwargs):
    """``build(pw)``'s update stream under the port and under the JAX
    package (``packages``: {"port": ..., "jax": ...}), each on a fresh graph."""
    out = {}
    for name, pw in packages.items():
        pw.internals.parse_graph.G.clear()
        out[name] = stream(pw, build(pw), **run_kwargs)
    return out["port"], out["jax"]


def assert_streams_equal(got, want, tol=FLOAT_TOL):
    """Keys, diffs, times and non-float values exact; floats within ``tol``."""
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        assert g[:3] == w[:3], (g, w)
        assert [k for k, _ in g[3]] == [k for k, _ in w[3]], (g, w)
        for (_, gv), (_, wv) in zip(g[3], w[3]):
            if isinstance(wv, float) and isinstance(gv, float):
                assert abs(gv - wv) <= tol, (g, w)
            else:
                assert gv == wv, (g, w)


def markdown(columns, rows):
    """A ``table_from_markdown`` text: ``rows`` are (id, *values, time,
    diff) tuples; ``id`` None leaves the id column out."""
    with_id = rows and rows[0][0] is not None
    head = ("    | " if with_id else "") + " | ".join(list(columns) + ["__time__", "__diff__"])
    lines = [head]
    for r in rows:
        cells = [str(x) for x in r[1:]]
        lines.append((f"{r[0]} | " if with_id else "") + " | ".join(cells))
    return "\n".join(lines)
