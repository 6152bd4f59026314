"""``pw.io.python`` commits, settled against the JAX package: one subject
script, run under both packages, gives the same final rows with and without
``commit()``.

The two packages group rows into ticks differently: the JAX package's
``commit()`` does nothing and every ``next()`` reaches the engine at its
next tick, while the port (as upstream Pathway) holds a subject's rows until
``commit()``, ``autocommit_duration_ms`` or the end of ``run()``. What the
engine computes from them is the same, so the final rows (ids included)
must be equal; the port's tick count follows the commits."""

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _script(pw, commit: bool, autocommit_ms):
    class S(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        word: str
        n: int

    class Subject(pw.io.python.ConnectorSubject):
        def run(self):
            for batch in range(5):
                for i in range(batch * 8, batch * 8 + 8):
                    self.next(k=i, word=f"w{i % 5}", n=i)
                if batch == 3:
                    for i in (2, 9, 17):
                        self._remove(_key(pw, i), dict(k=i, word=f"w{i % 5}", n=i))
                if commit:
                    self.commit()

    t = pw.io.python.read(Subject(), schema=S, autocommit_duration_ms=autocommit_ms)
    counts = t.groupby(t.word).reduce(t.word, c=pw.reducers.count(), s=pw.reducers.sum(t.n))
    state, ticks = {}, set()

    def on_change(key, row, time, is_addition):
        ticks.add(time)
        if is_addition:
            state[int(key)] = tuple(sorted(row.items()))
        elif state.get(int(key)) == tuple(sorted(row.items())):
            del state[int(key)]

    pw.io.subscribe(counts, on_change=on_change)
    pw.run()
    return state, len(ticks)


def _key(pw, i):
    """The row key of primary key ``i`` in ``pw``'s package."""
    return pw.Pointer(int(pw.internals.api.ref_scalar(i)))


@pytest.mark.parametrize("autocommit_ms", [1500, 50, None])
@pytest.mark.parametrize("commit", [True, False], ids=["commit", "no_commit"])
def test_final_rows_equal_reference(commit, autocommit_ms):
    ref, _ = _script(jpw, commit, autocommit_ms)
    port_parse_graph.G.clear()
    got, ticks = _script(tpw, commit, autocommit_ms)
    assert got == ref
    assert len(got) == 5 and sum(dict(r)["c"] for r in got.values()) == 40 - 3
    if commit:
        assert ticks <= 5  # one tick per commit at most
