"""Row transformers (``@pw.transformer`` with ``ClassArg`` tables),
``pw.pandas_transformer`` and ``pw.stdlib.utils`` of the port against the
JAX package's: the same classes and functions over the same seeded streams
(``__time__``/``__diff__``) give the same update stream — keys, diffs and
times exact, floats within 1e-9.

The transformer cases are those of ``tests/test_transformers.py``: a plain
output, helper methods, static methods and cached attributes, pointer
chasing across rows and tables, ``output_name``, a row whose output follows
another row that alone changes, ``method`` columns (compared by their
bound row and then by calling them) and a compute function that raises on
some rows, which puts ``ERROR`` where the reference does (seen through
``pw.fill_error``). The pandas and
utils cases are those of ``tests/test_api_parity.py``,
``tests/test_stdlib_misc.py`` and ``tests/test_ported_json.py`` that need no
date/time column (``.dt`` is [temporal])."""

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, markdown, stream, streams

PACKAGES = {"jax": jpw, "port": tpw}


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _args(seed, n=12):
    """(id, arg, time, diff): inserts at times 2/4, some updated at 6."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(1, n + 1):
        v, t = int(rng.integers(-5, 40)), int(rng.integers(1, 3)) * 2
        rows.append((i, v, t, 1))
        if rng.random() < 0.4:
            rows += [(i, v, 6, -1), (i, int(rng.integers(-5, 40)), 6, 1)]
    return rows


def _arg_table(pw, seed):
    return pw.debug.table_from_markdown(markdown(["arg"], _args(seed)))


def b_simple(pw, seed):
    class OutputSchema(pw.Schema):
        ret: int

    @pw.transformer
    class foo:
        class table(pw.ClassArg, output=OutputSchema):
            arg = pw.input_attribute()

            @pw.output_attribute
            def ret(self) -> int:
                return self.arg + 1

    return foo(_arg_table(pw, seed)).table


def b_aux_objects(pw, seed):
    @pw.transformer
    class foo:
        class table(pw.ClassArg):
            arg = pw.input_attribute()
            const = 10

            def fun(self, a) -> int:
                return a * self.arg + self.const

            @staticmethod
            def sfun(b) -> int:
                return b * 100

            @pw.attribute
            def attr(self) -> float:
                return self.arg / 3

            @pw.output_attribute
            def ret(self) -> float:
                return self.arg + self.const + self.fun(1) + self.sfun(self.arg) + self.attr

    return foo(_arg_table(pw, seed)).table


def b_rename(pw, seed):
    class OutputSchema(pw.Schema):
        foo: int

    @pw.transformer
    class foo:
        class table(pw.ClassArg, output=OutputSchema):
            arg = pw.input_attribute()

            @pw.output_attribute(output_name="foo")
            def ret(self) -> int:
                return self.arg * 2

    return foo(_arg_table(pw, seed)).table


def b_errors(pw, seed):
    # rows with a negative arg raise inside the compute function
    @pw.transformer
    class foo:
        class table(pw.ClassArg):
            arg = pw.input_attribute()

            @pw.output_attribute
            def root(self) -> float:
                if self.arg < 0:
                    raise ValueError("negative")
                return self.arg ** 0.5

            @pw.output_attribute
            def same(self) -> int:
                return self.arg

    res = foo(_arg_table(pw, seed)).table
    # an output row holding ERROR reaches no sink: fill it to see where it is
    return res.select(root=pw.fill_error(res.root, -1.0), same=res.same)


def b_list_traversal(pw, seed):
    rng = np.random.default_rng(seed)
    n = 10
    nxt = rng.permutation(n) + 1  # a random successor per node
    node_rows = [(i, int(nxt[i - 1]), 10 * i, 2, 1) for i in range(1, n + 1)]
    req_rows = [(100 + j, int(rng.integers(1, n + 1)), int(rng.integers(0, 6)), 2 + 2 * (j % 3), 1)
                for j in range(8)]

    @pw.transformer
    class list_traversal:
        class nodes(pw.ClassArg):
            next = pw.input_attribute()
            val = pw.input_attribute()

        class requests(pw.ClassArg):
            node = pw.input_attribute()
            steps = pw.input_attribute()

            @pw.output_attribute
            def reached_node(self):
                node = self.transformer.nodes[self.node]
                for _ in range(self.steps):
                    node = self.transformer.nodes[node.next]
                return node.id

            @pw.output_attribute
            def reached_value(self) -> int:
                return self.transformer.nodes[self.reached_node].val

    nodes = pw.debug.table_from_markdown(markdown(["next", "val"], node_rows))
    nodes = nodes.with_columns(next=pw.this.pointer_from(pw.this.next))
    requests = pw.debug.table_from_markdown(markdown(["node", "steps"], req_rows))
    requests = requests.with_columns(node=nodes.pointer_from(pw.this.node))
    return list_traversal(nodes, requests).requests


def b_cross_row(pw, seed):
    # row 1 follows row 2; at time 4 only row 2 changes
    rows = [(1, 2, 100, 2, 1), (2, 0, 200, 2, 1), (3, 1, 300, 2, 1),
            (2, 0, 200, 4, -1), (2, 0, 999, 4, 1)]

    @pw.transformer
    class follow:
        class items(pw.ClassArg):
            ref = pw.input_attribute()
            val = pw.input_attribute()

            @pw.output_attribute
            def other_val(self):
                if self.ref is None:
                    return self.val
                return self.transformer.items[self.ref].val

    t = pw.debug.table_from_markdown(markdown(["refname", "val"], rows))
    t2 = t.select(ref=pw.if_else(t.refname != 0, t.pointer_from(t.refname), None), val=t.val)
    return follow(t2).items


TRANSFORMERS = [b_simple, b_aux_objects, b_rename, b_errors, b_list_traversal, b_cross_row]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("build", TRANSFORMERS, ids=lambda f: f.__name__[2:])
def test_transformer_stream_equals_reference(build, seed):
    got, want = streams(PACKAGES, lambda pw: build(pw, seed), terminate_on_error=False)
    assert want
    assert_streams_equal(got, want)
    if build is b_errors:
        assert any(dict(e[3])["root"] == -1.0 for e in want)


def test_method_columns_equal_reference():
    def build(pw):
        @pw.transformer
        class calc:
            class table(pw.ClassArg):
                arg = pw.input_attribute()

                @pw.output_attribute
                def double(self) -> int:
                    return self.arg * 2

                @pw.method
                def scaled(self, factor) -> int:
                    return self.arg * factor

        return calc(_arg_table(pw, 3)).table

    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        events = []
        pw.io.subscribe(
            build(pw),
            on_change=lambda key, row, time, is_addition: events.append(
                (time, int(is_addition), int(key), row["double"],
                 (row["scaled"].ca_index, row["scaled"].ptr, row["scaled"].attr_name), row["scaled"](7))
            ),
        )
        pw.run()
        out[name] = sorted(events)
    assert out["port"] == out["jax"] and out["jax"]


def test_output_schema_validation_raises_like_reference():
    for pw in PACKAGES.values():
        class OutputSchema(pw.Schema):
            foo: int

        with pytest.raises(RuntimeError, match="output schema validation"):

            @pw.transformer
            class foo_transformer:
                class table(pw.ClassArg, output=OutputSchema):
                    arg = pw.input_attribute()

                    @pw.output_attribute
                    def ret(self) -> int:  # pragma: no cover
                        return self.arg


# --- pandas_transformer and pw.stdlib.utils --------------------------------------


def b_pandas_sum(pw):
    import pandas as pd

    class Out(pw.Schema):
        total: int

    @pw.pandas_transformer(output_schema=Out, output_universe=0)
    def totals(df: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"total": df["arg"] * 3 + 1})

    return totals(_arg_table(pw, 5))


def b_pandas_two_inputs(pw):
    import pandas as pd

    class Out(pw.Schema):
        n: int
        s: int

    @pw.pandas_transformer(output_schema=Out)
    def summary(a: pd.DataFrame, b: pd.DataFrame) -> pd.DataFrame:
        return pd.DataFrame({"n": [len(a) + len(b)], "s": [int(a["arg"].sum() - b["arg"].sum())]})

    return summary(_arg_table(pw, 6), _arg_table(pw, 7))


def b_apply_all_rows(pw):
    t = _arg_table(pw, 8)

    def rank(vals):
        order = sorted(vals)
        return [order.index(v) for v in vals]

    return pw.utils.col.apply_all_rows(t.arg, fun=rank, result_col_name="rank")


def b_multiapply_all_rows(pw):
    t = _arg_table(pw, 9).with_columns(b=pw.this.arg * 2)

    def fun(xs, ys):
        total = sum(xs)
        return [x - total for x in xs], [x + y for x, y in zip(xs, ys)]

    return pw.utils.col.multiapply_all_rows(t.arg, t.b, fun=fun, result_col_names=["centered", "s"])


def b_majority(pw):
    rng = np.random.default_rng(10)
    rows = [(i, int(rng.integers(0, 3)), int(rng.integers(0, 4)), 2 + 2 * (i % 3), 1) for i in range(1, 25)]
    t = pw.debug.table_from_markdown(markdown(["g", "v"], rows))
    return pw.stdlib.utils.col.groupby_reduce_majority(t.g, t.v)


def b_unpack_col(pw):
    t = _arg_table(pw, 11)
    packed = t.select(p=pw.make_tuple(t.arg, t.arg * 2, t.arg % 3))
    return pw.utils.col.unpack_col(packed.p, "a", "b", "c")


def b_flatten_column(pw):
    t = _arg_table(pw, 12)
    lists = t.select(xs=pw.apply(lambda a: tuple(range(abs(a) % 4)), t.arg))
    return pw.utils.col.flatten_column(lists.xs)


def b_unpack_col_dict(pw):
    from typing import Optional

    class S(pw.Schema):
        i: int
        f: float
        s: str
        b: Optional[bool]
        j: pw.Json

    rng = np.random.default_rng(13)
    objs = [
        {"i": int(rng.integers(100)), "f": float(rng.integers(100)) / 4, "s": f"s{k}",
         "b": None if k % 3 == 0 else bool(k % 2), "j": {"k": k}}
        for k in range(6)
    ]
    t = pw.debug.table_from_rows(pw.schema_from_types(obj=pw.Json), [(o,) for o in objs])
    return pw.utils.col.unpack_col_dict(t.obj, S)


def b_argmax_rows(pw):
    rng = np.random.default_rng(14)
    rows = [(i, int(rng.integers(0, 3)), int(rng.integers(0, 50)), 2, 1) for i in range(1, 16)]
    t = pw.debug.table_from_markdown(markdown(["g", "v"], rows))
    return pw.utils.filtering.argmax_rows(t, t.g, what=t.v)


def b_argmin_rows(pw):
    rng = np.random.default_rng(15)
    rows = [(i, int(rng.integers(0, 3)), int(rng.integers(0, 50)), 2, 1) for i in range(1, 16)]
    t = pw.debug.table_from_markdown(markdown(["g", "v"], rows))
    return pw.stdlib.utils.filtering.argmin_rows(t, t.g, what=t.v)


UTILS = [
    b_pandas_sum, b_pandas_two_inputs, b_apply_all_rows, b_multiapply_all_rows, b_majority,
    b_unpack_col, b_flatten_column, b_unpack_col_dict, b_argmax_rows, b_argmin_rows,
]


@pytest.mark.parametrize("build", UTILS, ids=lambda f: f.__name__[2:])
def test_utils_stream_equals_reference(build):
    got, want = streams(PACKAGES, build)
    assert want
    assert_streams_equal(got, want)


def test_pandas_transformer_duplicate_index_raises_like_reference():
    import pandas as pd

    for pw in PACKAGES.values():
        pw.internals.parse_graph.G.clear()

        class Out(pw.Schema):
            x: int

        @pw.pandas_transformer(output_schema=Out)
        def dup(df: pd.DataFrame) -> pd.DataFrame:
            return pd.DataFrame({"x": [1, 2]}, index=[5, 5])

        with pytest.raises(ValueError, match="unique"):
            stream(pw, dup(_arg_table(pw, 0)))
