"""The fuzzy join (``pw.stdlib.ml.smart_table_ops``) of the port against
the JAX package's: the cases of ``tests/test_fuzzy_join.py``, each built
under both packages on the same tables, give the same result table (row
keys, left and right pointers exact; weights within 1e-12, plain ``math``
on Python floats in both) and the same update stream. Then a seeded case
with a heavy/light split (a feature in more rows than
``HEAVY_LIGHT_THRESHOLD``), every normalization, ``fuzzy_self_match``,
``fuzzy_match_with_hint``, projections and ``smart_fuzzy_join`` with
``JoinNormalization``. The JAX side runs with ``PATHWAY_COMPILED_TICK=0``."""

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, norm, streams

PACKAGES = {"jax": jpw, "port": tpw}
WEIGHT_TOL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def ops(pw):
    from importlib import import_module

    return import_module(f"{pw.__name__}.stdlib.ml.smart_table_ops")


def T(pw, text, **kw):
    return pw.debug.table_from_markdown(text, **kw)


def _hand(pw, pairs):
    class Hand(pw.Schema):
        left: pw.Pointer
        right: pw.Pointer
        weight: float

    P = pw.internals.api.Pointer
    return pw.debug.table_from_rows(Hand, [(P(l), P(r), w) for l, r, w in pairs])


def _ids(pw, table, col):
    _k, cols = pw.debug.table_to_dicts(table)
    return {v: k for k, v in cols[col].items()}


def edge_level(pw):
    nodes = T(pw, "name\na\nb\nc\nAA\nBB\nCC", id_from=["name"])
    features = T(pw, """
      | weight | normalization_type
    1 | 1.0    | 1
    2 | 1.0    | 1
    3 | 1.0    | 1
    """)
    sides = []
    for names in (("a", "b", "c"), ("AA", "BB", "CC")):
        rows = "\n".join(f"{n} | {i + 1} | 1.0" for i, n in enumerate(names))
        sides.append(T(pw, "node | feature | weight\n" + rows).with_columns(
            node=nodes.pointer_from(pw.this.node), feature=features.pointer_from(pw.this.feature)))
    return ops(pw).fuzzy_match(sides[0], sides[1], features)


def tables_names(pw):
    left = T(pw, "name\njohn smith\nanne brown\ndavid li")
    right = T(pw, "surname\nsmith john\nbrown anne\nli david")
    return ops(pw).fuzzy_match_tables(left, right)


def mutual_best(pw):
    left = T(pw, "name\nalpha beta gamma\nalpha")
    right = T(pw, "name\nalpha beta gamma")
    return ops(pw).fuzzy_match_tables(left, right)


def letters(pw):
    o = ops(pw)
    return o.fuzzy_match_tables(T(pw, "name\nqwxz"), T(pw, "name\nq-w-x-z"),
                                feature_generation=o.FuzzyJoinFeatureGeneration.LETTERS)


def by_hand(pw):
    left = T(pw, "name\naaa bbb\nccc ddd")
    right = T(pw, "name\naaa bbb\nccc ddd")
    l_ids, r_ids = _ids(pw, left, "name"), _ids(pw, right, "name")
    pw.internals.parse_graph.G.clear()
    left = T(pw, "name\naaa bbb\nccc ddd")
    right = T(pw, "name\naaa bbb\nccc ddd")
    hand = _hand(pw, [(l_ids["aaa bbb"], r_ids["ccc ddd"], 99.0)])
    return ops(pw).fuzzy_match_tables(left, right, by_hand_match=hand)


def self_match(pw):
    t = T(pw, "name\nhello world\nworld hello\nunrelated thing")
    return ops(pw).smart_fuzzy_match(t.name, t.name)


def symmetric_by_hand(pw):
    text = "name\nxx yy\nxx yy zz\nyy zz"
    ids = _ids(pw, T(pw, text), "name")
    pw.internals.parse_graph.G.clear()
    t = T(pw, text)
    hand = _hand(pw, [(ids["xx yy"], ids["xx yy zz"], 7.0)])
    return ops(pw).smart_fuzzy_match(t.name, t.name, by_hand_match=hand)


def compat_case_insensitive(pw):
    return ops(pw).smart_fuzzy_join(T(pw, "name\nJohn Smith"), T(pw, "name\njohn smith"))


REFERENCE_CASES = {
    "edge_level": (edge_level, 3),
    "tables_names": (tables_names, 3),
    "mutual_best": (mutual_best, 1),
    "letters": (letters, 1),
    "by_hand": (by_hand, 1),
    "self_match": (self_match, 1),
    "symmetric_by_hand": (symmetric_by_hand, 1),
    "compat_case_insensitive": (compat_case_insensitive, 1),
}


def results(build):
    """``build(pw)``'s final table under both packages, as {key: row}."""
    out = {}
    for name, pw in PACKAGES.items():
        pw.internals.parse_graph.G.clear()
        table = build(pw)
        keys, cols = pw.debug.table_to_dicts(table)
        names = table.column_names()
        out[name] = {int(k): {n: norm(cols[n][k]) for n in names} for k in keys}
    return out["port"], out["jax"]


def assert_same(got, want):
    assert got.keys() == want.keys()
    for k, row in got.items():
        for n, v in row.items():
            if isinstance(v, float):
                assert abs(v - want[k][n]) <= WEIGHT_TOL, (k, n, v, want[k][n])
            else:
                assert v == want[k][n], (k, n, v, want[k][n])


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_reference_case(case):
    build, rows = REFERENCE_CASES[case]
    got, want = results(build)
    assert_same(got, want)
    assert len(got) == rows


def test_by_hand_pin_wins_in_both():
    """The pin is the only row: its nodes leave automatic matching, and
    the two rows left share no feature."""
    got, want = results(by_hand)
    assert [r["weight"] for r in got.values()] == [r["weight"] for r in want.values()] == [99.0]


def _words(rng, n, vocab, common):
    """Rows of 3-5 words from ``vocab``; every row also holds ``common``."""
    return [" ".join([common] + list(rng.choice(vocab, size=int(rng.integers(2, 5)), replace=False)))
            for _ in range(n)]


def seeded(pw, normalization, threshold):
    o = ops(pw)
    rng = np.random.default_rng(7)
    vocab = np.array([f"w{i}" for i in range(60)])
    lefts = _words(rng, 24, vocab, "the")
    # a right row for each left row: its words shuffled, one dropped or
    # replaced at times, so there are near matches and ties to break
    rights = []
    for s in lefts:
        words = s.split()
        rng.shuffle(words)
        if rng.random() < 0.4:
            words[int(rng.integers(len(words)))] = str(rng.choice(vocab))
        rights.append(" ".join(words))
    left = T(pw, "name\n" + "\n".join(lefts))
    right = T(pw, "name\n" + "\n".join(rights))
    return o.smart_fuzzy_match(left.name, right.name, normalization=o.FuzzyJoinNormalization[normalization],
                               HEAVY_LIGHT_THRESHOLD=threshold)


@pytest.mark.parametrize("normalization", ["WEIGHT", "LOGWEIGHT", "NONE"])
@pytest.mark.parametrize("threshold", [100, 5], ids=["all_light", "heavy_split"])
def test_seeded_normalization_and_heavy_light(normalization, threshold):
    got, want = results(lambda pw: seeded(pw, normalization, threshold))
    assert_same(got, want)
    assert len(got) >= 12


def test_fuzzy_self_match_and_hint_and_projection():
    def build(pw):
        o = ops(pw)
        t = T(pw, "name | city\nann lee | oslo\nlee ann | oslo\nbob ray | rome\nray bob | paris")
        selfm = o.fuzzy_self_match(t.name, normalization=o.FuzzyJoinNormalization.WEIGHT)
        proj = o.fuzzy_match_tables(t, t.select(n2=t.name, c2=t.city),
                                    left_projection={"name": "n", "city": "c"},
                                    right_projection={"n2": "n", "c2": "c"})
        return selfm.concat_reindex(proj)

    got, want = results(build)
    assert_same(got, want)

    def hint(pw):
        nodes = T(pw, "name\na\nb\nAA\nBB", id_from=["name"])
        features = T(pw, "  | weight | normalization_type\n1 | 1.0 | 2\n2 | 2.0 | 3")
        sides = [T(pw, f"node | feature | weight\n{x} | 1 | 1.0\n{y} | 2 | 1.0").with_columns(
            node=nodes.pointer_from(pw.this.node), feature=features.pointer_from(pw.this.feature))
            for x, y in (("a", "b"), ("AA", "BB"))]
        a, bb = (int(pw.internals.api.ref_scalar(n)) for n in ("a", "BB"))
        return ops(pw).fuzzy_match_with_hint(sides[0], sides[1], features, _hand(pw, [(a, bb, 5.0)]))

    got, want = results(hint)
    assert_same(got, want)
    assert 5.0 in {r["weight"] for r in got.values()}


def test_smart_fuzzy_join_normalization_and_stream():
    def build(pw):
        o = ops(pw)
        left = T(pw, "name\nAnn Lee\nBob Ray\nCy Dee")
        right = T(pw, "name\nlee ann\nray bob\ndee x")
        return o.smart_fuzzy_join(left, right, normalization=o.JoinNormalization.LOG)

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want, tol=WEIGHT_TOL)
    assert len(got) == 3
