"""Smart fuzzy join — normalized feature matching with a heavy/light
split and mutual-best selection: the port's own copy of
``pathway_tpu/stdlib/ml/smart_table_ops/_fuzzy_join.py`` (reference:
python/pathway/stdlib/ml/smart_table_ops/_fuzzy_join.py:1-711). Host
dataflow only; weights are plain ``math`` on Python floats, so they equal
the JAX package's. Nothing is left out.

Algorithm (independent implementation of the reference's design):

1. Feature generation: each row's matching column(s) expand to features
   (words via TOKENIZE, alphanumeric characters via LETTERS), producing an
   edges table (node, feature, weight).
2. Feature informativeness: a feature occurring in cnt rows contributes
   normalize(cnt) — LOGWEIGHT 1/ceil(log2(cnt+1)), WEIGHT
   1/2^ceil(log2 cnt), NONE cnt — so ubiquitous tokens barely count.
3. Heavy/light split (HEAVY_LIGHT_THRESHOLD): pairs are *generated* only
   through light (rare) features, avoiding the quadratic blow-up of
   joining on stop-words; heavy features then add their weight only to
   pairs already generated.
4. Mutual best: per left node keep its best-scoring right (ties broken by
   a (weight, min_id, max_id) pseudoweight), then per right node keep its
   best left — only mutually-best pairs survive.
5. ``by_hand_match`` pins (left, right, weight) decisions: pinned nodes
   are excluded from matching and the pins override the result rows.
6. Projections: column-bucket projections run one fuzzy match per bucket
   and sum the per-pair weights across buckets.
"""

from __future__ import annotations

import math
from enum import IntEnum, auto
from typing import Any, Callable

import pathway_tpu_torch.reducers as reducers
from pathway_tpu_torch.internals.common import apply_with_type, if_else, make_tuple
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this


def _tokenize(obj: Any) -> tuple:
    return tuple(str(obj).split())


def _letters(obj: Any) -> tuple:
    return tuple(c.lower() for c in str(obj) if c.isalnum())


class FuzzyJoinFeatureGeneration(IntEnum):
    AUTO = auto()
    TOKENIZE = auto()
    LETTERS = auto()

    @property
    def generate(self) -> Callable[[Any], tuple]:
        if self == FuzzyJoinFeatureGeneration.LETTERS:
            return _letters
        return _tokenize


def _discrete_weight(cnt: float) -> float:
    if cnt == 0:
        return 0.0
    return 1 / (2 ** math.ceil(math.log2(cnt)))


def _discrete_logweight(cnt: float) -> float:
    if cnt == 0:
        return 0.0
    return 1 / math.ceil(math.log2(cnt + 1))


class FuzzyJoinNormalization(IntEnum):
    WEIGHT = auto()
    LOGWEIGHT = auto()
    NONE = auto()

    @property
    def normalize(self) -> Callable[[float], float]:
        if self == FuzzyJoinNormalization.WEIGHT:
            return _discrete_weight
        if self == FuzzyJoinNormalization.LOGWEIGHT:
            return _discrete_logweight
        return lambda cnt: cnt


# backwards-compatible aliases of the round-2 surface
class JoinNormalization(IntEnum):
    NONE = FuzzyJoinNormalization.NONE
    LOG = FuzzyJoinNormalization.LOGWEIGHT


def _edges_for(table: Table, col_name: str, generate) -> Table:
    e = table.select(
        node=this.id,
        feats=apply_with_type(generate, tuple, table[col_name]),
    ).flatten(this.feats)
    return e.select(node=e.node, feature=e.feats, weight=1.0)


def smart_fuzzy_match(
    left_col,
    right_col,
    *,
    by_hand_match: Table | None = None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    HEAVY_LIGHT_THRESHOLD: int = 100,
    include_pins: bool = True,
) -> Table:
    """Match rows whose ``left_col`` / ``right_col`` values share rare
    features. Returns a (left, right, weight) table of mutually-best pairs
    (reference: smart_fuzzy_match, _fuzzy_join.py:200)."""
    left = left_col.table
    right = right_col.table
    symmetric = left is right and left_col.name == right_col.name
    generate = FuzzyJoinFeatureGeneration(feature_generation).generate
    normalization = FuzzyJoinNormalization(normalization)

    edges_left = _edges_for(left, left_col.name, generate)
    edges_right = (
        edges_left if symmetric else _edges_for(right, right_col.name, generate)
    )
    return _fuzzy_match(
        edges_left,
        edges_right,
        symmetric=symmetric,
        normalization=normalization,
        HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
        by_hand_match=by_hand_match,
        include_pins=include_pins,
    )


def fuzzy_self_match(
    col,
    *,
    by_hand_match: Table | None = None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    HEAVY_LIGHT_THRESHOLD: int = 100,
) -> Table:
    return smart_fuzzy_match(
        col,
        col,
        by_hand_match=by_hand_match,
        normalization=normalization,
        feature_generation=feature_generation,
        HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
    )


def fuzzy_match(
    edges_left: Table,
    edges_right: Table,
    features: Table,
    by_hand_match: Table | None = None,
    HEAVY_LIGHT_THRESHOLD: int = 100,
) -> Table:
    """Edge-level API (reference: fuzzy_match, _fuzzy_join.py:265): edges
    are (node, feature, weight) with feature pointing into a features
    table carrying (weight, normalization_type)."""
    return _fuzzy_match(
        edges_left,
        edges_right,
        symmetric=False,
        normalization=FuzzyJoinNormalization.LOGWEIGHT,
        HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
        by_hand_match=by_hand_match,
        features=features,
    )


def fuzzy_match_with_hint(
    edges_left: Table,
    edges_right: Table,
    features: Table,
    by_hand_match: Table,
    HEAVY_LIGHT_THRESHOLD: int = 100,
) -> Table:
    return fuzzy_match(
        edges_left,
        edges_right,
        features,
        by_hand_match=by_hand_match,
        HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
    )


def _fuzzy_match(
    edges_left: Table,
    edges_right: Table,
    *,
    symmetric: bool,
    normalization: FuzzyJoinNormalization,
    HEAVY_LIGHT_THRESHOLD: int,
    by_hand_match: Table | None,
    features: Table | None = None,
    include_pins: bool = True,
) -> Table:
    import pathway_tpu_torch as pw

    if by_hand_match is not None:
        # pinned nodes do not participate in automatic matching
        # (reference: _filter_out_matched_by_hand, _fuzzy_join.py:300);
        # in symmetric mode the single shared edges table must drop BOTH
        # the pins' left and right nodes
        def _without(edges: Table, pinned: Table) -> Table:
            return edges.difference(
                edges.join(
                    pinned, edges.node == pinned.node, id=edges.id
                ).select()
            )

        pinned_l = by_hand_match.select(node=by_hand_match.left)
        pinned_r = by_hand_match.select(node=by_hand_match.right)
        if symmetric:
            edges_left = _without(_without(edges_left, pinned_l), pinned_r)
            edges_right = edges_left
        else:
            edges_left = _without(edges_left, pinned_l)
            edges_right = _without(edges_right, pinned_r)

    # feature occurrence counts over BOTH sides (one side when symmetric)
    if symmetric:
        all_edges = edges_left
    else:
        all_edges = Table.concat_reindex(
            edges_left.select(feature=edges_left.feature),
            edges_right.select(feature=edges_right.feature),
        )
    feat_cnt = all_edges.groupby(all_edges.feature).reduce(
        feature=all_edges.feature, cnt=reducers.count()
    )
    if features is not None:
        # explicit features table: per-feature base weight and
        # normalization type (reference Feature schema)
        fj = feat_cnt.join(features, feat_cnt.feature == features.id)
        feat_w = fj.select(
            feature=feat_cnt.feature,
            cnt=feat_cnt.cnt,
            nweight=apply_with_type(
                lambda c, w, nt: float(w)
                * float(FuzzyJoinNormalization(nt).normalize(float(c))),
                float,
                feat_cnt.cnt,
                features.weight,
                features.normalization_type,
            ),
        )
    else:
        norm = normalization.normalize
        feat_w = feat_cnt.select(
            feature=feat_cnt.feature,
            cnt=feat_cnt.cnt,
            nweight=apply_with_type(
                lambda c: float(norm(float(c))), float, feat_cnt.cnt
            ),
        )

    def annotate(edges: Table) -> Table:
        j = edges.join(feat_w, edges.feature == feat_w.feature)
        return j.select(
            node=edges.node,
            feature=edges.feature,
            weight=edges.weight,
            cnt=feat_w.cnt,
            nweight=feat_w.nweight,
        )

    el = annotate(edges_left)
    er = el if symmetric else annotate(edges_right)
    el_light = el.filter(el.cnt < HEAVY_LIGHT_THRESHOLD)
    el_heavy = el.filter(el.cnt >= HEAVY_LIGHT_THRESHOLD)
    er_light = er.filter(er.cnt < HEAVY_LIGHT_THRESHOLD)
    er_heavy = er.filter(er.cnt >= HEAVY_LIGHT_THRESHOLD)

    # candidate pairs come from LIGHT features only
    light_pairs = el_light.join(
        er_light, el_light.feature == er_light.feature
    ).select(
        left=pw.left.node,
        right=pw.right.node,
        w=pw.left.weight * pw.right.weight * pw.left.nweight,
    )
    if symmetric:
        light_pairs = light_pairs.filter(light_pairs.left != light_pairs.right)
    light_sum = light_pairs.groupby(light_pairs.left, light_pairs.right).reduce(
        left=light_pairs.left,
        right=light_pairs.right,
        w=reducers.sum(light_pairs.w),
    )

    # heavy features reinforce already-generated pairs only
    heavy_pairs = (
        light_sum.join(el_heavy, light_sum.left == el_heavy.node)
        .select(
            left=pw.left.left,
            right=pw.left.right,
            feature=pw.right.feature,
            lw=pw.right.weight,
            nweight=pw.right.nweight,
        )
        .join(
            er_heavy,
            pw.left.right == er_heavy.node,
            pw.left.feature == er_heavy.feature,
        )
        .select(
            left=pw.left.left,
            right=pw.left.right,
            w=pw.left.lw * pw.right.weight * pw.left.nweight,
        )
    )
    total = Table.concat_reindex(light_sum, heavy_pairs)
    scored = total.groupby(total.left, total.right).reduce(
        left=total.left, right=total.right, w=reducers.sum(total.w)
    )
    # deterministic tie-break: (weight, smaller id, larger id)
    pseudo = scored.select(
        left=scored.left,
        right=scored.right,
        pweight=if_else(
            scored.left < scored.right,
            make_tuple(scored.w, scored.left, scored.right),
            make_tuple(scored.w, scored.right, scored.left),
        ),
    )
    best_l = pseudo.groupby(pseudo.left).reduce(
        left=pseudo.left,
        right=reducers.argmax(pseudo.pweight, pseudo.right),
        pweight=reducers.max(pseudo.pweight),
    )
    best = best_l.groupby(best_l.right).reduce(
        right=best_l.right,
        left=reducers.argmax(best_l.pweight, best_l.left),
        pweight=reducers.max(best_l.pweight),
    )
    result = best.select(
        left=best.left,
        right=best.right,
        weight=apply_with_type(lambda t: float(t[0]), float, best.pweight),
    )
    if symmetric:
        result = result.filter(result.left < result.right)
    if by_hand_match is not None and include_pins:
        pins = by_hand_match.select(
            left=by_hand_match.left,
            right=by_hand_match.right,
            weight=by_hand_match.weight,
        )
        result = Table.concat_reindex(result, pins)
    return result


def _concat_desc(table: Table) -> Table:
    cols = [table[n] for n in table.column_names()]
    return table.select(
        desc=apply_with_type(
            lambda *a: " ".join(str(x) for x in a), str, *cols
        )
    )


def fuzzy_match_tables(
    left_table: Table,
    right_table: Table,
    *,
    by_hand_match: Table | None = None,
    normalization=FuzzyJoinNormalization.LOGWEIGHT,
    feature_generation=FuzzyJoinFeatureGeneration.AUTO,
    left_projection: dict[str, str] | None = None,
    right_projection: dict[str, str] | None = None,
    HEAVY_LIGHT_THRESHOLD: int = 100,
) -> Table:
    """Fuzzy-match whole rows (all columns concatenated), optionally per
    projection bucket. Output columns (left, right, weight) follow the
    reference's JoinResult schema (reference: fuzzy_match_tables,
    _fuzzy_join.py:104)."""
    left_projection = left_projection or {}
    right_projection = right_projection or {}
    if not left_projection or not right_projection:
        left = _concat_desc(left_table)
        right = _concat_desc(right_table)
        return smart_fuzzy_match(
            left.desc,
            right.desc,
            by_hand_match=by_hand_match,
            normalization=normalization,
            feature_generation=feature_generation,
            HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
        )
    buckets: dict[str, tuple[list, list]] = {}
    for col, b in left_projection.items():
        buckets.setdefault(b, ([], []))[0].append(col)
    for col, b in right_projection.items():
        buckets.setdefault(b, ([], []))[1].append(col)
    partials = []
    for b, (lcols, rcols) in buckets.items():
        if not lcols or not rcols:
            continue
        lb = _concat_desc(left_table.select(*[left_table[c] for c in lcols]))
        rb = _concat_desc(right_table.select(*[right_table[c] for c in rcols]))
        partials.append(
            smart_fuzzy_match(
                lb.desc,
                rb.desc,
                by_hand_match=by_hand_match,
                normalization=normalization,
                feature_generation=feature_generation,
                HEAVY_LIGHT_THRESHOLD=HEAVY_LIGHT_THRESHOLD,
                # pins appended once below, not once per bucket
                include_pins=False,
            )
        )
    matchings = Table.concat_reindex(*partials)
    summed = matchings.groupby(matchings.left, matchings.right).reduce(
        matchings.left,
        matchings.right,
        weight=reducers.sum(matchings.weight),
    )
    if by_hand_match is not None:
        pins = by_hand_match.select(
            left=by_hand_match.left,
            right=by_hand_match.right,
            weight=by_hand_match.weight,
        )
        summed = Table.concat_reindex(summed, pins)
    return summed


def smart_fuzzy_join(
    left: Table,
    right: Table,
    reflexive: bool = False,
    normalization: Any = None,
    **kwargs: Any,
) -> Table:
    """Round-2 compatibility wrapper: case-insensitive match on the first
    string columns, output (left_id, right_id, weight)."""
    lcol = left.column_names()[0]
    rcol = right.column_names()[0]
    # the historical surface lowercased before tokenizing; the reference's
    # _tokenize (and ours) does not, so normalize here
    llow = left.select(
        _fj=apply_with_type(lambda s: str(s).lower(), str, left[lcol])
    )
    rlow = right.select(
        _fj=apply_with_type(lambda s: str(s).lower(), str, right[rcol])
    )
    if normalization is None:
        norm = FuzzyJoinNormalization.LOGWEIGHT
    else:
        norm = FuzzyJoinNormalization(
            JoinNormalization(normalization)
            if isinstance(normalization, JoinNormalization)
            else normalization
        )
    res = smart_fuzzy_match(llow._fj, rlow._fj, normalization=norm)
    return res.select(
        left_id=res.left, right_id=res.right, weight=res.weight
    )
