"""pw.graphs — graph algorithms on tables, the port's own copy of
``pathway_tpu/stdlib/graphs`` (upstream: stdlib/graphs/: pagerank,
bellman_ford, louvain_communities), built on the port's ``pw.iterate``."""

from __future__ import annotations

import pathway_tpu_torch.reducers as reducers
from pathway_tpu_torch.internals.common import coalesce, if_else
from pathway_tpu_torch.internals.iterate import iterate
from pathway_tpu_torch.internals.thisclass import this


def pagerank(edges, steps: int = 5, damping: float = 0.85):
    """PageRank over an edge table with columns (u, v): u -> v
    (reference: stdlib/graphs/pagerank/). Returns table keyed by vertex with
    column `rank` (scaled int like the reference's fixed-point ranks)."""
    out_degree = edges.groupby(edges.u).reduce(
        edges.u, degree=reducers.count()
    )
    vertices_u = edges.groupby(edges.u).reduce(edges.u).select(v=this.u)
    vertices_v = edges.groupby(edges.v).reduce(edges.v).select(v=this.v)
    vertices = (
        vertices_u.concat_reindex(vertices_v)
        .groupby(this.v)
        .reduce(this.v)
    )

    base = vertices.select(v=this.v, rank=1.0)

    def step(ranks):
        deg = out_degree.with_id_from(this.u)
        r = ranks.with_id_from(this.v)
        contribs = edges.select(
            src=edges.u,
            dst=edges.v,
        )
        with_rank = contribs.select(
            dst=this.dst,
            contrib=r.ix(contribs.select(
                _p=ranks.pointer_from(this.src)
            )._p, optional=True).rank
            / deg.ix(contribs.select(
                _p=out_degree.pointer_from(this.src)
            )._p, optional=True).degree,
        )
        summed = with_rank.groupby(this.dst).reduce(
            v=this.dst, incoming=reducers.sum(this.contrib)
        )
        joined = ranks.select(v=this.v).with_id_from(this.v)
        s2 = summed.with_id_from(this.v)
        new_ranks = joined.select(
            v=this.v,
            rank=(1 - damping)
            + damping * coalesce(s2.restrict(joined).incoming, 0.0),
        )
        return new_ranks.with_id_from(this.v)

    ranks = base.with_id_from(this.v)
    result = iterate(
        lambda ranks: step(ranks), iteration_limit=steps, ranks=ranks
    )
    return result


def bellman_ford(vertices, edges):
    """Shortest paths from vertices where is_source=True over edges
    (u, v, dist) (reference: stdlib/graphs/bellman_ford/)."""
    import math

    base = vertices.select(
        dist_from_source=if_else(
            this.is_source, 0.0, math.inf
        )
    )

    def step(state):
        relaxed = edges.join(
            state, edges.u == state.id
        ).select(
            v=edges.v,
            dist=state.dist_from_source + edges.dist,
        )
        best = relaxed.groupby(this.v).reduce(
            best=reducers.min(this.dist), v=this.v
        ).with_id(this.v)
        new_state = state.select(
            dist_from_source=if_else(
                best.restrict(state).best.is_not_none()
                & (coalesce(best.restrict(state).best, math.inf)
                   < this.dist_from_source),
                coalesce(best.restrict(state).best, math.inf),
                this.dist_from_source,
            )
        )
        return new_state

    return iterate(lambda state: step(state), state=base)


def modularity(edges, communities):
    """Modularity Q of a community assignment.
    (reference: stdlib/graphs/louvain_communities/ exact modularity check)

    edges: (u, v, weight); communities: keyed by vertex with column `c`.
    Returns a 1-row table with column `modularity`:
    Q = sum_c (in_c / m  -  (tot_c / 2m)^2 * 2)   [undirected convention]
    """
    cu = communities.with_id_from(this.v)
    e_p = edges.select(
        weight=this.weight,
        _pu=communities.pointer_from(this.u),
        _pv=communities.pointer_from(this.v),
    )
    e = e_p.select(
        weight=this.weight,
        cu=cu.ix(e_p._pu).c,
        cv=cu.ix(e_p._pv).c,
    )
    m_t = e.groupby().reduce(m=reducers.sum(this.weight))
    intra = e.filter(this.cu == this.cv).groupby().reduce(
        w_in=reducers.sum(this.weight)
    )
    # degree mass per community
    du = e.select(c=this.cu, w=this.weight)
    dv = e.select(c=this.cv, w=this.weight)
    deg = du.concat_reindex(dv).groupby(this.c).reduce(
        this.c, tot=reducers.sum(this.w)
    )
    sq = deg.groupby().reduce(sq=reducers.sum(this.tot * this.tot))
    # all three aggregates are single-row tables keyed by the empty-group
    # pointer, so ix on a shared constant pointer column fuses them
    one_p = m_t.select(
        m=this.m,
        _pi=intra.pointer_from(),
        _ps=sq.pointer_from(),
    )
    return one_p.select(
        modularity=coalesce(intra.ix(one_p._pi, optional=True).w_in, 0.0)
        / this.m
        - sq.ix(one_p._ps).sq / (4.0 * this.m * this.m)
    )


def _louvain_one_level(vertices, edges, iteration_limit: int = 10):
    """One Louvain level: vertices greedily adopt the neighboring community
    with the largest modularity gain until stable
    (reference: stdlib/graphs/louvain_communities/ one-level step, built on
    pw.iterate like the reference)."""
    base = vertices.select(v=this.v, c=this.v).with_id_from(this.v)
    m_t = edges.groupby().reduce(m=reducers.sum(this.weight))

    def step(comm):
        cu = comm.with_id_from(this.v)
        # incidence list: (x, y, w) both directions; look up y's community
        # via the two-step pointer pattern (compute pointer column first,
        # then ix — same as pagerank above)
        fwd = edges.select(x=this.u, y=this.v, w=this.weight)
        bwd = edges.select(x=this.v, y=this.u, w=this.weight)
        inc0 = fwd.concat_reindex(bwd)
        inc_p = inc0.select(
            x=this.x, w=this.w, _py=comm.pointer_from(this.y)
        )
        inc = inc_p.select(x=this.x, w=this.w, cy=cu.ix(inc_p._py).c)
        cand = inc.groupby(this.x, this.cy).reduce(
            this.x, this.cy, k_in=reducers.sum(this.w)
        )
        # degree of each vertex and total degree mass of each community
        deg = inc.groupby(this.x).reduce(this.x, k=reducers.sum(this.w))
        cd_p = inc.select(w=this.w, _px=comm.pointer_from(this.x))
        comm_deg = cd_p.select(
            c=cu.ix(cd_p._px).c, w=this.w
        ).groupby(this.c).reduce(this.c, tot=reducers.sum(this.w))
        cand_p = cand.select(
            x=this.x,
            cy=this.cy,
            k_in=this.k_in,
            _pd=deg.pointer_from(this.x),
            _pc=comm_deg.pointer_from(this.cy),
            _pm=m_t.pointer_from(),
            _px=comm.pointer_from(this.x),
        )
        # score(x -> cy) = k_in - k_x * tot_cy' / 2m, with x's own degree
        # excluded from its current community's total (standard Louvain ΔQ
        # up to the constant 1/m factor)
        scored = cand_p.select(
            x=this.x,
            cy=this.cy,
            cur=cu.ix(cand_p._px).c,
            gain=this.k_in
            - deg.ix(cand_p._pd).k
            * (
                coalesce(comm_deg.ix(cand_p._pc, optional=True).tot, 0.0)
                - if_else(
                    cu.ix(cand_p._px).c == this.cy,
                    deg.ix(cand_p._pd).k,
                    0.0,
                )
            )
            / (2.0 * m_t.ix(cand_p._pm).m),
        )
        # moving is worthwhile only if the best OTHER community beats
        # staying in the current one
        others = scored.filter(this.cy != this.cur)
        best = others.groupby(this.x).reduce(
            this.x,
            best_c=reducers.argmax(this.gain, this.cy),
            best_gain=reducers.max(this.gain),
        )
        b = best.with_id_from(this.x)
        stay_cand = scored.filter(this.cy == this.cur).groupby(this.x).reduce(
            this.x, stay=reducers.max(this.gain)
        )
        # a vertex with no neighbor in its own community: staying score is
        # -k_x * (tot_cur - k_x) / 2m with k_in = 0
        st_p = comm.select(
            v=this.v,
            _pd=deg.pointer_from(this.v),
            _pc=comm_deg.pointer_from(this.c),
            _pm=m_t.pointer_from(),
            _ps=stay_cand.pointer_from(this.v),
        )
        stay_t = st_p.select(
            v=this.v,
            stay=coalesce(
                stay_cand.ix(st_p._ps, optional=True).stay,
                -coalesce(deg.ix(st_p._pd, optional=True).k, 0.0)
                * (
                    coalesce(comm_deg.ix(st_p._pc, optional=True).tot, 0.0)
                    - coalesce(deg.ix(st_p._pd, optional=True).k, 0.0)
                )
                / (2.0 * m_t.ix(st_p._pm).m),
            ),
        ).with_id_from(this.v)
        # Synchronous moves oscillate (adjacent vertices swap labels), so a
        # vertex moves only if its hash priority beats every neighbor that
        # also wants to move — an independent set of movers, like sequential
        # Louvain's one-at-a-time moves. The globally top-priority mover
        # always qualifies, so progress is guaranteed; when nobody wants to
        # move the state is unchanged and iterate's fixpoint check stops.
        from pathway_tpu_torch.internals.api import ref_scalar
        from pathway_tpu_torch.internals.common import apply_with_type

        flags = comm.select(
            v=this.v,
            p=apply_with_type(
                lambda v: int(ref_scalar(v)) & ((1 << 62) - 1), int, this.v
            ),
            wants=coalesce(b.restrict(comm).best_gain, -1e18)
            > stay_t.restrict(comm).stay + 1e-12,
        ).with_id_from(this.v)
        nb_p = inc0.select(x=this.x, _q=flags.pointer_from(this.y))
        nbr_pri = nb_p.select(
            x=this.x,
            py=if_else(flags.ix(nb_p._q).wants, flags.ix(nb_p._q).p, -1),
        )
        nbr_max = nbr_pri.groupby(this.x).reduce(
            this.x, mx=reducers.max(this.py)
        )
        nm = nbr_max.with_id_from(this.x)
        new_comm = comm.select(
            v=this.v,
            c=if_else(
                flags.restrict(comm).wants
                & (
                    flags.restrict(comm).p
                    > coalesce(nm.restrict(comm).mx, -1)
                ),
                coalesce(b.restrict(comm).best_c, this.c),
                this.c,
            ),
        )
        return new_comm.with_id_from(this.v)

    return iterate(
        lambda comm: step(comm), iteration_limit=iteration_limit, comm=base
    )


def louvain_communities(vertices, edges, iteration_limit: int = 10):
    """Community detection: one-level Louvain on (u, v, weight) edges
    (reference: stdlib/graphs/louvain_communities/). Returns a table keyed
    by vertex with columns (v, c) — c is the community representative."""
    if "weight" not in edges.column_names():
        edges = edges.select(this.u, this.v, weight=1.0)
    return _louvain_one_level(vertices, edges, iteration_limit)
