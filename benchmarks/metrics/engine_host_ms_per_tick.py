"""Host milliseconds per engine tick in the window, of every operator but
the embedder's UDF nodes and the index (``Runtime.stats.node_ns``): the
input, the reply's repack (flatten, ix, groupby, join) and the sink."""


def read(ctx):
    if not ctx.ticks:
        return None
    skip = ctx.embed_nodes | ctx.index_nodes
    ns = sum(v for n, v in ctx.node_ns.items() if n not in skip)
    return ns / 1e6 / ctx.ticks
