"""Host milliseconds of the index operator (``ExternalIndexExec``, whose
search waits for the kernel) per tick in which it had work."""


def read(ctx):
    if not ctx.index_ticks:
        return None
    return sum(ctx.node_ns.get(n, 0) for n in ctx.index_nodes) / 1e6 / ctx.index_ticks
