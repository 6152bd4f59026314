"""The block top-k kernel's share of its roofline over the window: the sum
over the window's launches of the least time the card could take
(roofline.py, at the configuration's stated index precision) over the
kernel's device time in the profiler's trace, in percent. The launches'
shapes are the program's counts by (B, k) and by corpus rows N; where the
window launched several (B, k) at several N they cannot be paired, and the
metric is left out."""

from benchmarks import roofline


def read(ctx):
    if ctx.device is None or ctx.peaks is None or not ctx.device["block_topk_s"]:
        return None
    shapes, rows = ctx.topk_shapes, ctx.topk_rows
    if len(rows) == 1:
        (n,) = rows
        launches = [(b, n, k, count) for (b, k), count in shapes.items()]
    elif len(shapes) == 1:
        ((b, k),) = shapes
        launches = [(b, n, k, count) for n, count in rows.items()]
    else:
        return None
    d, dtype = ctx.config["encoder"]["hidden_size"], ctx.config["index"]["dtype"]
    bound = sum(count * roofline.block_topk_bound_s(b, n, d, k, dtype, ctx.peaks)
                for b, n, k, count in launches)
    return 100.0 * bound / ctx.device["block_topk_s"]
