"""The share of the traced window in which no kernel, copy or memset ran on
the card (torch.profiler), in percent."""


def read(ctx):
    if ctx.device is None or not ctx.device["window_s"]:
        return None
    return 100.0 * (1.0 - ctx.device["busy_s"] / ctx.device["window_s"])
