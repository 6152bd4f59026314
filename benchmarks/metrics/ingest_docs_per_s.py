"""Passages that reached the index in the window (their commit's probe came
back ranking one of them first), per second of the window."""


def read(ctx):
    if not ctx.probes:
        return None
    return len(ctx.passage_tokens_reached) / ctx.window_s
