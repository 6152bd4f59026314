"""Replies received in the window, per second of the window."""


def read(ctx):
    if not ctx.requests:
        return None
    return len(ctx.query_tokens_answered) / ctx.window_s
