"""Milliseconds of the embedder's ``embed.batch`` spans (tokenize, forward
and the copy back) per passage or query they embedded in the window."""


def read(ctx):
    spans = [(d, a.get("docs", 0)) for name, _s, d, a in ctx.spans if name == "embed.batch"]
    docs = sum(n for _d, n in spans)
    if not docs:
        return None
    return sum(d for d, _n in spans) / 1e6 / docs
