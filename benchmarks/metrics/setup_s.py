"""Set-up: process start to the window's start (loading, warm-up and, in a
checkout's first run, building the kernels)."""


def read(ctx):
    return ctx.setup_s
