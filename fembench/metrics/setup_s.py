"""setup_s: process start to the window's start, host clock (load, the
kernels' build on a checkout's first run, the warm-up step), less the
benchmark's own writing of the scene files."""


def read(ctx):
    return ctx["host"]["setup_s"]
