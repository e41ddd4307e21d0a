"""setup_s: process start to the window's start (imports, CUDA context,
kernel build or load, tables, dataset, cut decomposition, scheme, start
and burn-in), host clock."""


def read(ctx):
    return ctx["setup_s"]
