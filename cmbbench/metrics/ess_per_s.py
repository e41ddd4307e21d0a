"""ess_per_s: the median over every EE and BB bin of the pooled ESS of the
window's iterations, over the window's seconds (bench.py's value)."""


def read(ctx):
    return ctx["ess"]["median"] / ctx["window_s"]
