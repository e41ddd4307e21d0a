"""ess_p05_per_s: the 5th percentile over every EE and BB bin of the
pooled ESS of the window's iterations, over the window's seconds: the
slowest-mixing bins, which decide how long a run must last."""


def read(ctx):
    return ctx["ess"]["p05"] / ctx["window_s"]
