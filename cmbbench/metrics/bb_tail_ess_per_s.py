"""bb_tail_ess_per_s: the median pooled ESS of the BB bins at l >= 300
over the window's seconds (bench.py's BB tail; 0.0 where there are
none)."""


def read(ctx):
    return ctx["ess"]["bb_tail"] / ctx["window_s"]
