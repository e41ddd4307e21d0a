"""device_idle_pct: the share of the traced window in which no operation
ran on the device: the window less the union of the device ops'
intervals (profiler trace), over the window."""


def read(ctx):
    win = ctx.get("window_us")
    if not win or ctx["busy_s"] <= 0:
        return None
    w = (win[1] - win[0]) * 1e-6
    return 100.0 * (1.0 - ctx["busy_s"] / w)
