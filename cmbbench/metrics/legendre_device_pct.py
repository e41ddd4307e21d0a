"""legendre_device_pct: the Legendre kernels' device time over all device
time in the traced window (profiler, by kernel name)."""

from cmbbench.roofline import LEGENDRE_KERNEL


def read(ctx):
    win = ctx.get("window_us")
    if not win:
        return None
    tot = leg = 0.0
    for name, s, e in ctx["device_ops"]:
        if e > win[0] and s < win[1]:
            t = min(e, win[1]) - max(s, win[0])
            tot += t
            if LEGENDRE_KERNEL.search(name):
                leg += t
    return 100.0 * leg / tot if leg > 0 else None
