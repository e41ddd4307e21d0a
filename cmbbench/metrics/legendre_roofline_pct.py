"""legendre_roofline_pct: the Legendre stage's calls in the traced window,
each at its least time (cmbbench.roofline, keyed on the call), over the
device time of the Legendre kernels there (profiler, by kernel name)."""

from cmbbench.roofline import LEGENDRE_KERNEL, least_time


def read(ctx):
    win = ctx.get("window_us")
    calls = ctx.get("legendre_calls") or []
    if not win or not calls or any(c["symmetric"] is None for c in calls):
        return None
    dev = sum(min(e, win[1]) - max(s, win[0])
              for name, s, e in ctx["device_ops"]
              if LEGENDRE_KERNEL.search(name) and e > win[0] and s < win[1])
    if dev <= 0:
        return None
    need = sum(least_time(c["kind"], c["L"], c["nr"], c["C"], c["table"],
                          c["compute"], c["symmetric"]) for c in calls)
    return 100.0 * need / (dev * 1e-6)
