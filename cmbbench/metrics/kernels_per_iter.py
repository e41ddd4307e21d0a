"""kernels_per_iter: CUDA kernels that ran in the traced window, per
iteration (profiler trace; copies and memsets not counted)."""


def read(ctx):
    win = ctx.get("window_us")
    if not win:
        return None
    n = sum(1 for name, s, e in ctx["device_ops"]
            if s >= win[0] and e <= win[1]
            and not name.startswith(("Memcpy", "Memset")))
    return n / ctx["n_iter"] if n else None
