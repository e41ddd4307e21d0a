"""ms_per_iter: the window's wall time over the iterations it completed
(host clock; the window ends on a device synchronize, none in between)."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["n_iter"]
