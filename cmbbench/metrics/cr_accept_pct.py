"""cr_accept_pct: the MALA accept rate of the CR step over the window's
iterations and chains."""


def read(ctx):
    return 100.0 * float(ctx["cr_accept"].mean())
