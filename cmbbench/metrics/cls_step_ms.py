"""cls_step_ms: the D_ell step alone (conjugate draw, and with a blocked
MH step whitening, the MH engine and recentering), fenced, least of three
(step_phase_times "cls")."""


def read(ctx):
    ph = ctx.get("phase_s")
    return None if ph is None else 1e3 * ph["cls"]
