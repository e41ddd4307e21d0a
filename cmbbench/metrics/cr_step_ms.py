"""cr_step_ms: the CR step alone over the chain batch, fenced, least of
three (the package's diagnostics.timing.step_phase_times "cr")."""


def read(ctx):
    ph = ctx.get("phase_s")
    return None if ph is None else 1e3 * ph["cr"]
