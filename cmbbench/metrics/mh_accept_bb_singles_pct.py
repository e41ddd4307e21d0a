"""mh_accept_bb_singles_pct: the accept rate of the BB single-bin MH
blocks over the window's iterations and chains (nothing without MH)."""

import numpy as np


def read(ctx):
    mh = ctx.get("mh_accept")
    if mh is None:
        return None
    singles = [i for i, (lo, hi) in enumerate(ctx["cfg"]["blocks"][-1])
               if hi - lo == 1]
    if not singles:
        return None
    return 100.0 * float(np.asarray(mh[-1])[..., singles].mean())
