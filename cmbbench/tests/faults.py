"""Faults planted under the timed path by the CPU tests: each breaks what
one step returns, as a fault of the program would, and the run's check
has to read ``correct`` false."""

import torch


def _unchanged(it, state, new, info):
    """The step returns the state it was given."""
    info = dict(info, dl=state.dl)
    return state, info


def _half_batch(it, state, new, info):
    """Half of the chains are left out: they keep their old state."""
    n = new.s.shape[0] // 2
    s = new.s.clone()
    s[:n] = state.s[:n]
    dl = tuple(torch.cat([o[:n], d[n:]]) for o, d in zip(state.dl, new.dl))
    return type(new)(s=s, dl=dl), dict(info, dl=dl)


def _altered(it, state, new, info):
    """One answer altered where it is produced: one chain's D of one bin
    off by a thousandth."""
    dl = [d.clone() for d in new.dl]
    dl[1][0, 3] *= 1.001
    dl = tuple(dl)
    return type(new)(s=new.s, dl=dl), dict(info, dl=dl)


def _flipped(it, state, new, info):
    """One accept decision reported the other way round."""
    acc = info["cr_accept"].clone()
    acc[0] = 1.0 - acc[0]
    return new, dict(info, cr_accept=acc)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered, "flipped": _flipped}
