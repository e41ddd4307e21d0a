"""Judging a run's outputs against the reference, chains in blocks.

A check is one step the run took, with everything it was given and what
the measured program returned: the start (one CR draw from the simulated
sky's state at its D_ell) or one Gibbs iteration.  The reference repeats the step
from the same inputs and variates (``posterior.Posterior``), following the
program's accept decisions and accepted proposals, and reads four numbers
per chain:

- ``state_err``: |s_program - s_reference| / |s_reference| after the step;
- ``dl_err``: the largest relative error of a D_ell bin the step drew by
  the conjugate draw and kept (centered, or ASIS where MH rejected);
- ``prop_err``: the largest error of an accepted MH proposal: the lesser
  of its relative error and |u_implied - u|, u_implied the reference's
  inverse-CDF image of the program's value;
- ``flip_margin``: the largest |log-ratio - log u| of an accept decision
  the program took the other way (0 where none).

The control is the reference itself in float32 with TF32 products, run in
the program's place (``control_outputs``) and judged the same way.
"""

from __future__ import annotations

import torch

__all__ = ["NUMBERS", "judge", "control_outputs"]

NUMBERS = ("state_err", "dl_err", "prop_err", "flip_margin")


def _sl(x, sl):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: v[sl] for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(v[sl] for v in x)
    return x[sl]


def _step(post, kind, check, sl, tau, follow):
    """The reference's step on chains ``sl``: (s, dl, cr accepts, mh
    accepts or None, numbers per chain)."""
    v = check["variates"]
    dev = post.device
    to = lambda t: None if t is None else t.to(dev)
    dl_in = tuple(to(d) for d in _sl(check["dl_in"], sl))
    s_in = to(_sl(check["s_in"], sl))
    pool = {k: to(t) for k, t in _sl(v["pool"], sl).items()}
    out = follow
    var = post.var_of(dl_in)
    s, cr_acc, margin = post.cr_step(
        s_in, var, pool, to(v["u"][sl]), tau,
        None if out is None else to(out["cr_acc"][sl]))
    n = s.shape[0]
    zero = torch.zeros(n, dtype=torch.float64, device=dev)
    nums = {"flip_margin": margin.to(torch.float64), "dl_err": zero,
            "prop_err": zero}
    if check["what"] == "start":
        return s, dl_in, cr_acc, None, nums
    dl_c = post.conjugate(s, tuple(to(g) for g in _sl(v["gammas"], sl)))
    if kind == "centered":
        if out is not None:
            rel = torch.stack([((to(a[sl]).to(torch.float64)
                                 - b.to(torch.float64)).abs()
                                / b.to(torch.float64).abs()
                                .clamp_min(1e-300)).amax(-1)
                               for a, b in zip(out["dl"], dl_c)]).amax(0)
            nums["dl_err"] = rel
        return s, dl_c, cr_acc, None, nums
    s_nc = post.whiten(s, dl_c)
    fol = None if out is None else (
        tuple(to(d[sl]) for d in out["dl"]),
        torch.cat([to(a[sl]) for a in out["mh_acc"]], dim=-1))
    dl, mh_acc, mh_nums = post.mh_step(dl_c, s_nc, to(v["u_prop"][sl]),
                                       to(v["u_acc"][sl]), fol)
    nums["flip_margin"] = torch.maximum(nums["flip_margin"],
                                        mh_nums["flip_margin"])
    nums["dl_err"], nums["prop_err"] = mh_nums["dl_err"], mh_nums["prop_err"]
    return post.recenter(s_nc, dl), dl, cr_acc, mh_acc, nums


def judge(post, kind: str, checks, tau: float, chunk: int = 64) -> dict:
    """{number: per-chain values over every check, concatenated}."""
    out = {k: [] for k in NUMBERS}
    for check in checks:
        n = check["s_out"].shape[0]
        for c0 in range(0, n, chunk):
            sl = slice(c0, min(n, c0 + chunk))
            follow = {"cr_acc": check["cr_acc"], "dl": check["dl_out"],
                      "mh_acc": check.get("mh_acc")}
            s_ref, _, _, _, nums = _step(post, kind, check, sl, tau, follow)
            s_p = check["s_out"][sl].to(post.device, torch.float64)
            s_ref = s_ref.to(torch.float64)
            nums["state_err"] = ((s_p - s_ref).flatten(1).norm(dim=-1)
                                 / s_ref.flatten(1).norm(dim=-1)
                                 .clamp_min(1e-300))
            for k in NUMBERS:
                out[k].append(nums[k].cpu())
            del s_ref, s_p, nums
    return {k: torch.cat(v) for k, v in out.items()}


def control_outputs(ctrl, kind: str, check, tau: float,
                    chunk: int = 64) -> dict:
    """The control's outputs of one check, in the program's form."""
    n = check["s_in"].shape[0]
    res = {"s_out": [], "cr_acc": [], "dl_out": [], "mh_acc": []}
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        s, dl, cr_acc, mh_acc, _ = _step(ctrl, kind, check, sl, tau, None)
        res["s_out"].append(s.float().cpu())
        res["cr_acc"].append(cr_acc.float().cpu())
        res["dl_out"].append(tuple(d.float().cpu() for d in dl))
        if mh_acc is not None:
            res["mh_acc"].append(mh_acc.float().cpu())
    out = dict(check)
    out["s_out"] = torch.cat(res["s_out"])
    out["cr_acc"] = torch.cat(res["cr_acc"])
    out["dl_out"] = tuple(torch.cat(p) for p in zip(*res["dl_out"]))
    if res["mh_acc"]:
        acc = torch.cat(res["mh_acc"])
        sizes = [len(b) for b in ctrl.blocks]
        out["mh_acc"] = tuple(torch.split(acc, sizes, dim=-1))
    return out
