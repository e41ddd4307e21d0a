"""The plain reference of one Gibbs iteration of the flagship samplers.

For one dataset (the benchmark's own maps, mask, beam and noise level) it
forms, in plain torch and float64, the masked-sky posterior of (E, B) alm
and binned D_ell,

    log p(s, D | d) = -1/2 s^T C(D)^-1 s + LL(B s),
    LL(u) = -1/2 (d - A u)^T N^-1 (d - A u)
          = -c0/2 + <c1, u> - g/2 |u|^2 + 1/2 sum_p w_p (d_p - (A u)_p)^2

with N^-1 = tau q per pixel (tau = mask / sigma^2, q the pixel's area over
the mean), tau_bar = max tau, c0 = sum tau_bar q d^2, c1 = A^T (tau_bar q d),
g = tau_bar / omega and w_p = q_p (tau_bar - tau_p) on the masked pixels.
On the Gauss-Legendre grid the three first terms are exactly the unmasked
sky's; on HEALPix they are the approximation the sampler defines (its
quadrature is not exact), and the last sum runs over every masked pixel.

One iteration, with every random variate given:

- the CR step "aux then MALA" (n_gibbs 1): an auxiliary pixel field
  v = gap (A B s) + sqrt(gap) xi on the measured program's declared
  auxiliary pixels (its cut rings, and with a floor + hole split its hole
  points; the gaps recomputed here from w), then
  s = Sigma (B A^T v + B A^T N^-1 d) + sqrt(Sigma) xi_0 with
  Sigma = (C^-1 + tau_bar / omega b_l^2)^-1; then one MALA move with
  the same Sigma as preconditioner, step tau, its gradient by autograd and
  its log-ratio as the difference of float64 totals;
- the conjugate draw D_bin = sum_{l in bin} l (l+1) sum_m |s_lm|^2 /
  (4 pi) / gamma_bin;
- whiten, then the blocked Metropolis step on D in the non-centered
  parametrization (truncated-normal proposals by the inverse-CDF recipe,
  blocks in order, each accepted on LL's change plus the proposal
  pair's truncation terms), then recenter.

``follow``: the measured program's outputs of the same iteration.  Each
accept decision the program took the other way is recorded with the
reference's margin |log-ratio - log u| and then followed; where the
program accepted a proposal, the proposal is judged (by its relative
error, or where D is near 0 in units of the proposal scale by its
inverse-CDF image against u, whichever is better conditioned) and then
followed.  So a near tie that float32 rounding tips is told apart from a
wrong decision, and neither a large D over a small proposal scale nor the
inverse CDF's steep tail blows up the comparison.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .sphere import FullRings, PointRings, state_valid
from ..inputs import cl_factor, sky_adjoint

__all__ = ["Posterior", "StructureMismatch"]


class StructureMismatch(ValueError):
    """The program's declared auxiliary pixels do not cover the mask."""


def _group_points(pix, pixels):
    """(theta (R,), phi (R, P), valid (R, P), flat index (R, P)) of pixel
    indices grouped by ring and padded."""
    ring = pix.ring_of_pixel()[pixels]
    phi = pix.phi_of_pixel()[pixels]
    rows, counts = np.unique(ring, return_counts=True)
    P = int(counts.max())
    ph = np.zeros((rows.size, P))
    va = np.zeros((rows.size, P))
    idx = np.zeros((rows.size, P), dtype=np.int64)
    for k, r in enumerate(rows):
        sel = ring == r
        c = int(sel.sum())
        ph[k, :c], va[k, :c], idx[k, :c] = phi[sel], 1.0, pixels[sel]
    return pix.theta[rows], ph, va, idx


class Posterior:
    """The reference posterior of one dataset.

    cfg: the configuration (lmax, sigma2, bins, blocks, proposal scales);
    pix, mask (npix,), d (2, npix) and bl (L,): the benchmark's inputs;
    aux: the program's declared auxiliary pixels, {"cut": (theta, nphi,
    phi0) of its cut rings, "sp": (theta (R,), phi (R, P), valid (R, P)) of
    its hole points or None}.  ``dtype`` / ``tf32``: float64 for the
    reference, float32 with TF32 products for the control."""

    def __init__(self, cfg, pix, mask, d, bl, aux, device,
                 dtype=torch.float64, tf32: bool = False):
        self.lmax = lmax = cfg["lmax"]
        L = lmax + 1
        self.dtype, self.device = dtype, torch.device(device)
        self.bins = [np.asarray(b, np.int64) for b in cfg["bins"]]
        self.blocks = [[tuple(b) for b in bl_f] for bl_f in cfg["blocks"]]
        self.sigma = [np.asarray(s, np.float64) for s in cfg["prop_sigma"]]
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        d = torch.as_tensor(d, dtype=torch.float64).cpu().numpy()
        ring = pix.ring_of_pixel()
        qp = pix.q[ring]
        tau = mask / cfg["sigma2"]
        tau_bar = float(tau.max())
        w = qp * (tau_bar - tau)
        w[w <= 1e-12 * tau_bar] = 0.0
        self.g = tau_bar / pix.omega
        d64 = torch.as_tensor(d, device=self.device)
        n0 = torch.as_tensor(tau_bar * qp, device=self.device)
        ninv = torch.as_tensor(tau * qp, device=self.device)
        self.c0 = float((n0 * d64 * d64).sum())
        # the data terms in the run's precision (the control forms them in
        # its own)
        self.c1 = sky_adjoint(lmax, pix, (n0 * d64).to(dtype), dtype,
                              tf32)
        valid = state_valid(lmax, self.device)
        ell = torch.arange(L, device=self.device)
        self.opmask = t((valid * (ell >= 2)).reshape(-1).repeat(2, 1))
        self.bl = t(np.tile(np.asarray(bl, np.float64), 2 * L))
        self.bt = self.beam(sky_adjoint(lmax, pix, (ninv * d64).to(dtype),
                                        dtype, tf32))
        self.valid = t(valid.reshape(-1).repeat(2, 1))
        self.clf = t(cl_factor(lmax))
        # the likelihood's masked pixels: whole rings, and the rest as points
        masked = w > 0
        nmasked = np.bincount(ring, weights=masked, minlength=pix.theta.size)
        full = np.nonzero(nmasked == pix.nphi)[0]
        self.like = []
        if full.size:
            rs = FullRings(lmax, pix.theta[full], pix.nphi[full],
                           pix.phi0[full], self.device, dtype, tf32)
            px = np.concatenate([pix.start[r] + np.arange(pix.nphi[r])
                                 for r in full])
            self.like.append((rs, t(w[px]), t(d[:, px])))
        rest = np.nonzero(masked & ~np.isin(ring, full))[0]
        if rest.size:
            th, ph, va, idx = _group_points(pix, rest)
            rs = PointRings(lmax, th, ph, va, self.device, dtype, tf32)
            self.like.append((rs, t(w[idx] * va), t(d[:, idx] * va)))
        self.aux = self._aux_parts(pix, w, aux, dtype, tf32, t)

    def _aux_parts(self, pix, w, aux, dtype, tf32, t):
        """[(ring set, gap, pool kind)] of the program's declared auxiliary
        fields, the gaps from this posterior's w."""
        th, nphi, phi0 = aux["cut"]
        nphi = np.broadcast_to(np.asarray(nphi), np.shape(th))
        first = pix.locate(th, phi0)
        rings = pix.ring_of_pixel()[first]
        cut_px = np.concatenate([pix.start[r] + np.arange(pix.nphi[r])
                                 for r in rings])
        if np.any(pix.nphi[rings] != nphi):
            raise StructureMismatch("cut rings' lengths differ")
        cover = np.zeros_like(w)
        parts = []
        rs = FullRings(self.lmax, pix.theta[rings], pix.nphi[rings],
                       pix.phi0[rings], self.device, dtype, tf32)
        if aux.get("sp") is None:
            gap_cut = w[cut_px]
            floor = None
        else:
            floor = np.array([w[pix.start[r]: pix.start[r] + pix.nphi[r]]
                              .min() for r in rings])
            gap_cut = np.repeat(floor, pix.nphi[rings])
        cover[cut_px] += gap_cut
        parts.append((rs, t(gap_cut), "aux"))
        if aux.get("sp") is not None:
            sth, sph, sva = (np.asarray(a, np.float64) for a in aux["sp"])
            rr, cc = np.nonzero(sva)
            px = pix.locate(sth[rr], sph[rr, cc])
            if np.unique(px).size != px.size:
                raise StructureMismatch("a hole point is declared twice")
            fl = np.zeros(pix.theta.size)
            fl[rings] = floor
            gap = np.zeros(sva.shape)
            gap[rr, cc] = np.maximum(w[px] - fl[pix.ring_of_pixel()[px]],
                                     0.0)
            cover[px] += gap[rr, cc]
            parts.append((PointRings(self.lmax, sth, sph, sva, self.device,
                                     dtype, tf32), t(gap), "sp"))
        if np.abs(cover - w).max() > 1e-9 * max(w.max(), 1.0):
            raise StructureMismatch("the declared auxiliary pixels do not "
                                    "cover the masked pixels' weights")
        return parts

    # -- state algebra -----------------------------------------------------

    def beam(self, x):
        return x * self.bl

    def var_of(self, dl):
        """Per-field binned D (n, nb_f) -> (n, 2, nstate) prior variance."""
        L = self.lmax + 1
        out = []
        for f, (e, dl_f) in enumerate(zip(self.bins, dl)):
            per_l = torch.zeros(dl_f.shape[:-1] + (L,), dtype=self.dtype,
                                device=self.device)
            lo, hi = int(e[0]), int(e[-1])
            idx = torch.as_tensor(np.repeat(np.arange(e.size - 1),
                                            np.diff(e)), device=self.device)
            per_l[..., lo:hi] = dl_f.to(self.dtype)[..., idx]
            cl = per_l * self.clf
            out.append(cl.tile((2 * L,)) * self.valid[f])
        return torch.stack(out, dim=-2)

    def loglike(self, x):
        """LL(B x), one float64 value per chain."""
        u = self.beam(x) * self.opmask
        f64 = torch.float64
        # the terms in the run's precision, their sums in float64
        out = (-0.5 * self.c0 + (self.c1 * u).to(f64).sum((-2, -1))
               - 0.5 * self.g * (u * u).to(f64).sum((-2, -1)))
        for rs, w, d in self.like:
            r = d - rs.synth(u)
            out = out + 0.5 * (w * r * r).to(f64).flatten(1).sum(-1)
        return out

    def _logp_grad(self, x, inv_cvar, act):
        """(log target per chain, its gradient on the active slots)."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = (-0.5 * (inv_cvar * x * x).to(torch.float64).sum((-2, -1))
                  + self.loglike(x))
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g * act

    # -- one iteration -----------------------------------------------------

    def cr_step(self, s_in, var, pool, u, tau=0.02, follow=None):
        """aux then MALA; returns (s, accept, per-chain flip margin)."""
        dt = self.dtype
        act = (var > 0).to(dt)
        inv_cvar = torch.where(var > 0, 1.0 / torch.where(var > 0, var, 1.0),
                               0.0)
        hd = self.g * self.bl * self.bl
        sigma = act / (inv_cvar + hd)
        s = s_in.to(dt) * act
        xi = pool["state"].to(dt)
        proj = 0.0
        for rs, gap, kind in self.aux:
            noise = pool[kind][:, 0].to(dt)
            if rs.out_ndim == 2:
                noise = noise.reshape(noise.shape[:2] + (-1,))
            v = gap * rs.synth(self.beam(s)) + torch.sqrt(gap) * noise
            proj = proj + rs.adjoint(v)
        s = sigma * (self.beam(proj) + self.bt) + torch.sqrt(sigma) * xi[:, 0]
        lp_s, g_s = self._logp_grad(s, inv_cvar, act)
        s_prop = (s + tau * sigma * g_s
                  + torch.sqrt(2.0 * tau * sigma) * xi[:, 1])
        lp_p, g_p = self._logp_grad(s_prop, inv_cvar, act)
        inv_step = torch.where(act > 0, 1.0 / torch.where(
            act > 0, 2.0 * tau * sigma, 1.0), 0.0)

        def logq(to, frm, g_frm):
            r = to - frm - tau * sigma * g_frm
            return -0.5 * (inv_step * r * r).to(torch.float64).sum((-2, -1))

        lr = lp_p - lp_s + logq(s, s_prop, g_p) - logq(s_prop, s, g_s)
        log_u = torch.log(u.to(torch.float64))
        acc_ref = log_u < lr
        acc, margin = _follow(acc_ref, lr, log_u, follow)
        s_out = torch.where(acc[:, None, None], s_prop, s)
        return s_out, acc, margin

    def conjugate(self, s, gammas):
        """Per-field binned D from the centered state and gamma variates."""
        L = self.lmax + 1
        sq = (s.to(self.dtype) ** 2).reshape(s.shape[:-1] + (2, L, L)).sum(
            (-3, -2))                                          # (n, 2, L)
        ell = torch.arange(L, dtype=self.dtype, device=self.device)
        beta_l = ell * (ell + 1.0) * sq / (4.0 * math.pi)
        out = []
        for f, e in enumerate(self.bins):
            seg = torch.zeros((L, e.size - 1), dtype=self.dtype,
                              device=self.device)
            for b in range(e.size - 1):
                seg[int(e[b]): int(e[b + 1]), b] = 1.0
            out.append((beta_l[:, f] @ seg) / gammas[f].to(self.dtype))
        return tuple(out)

    def whiten(self, s, dl):
        var = self.var_of(dl)
        return s * torch.where(var > 0, 1.0 / torch.sqrt(
            torch.where(var > 0, var, 1.0)), 0.0)

    def recenter(self, s_nc, dl):
        return torch.sqrt(self.var_of(dl)) * s_nc

    def mh_step(self, dl, s_nc, u_prop, u_acc, follow=None):
        """The blocked MH sweep.  ``follow``: (program's final dl tuple,
        its per-block accepts (n, nblocks)).  Returns (dl tuple, accepts
        (n, nblocks), numbers)."""
        dt = self.dtype
        sizes = [e.size - 1 for e in self.bins]
        offs = np.concatenate([[0], np.cumsum(sizes)])
        x = torch.cat([d.to(dt) for d in dl], dim=-1)
        sig = torch.as_tensor(np.concatenate(self.sigma), dtype=dt,
                              device=self.device)
        up = u_prop[:, 0].to(dt)
        lower = -x / sig
        a = torch.special.erf(lower / math.sqrt(2.0))
        v = torch.maximum(a, up * (1.0 - a) + a)
        z = torch.maximum(math.sqrt(2.0) * torch.special.erfinv(v), lower)
        props = x + sig * z
        log_u = torch.log(u_acc[:, 0].to(dt))
        zero = torch.zeros(x.shape[0], dtype=torch.float64,
                           device=self.device)
        nums = {"flip_margin": zero, "prop_err": zero, "dl_err": zero}
        if follow is not None:
            fin = torch.cat([d.to(dt) for d in follow[0]], dim=-1)
            facc = follow[1] > 0.5
        split = lambda vec: tuple(vec[:, offs[f]: offs[f + 1]]
                                  for f in range(len(sizes)))
        ll = self.loglike(torch.sqrt(self.var_of(split(x))) * s_nc)
        accs = []
        b = 0
        for f, blocks in enumerate(self.blocks):
            for lo, hi in blocks:
                gi = slice(int(offs[f] + lo), int(offs[f] + hi))
                cand_b = props[:, gi]
                if follow is not None:
                    took = facc[:, b]
                    cand_b = torch.where(took[:, None], fin[:, gi], cand_b)
                    # an accepted proposal, judged in the better conditioned
                    # of two spaces: its relative error, or its inverse-CDF
                    # image against u (where D is near 0 in units of sigma)
                    f_b = fin[:, gi]
                    rel_p = ((f_b - props[:, gi]).abs()
                             / props[:, gi].abs().clamp_min(1e-300))
                    zp = (f_b - x[:, gi]) / sig[gi]
                    ui = ((torch.special.erf(zp / math.sqrt(2.0)) - a[:, gi])
                          / (1.0 - a[:, gi]))
                    err = torch.minimum(rel_p,
                                        (ui - up[:, gi]).abs()).amax(-1)
                    nums["prop_err"] = torch.maximum(
                        nums["prop_err"], torch.where(took, err, 0.0))
                    rel = ((fin[:, gi] - x[:, gi]).abs()
                           / x[:, gi].abs().clamp_min(1e-300)).amax(-1)
                    nums["dl_err"] = torch.maximum(
                        nums["dl_err"], torch.where(took, 0.0, rel))
                cand = x.clone()
                cand[:, gi] = cand_b
                ll_c = self.loglike(torch.sqrt(self.var_of(split(cand)))
                                    * s_nc)
                qc = (torch.special.log_ndtr(x[:, gi] / sig[gi])
                      - torch.special.log_ndtr(cand_b / sig[gi])).sum(-1)
                delta = ll_c - ll + qc
                acc_ref = log_u[:, b] < delta
                acc, margin = _follow(acc_ref, delta, log_u[:, b],
                                      None if follow is None else facc[:, b])
                if follow is not None:
                    nums["flip_margin"] = torch.maximum(nums["flip_margin"],
                                                        margin)
                x = torch.where(acc[:, None], cand, x)
                ll = torch.where(acc, ll_c, ll)
                accs.append(acc)
                b += 1
        return split(x), torch.stack(accs, dim=-1), nums


def _follow(acc_ref, lr, log_u, follow):
    """(decisions to take, per chain the reference's margin |log-ratio -
    log u| where the program decided the other way, else 0)."""
    if follow is None:
        return acc_ref, torch.zeros_like(lr)
    follow = follow.to(torch.bool)
    margin = torch.where(follow != acc_ref, (lr - log_u).abs(), 0.0)
    return follow, margin
