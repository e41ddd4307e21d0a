"""Plain spin-2 spherical harmonics on rings of sample points.

This is the benchmark's own synthesis, written from the textbook formulas
and independent of the measured package: the orthonormal associated
Legendre functions by the standard upward recurrence in l, the spin-2
functions from them by the closed forms of Zaldarriaga & Seljak (1997)
(F1 and F2; +2 lambda = F1 - F2, -2 lambda = F1 + F2), and the azimuthal
sums as plain products with cos / sin matrices.  The transpose of the
synthesis is taken by autograd, so it is exact by construction.

State layout (the measured package's documented interface, its
``harmonics.gridstate``): a field's alm state is a real vector of
2 (lmax+1)^2 slots, reshaped (2, L, L) [part, m, l]: part 0 holds a_l0
(m = 0) and sqrt(2) Re a_lm (m > 0), part 1 sqrt(2) Im a_lm (m > 0);
slots with l < m, and part 1 at m = 0, are 0.  (E, B) alm give
Q + iU = sum_lm a+_lm 2Y_lm with a+ = -(E + iB), a- = -(E - iB).

``tf32=True`` rounds both operands of every product to TF32 (10 explicit
mantissa bits) before a float32 product: the control of the benchmark's
correctness check, a precision one step below the configuration's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["lambda_table", "spin2_tables", "FullRings", "PointRings",
           "round_tf32", "state_valid", "symmetric_rings"]


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to nearest TF32 (13 low bits cleared); the
    gradient passes through unchanged."""
    i = t.detach().contiguous().view(torch.int32)
    i = (i + 0x1000 + ((i >> 13) & 1)) & ~0x1FFF
    r = i.view(torch.float32)
    return t + (r - t.detach()) if t.requires_grad else r


def state_valid(lmax: int, device, dtype=torch.float64) -> torch.Tensor:
    """(2, L, L) 1 on the valid state slots of one field."""
    L = lmax + 1
    m = torch.arange(L, device=device)[:, None]
    l = torch.arange(L, device=device)[None, :]
    tri = (l >= m)
    return torch.stack([tri, tri & (m > 0)]).to(dtype)


def symmetric_rings(theta) -> bool:
    """Whether a set of colatitudes is symmetric about the equator."""
    t = np.sort(np.asarray(theta, dtype=np.float64))
    return t.size > 0 and bool(np.allclose(t, np.pi - t[::-1], rtol=0,
                                           atol=1e-9))


def lambda_table(lmax: int, x: torch.Tensor) -> torch.Tensor:
    """Orthonormal lambda_lm(x) = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) P_lm(x)
    (Condon-Shortley phase) for 0 <= m <= l <= lmax at the nodes x (R,):
    (L, L, R) [m, l, r], zero for l < m.  float64.  The seeds lambda_mm
    are formed in log space, so that sin(theta)^m underflows to 0 cleanly;
    then one recurrence step in l for every m at once."""
    x = x.to(torch.float64)
    L, R, dev = lmax + 1, x.shape[0], x.device
    s = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
    m = torch.arange(L, dtype=torch.float64, device=dev)
    k = torch.arange(1, L, dtype=torch.float64, device=dev)
    lc = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                    torch.cumsum(0.5 * torch.log((2 * k - 1) / (2 * k)), 0)])
    logc = 0.5 * torch.log((2 * m + 1) / (4 * math.pi)) + lc
    logs = torch.log(torch.clamp(s, min=1e-300))
    mag = torch.exp(logc[:, None] + torch.where(
        m[:, None] == 0, 0.0, m[:, None] * logs[None, :]))
    sign = 1.0 - 2.0 * (m % 2)
    lam = torch.zeros((L, L, R), dtype=torch.float64, device=dev)
    idx = torch.arange(L, device=dev)
    p2 = sign[:, None] * mag
    lam[idx, idx] = p2
    if L == 1:
        return lam
    p1 = x[None, :] * torch.sqrt(2 * m[:, None] + 3) * p2
    lam[idx[:-1], idx[:-1] + 1] = p1[:-1]
    for d in range(2, L):
        mm = m[: L - d]
        l = mm + d
        a = torch.sqrt((4 * l * l - 1) / (l * l - mm * mm))
        b = torch.sqrt(((l - 1) ** 2 - mm * mm) / (4 * (l - 1) ** 2 - 1))
        new = a[:, None] * (x[None, :] * p1[: L - d]
                            - b[:, None] * p2[: L - d])
        p2, p1 = p1[: L - d], new
        lam[idx[: L - d], idx[: L - d] + d] = new
    return lam


def spin2_tables(lmax: int, theta: torch.Tensor) -> torch.Tensor:
    """(2, L, L, R) [sign, m, l, r] float64: +2 lambda and -2 lambda at
    colatitudes ``theta`` (no ring at a pole), 2Y_lm = (F1 - F2) e^{i m phi}
    and -2Y_lm = (F1 + F2) e^{i m phi}; zero for l < 2 and l < m."""
    x = torch.cos(theta.to(torch.float64))
    lam = lambda_table(lmax, x)
    L, dev = lmax + 1, x.device
    prev = torch.zeros_like(lam)
    prev[:, 1:] = lam[:, :-1]
    mm = torch.arange(L, dtype=torch.float64, device=dev)[:, None, None]
    ll = torch.arange(L, dtype=torch.float64, device=dev)[None, :, None]
    c = torch.where(ll >= 2, 2.0 / torch.sqrt(torch.clamp(
        (ll - 1) * ll * (ll + 1) * (ll + 2), min=1.0)), 0.0)
    a = torch.sqrt(torch.clamp((2 * ll + 1) * (ll * ll - mm * mm)
                               / (2 * ll - 1), min=0.0))
    X = x[None, None, :]
    s2 = (1.0 - x * x)[None, None, :]
    f1 = c * (-((ll - mm * mm) / s2 + 0.5 * ll * (ll - 1)) * lam
              + a * X / s2 * prev)
    f2 = c * mm / s2 * ((ll - 1) * X * lam - a * prev)
    del lam, prev
    return torch.stack([f1 - f2, f1 + f2])


class _Rings:
    """The Legendre stage shared by the two kinds of ring sets: (E, B)
    states -> the ring Fourier coefficients of Q and U, as cosine and sine
    coefficient arrays (n, 2 [Q, U], R, M)."""

    def _init_rings(self, lmax, theta, device, dtype, tf32, tab=None):
        self.lmax, self.dtype, self.tf32 = lmax, dtype, tf32
        self.device = torch.device(device)
        self.theta = np.asarray(theta, dtype=np.float64)
        if tab is None:
            tab = spin2_tables(lmax, torch.as_tensor(
                self.theta, dtype=torch.float64, device=self.device))
        self.tab = tab.to(dtype)
        L = lmax + 1
        m = torch.arange(L, dtype=torch.float64, device=self.device)
        self.pos = (m > 0).to(dtype)
        scale = torch.where(m > 0, m * 0.0 + 1.0 / math.sqrt(2.0),
                            m * 0.0 + 1.0)
        self.unpack = (state_valid(lmax, self.device) * scale[None, :, None]
                       ).to(dtype)
        return m

    def _mm(self, a, b):
        if self.tf32:
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)

    def _coefs(self, x, rot=None):
        L = self.lmax + 1
        batch = x.shape[:-2]
        n = math.prod(batch)
        g = x.to(self.dtype).reshape((n, 2, 2, L, L)) * self.unpack
        e_re, e_im = g[:, 0, 0], g[:, 0, 1]
        b_re, b_im = g[:, 1, 0], g[:, 1, 1]
        # a+ = -(E + iB), a- = -(E - iB): (2 signs, M, n * 2 parts, L)
        a = torch.stack([torch.stack([-(e_re - b_im), -(e_im + b_re)]),
                         torch.stack([-(e_re + b_im), -(e_im - b_re)])])
        a = a.permute(0, 3, 2, 1, 4).reshape(2, L, n * 2, L)
        F = self._mm(a, self.tab)                          # (2, M, n2, R)
        F = F.reshape(2, L, n, 2, -1).permute(2, 0, 3, 4, 1)
        fa, fb = F[:, 0, 0], F[:, 0, 1]       # F+ = fa + i fb, (n, R, M)
        fc, fd = F[:, 1, 0], F[:, 1, 1]       # F- = fc + i fd
        if rot is not None:
            c, s = rot
            fa, fb = fa * c - fb * s, fa * s + fb * c
            fc, fd = fc * c - fd * s, fc * s + fd * c
        pos = self.pos
        # Q = sum (a + c) cos - (b + d) sin, U = sum (b - d) cos + (a - c)
        # sin: Q + iU = sum F+ e^{i m phi} + sum_{m > 0} conj(F-) e^{-i m phi}
        cs = torch.stack([fa + pos * fc, fb - pos * fd], dim=1)
        sn = torch.stack([-(fb + pos * fd), fa - pos * fc], dim=1)
        return batch, n, cs, sn

    def adjoint(self, y: torch.Tensor) -> torch.Tensor:
        """A^T y for values ``y`` shaped as ``synth``'s output: the exact
        transpose of ``synth`` (autograd), (..., 2, nstate)."""
        L = self.lmax + 1
        batch = y.shape[: y.ndim - self.out_ndim]
        x = torch.zeros(tuple(batch) + (2, 2 * L * L), dtype=self.dtype,
                        device=self.device, requires_grad=True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad((self.synth(x) * y).sum(), x)
        return g


class FullRings(_Rings):
    """Whole iso-latitude rings: colatitudes ``theta`` (R,), ring lengths
    ``nphi`` (one or per ring) and first-pixel azimuths ``phi0`` (R,).
    ``synth(x)``: (..., 2, nstate) (E, B) states -> (..., 2, npix) (Q, U)
    on the rings' pixels, ring after ring, j = 0..nphi_r - 1 at
    phi0_r + 2 pi j / nphi_r."""

    out_ndim = 2

    def __init__(self, lmax: int, theta, nphi, phi0, device,
                 dtype=torch.float64, tf32: bool = False, tab=None):
        m = self._init_rings(lmax, theta, device, dtype, tf32, tab)
        R = self.theta.size
        self.nphi = np.broadcast_to(np.asarray(nphi, np.int64), (R,)).copy()
        ph0 = torch.as_tensor(np.broadcast_to(
            np.asarray(phi0, np.float64), (R,)).copy(), device=self.device)
        ang0 = ph0[:, None] * m[None, :]                       # (R, M)
        self.rot = (torch.cos(ang0).to(dtype), torch.sin(ang0).to(dtype))
        self.groups = []
        for n in np.unique(self.nphi):
            rows = np.nonzero(self.nphi == n)[0]
            ang = m[:, None] * (2 * math.pi / float(n)) * torch.arange(
                int(n), dtype=torch.float64, device=self.device)[None, :]
            self.groups.append((torch.as_tensor(rows, device=self.device),
                                torch.cos(ang).to(dtype),
                                torch.sin(ang).to(dtype)))
        self.npix = int(self.nphi.sum())
        # where each ring's pixels start in the flat output
        self.start = np.concatenate([[0], np.cumsum(self.nphi)[:-1]])

    def synth(self, x: torch.Tensor) -> torch.Tensor:
        batch, n, cs, sn = self._coefs(x, self.rot)
        if len(self.groups) == 1:
            _, cos, sin = self.groups[0]
            out = self._mm(cs, cos) + self._mm(sn, sin)      # (n, 2, R, P)
            return out.reshape(batch + (2, self.npix))
        parts = []
        for rows, cos, sin in self.groups:
            parts.append((self._mm(cs[:, :, rows], cos)
                          + self._mm(sn[:, :, rows], sin)).reshape(n, 2, -1))
        # the groups' pixels back in ring order
        order = np.concatenate([
            (self.start[rows.cpu().numpy()][:, None]
             + np.arange(self.nphi[rows.cpu().numpy()[0]])[None, :]
             ).reshape(-1) for rows, _, _ in self.groups])
        out = torch.empty((n, 2, self.npix), dtype=parts[0].dtype,
                          device=self.device)
        out[:, :, torch.as_tensor(order, device=self.device)] = torch.cat(
            parts, dim=-1)
        return out.reshape(batch + (2, self.npix))


class PointRings(_Rings):
    """Points grouped by ring and padded to a rectangle: colatitudes
    ``theta`` (R,), absolute azimuths ``phi`` (R, P) and ``valid`` (R, P)
    (0 on padding).  ``synth(x)``: (..., 2, nstate) -> (..., 2, R, P)."""

    out_ndim = 3

    def __init__(self, lmax: int, theta, phi, valid, device,
                 dtype=torch.float64, tf32: bool = False, tab=None):
        m = self._init_rings(lmax, theta, device, dtype, tf32, tab)
        ph = torch.as_tensor(np.asarray(phi, np.float64), device=self.device)
        ang = m[None, :, None] * ph[:, None, :]                # (R, M, P)
        self.cos = torch.cos(ang).to(dtype)
        self.sin = torch.sin(ang).to(dtype)
        self.valid = torch.as_tensor(np.asarray(valid, np.float64),
                                     dtype=dtype, device=self.device)

    def synth(self, x: torch.Tensor) -> torch.Tensor:
        batch, n, cs, sn = self._coefs(x)
        R, M = cs.shape[-2:]
        per_ring = lambda t: t.permute(2, 0, 1, 3).reshape(R, n * 2, M)
        out = (self._mm(per_ring(cs), self.cos)
               + self._mm(per_ring(sn), self.sin))           # (R, n2, P)
        out = out.reshape(R, n, 2, -1).permute(1, 2, 0, 3) * self.valid
        return out.reshape(batch + out.shape[1:])
