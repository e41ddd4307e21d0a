"""HEALPix-grid spherical-harmonic transforms (PyTorch counterpart of
``gibbssampler_tpu.sht.healpix``).

Maps are flat pixel vectors in HEALPix RING order (``layout="ring"``) or in
the internal padded section layout (``layout="padded"``).  The ring
geometry, the padded layout and the cap width classes are numpy, built on
the host; the transform's tables live on the device.

- The Legendre stage is the port's ``LegendreCore`` (the hand-written
  kernels) over all 4 nside - 1 rings.
- The azimuthal stage is plain ``torch`` products:
  - equatorial-belt rings share one *folded* DFT matrix (the reflection
    j <-> nb - j halves it), with each ring's first-pixel offset phi0
    applied as a rotation of its Fourier coefficients;
  - polar-cap ring i (4i pixels, half-pixel offset) is folded over
    j <-> 4i - 1 - j; the rings are grouped into width classes padded to a
    common half-width, and each north ring shares its class table with its
    southern mirror by reordering the rows of F, not the tables.

In the padded layout the padding slots are in the exact null space of A and
A^T (the padded table columns are zero), so the samplers run unchanged as
long as the noise carries inv-noise 0 on padding
(``NoiseModel.white_healpix(sht=...)``).  ``to_ring`` / ``from_ring``
convert at the boundaries and ``valid`` marks the real pixels.

Analysis is the pixel-area-scaled adjoint (healpy's iter=0 map2alm); the
adjoint itself is the exact transpose of synthesis.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .lcore import FlatAlmMethods, LegendreCore
from .legendre import legendre_table, wigner_d_table

__all__ = ["HealpixGeometry", "healpix_geometry", "HealpixLayout",
           "healpix_layout", "HealpixSHT", "make_healpix_sht"]


@dataclass(frozen=True)
class HealpixGeometry:
    nside: int
    theta: np.ndarray      # (nrings,) ring colatitudes, north -> south
    nphi: np.ndarray       # (nrings,) pixels per ring
    phi0: np.ndarray       # (nrings,) first-pixel longitude
    ring_start: np.ndarray  # (nrings,) RING-order offset of each ring

    @property
    def npix(self) -> int:
        return 12 * self.nside * self.nside

    @property
    def nrings(self) -> int:
        return self.theta.shape[0]

    @property
    def pixel_area(self) -> float:
        return 4.0 * np.pi / self.npix

    def __hash__(self):
        return hash(("healpix", self.nside))

    def __eq__(self, other):
        return isinstance(other, HealpixGeometry) and self.nside == other.nside


@functools.lru_cache(maxsize=None)
def healpix_geometry(nside: int) -> HealpixGeometry:
    """RING-scheme ring table for one nside."""
    assert nside >= 1
    rings = np.arange(1, 4 * nside)
    z = np.empty(rings.shape)
    nphi = np.empty(rings.shape, dtype=np.int64)
    phi0 = np.empty(rings.shape)
    for idx, i in enumerate(rings):
        if i < nside:                       # north cap
            z[idx] = 1.0 - (i * i) / (3.0 * nside * nside)
            nphi[idx] = 4 * i
            phi0[idx] = np.pi / (4.0 * i)
        elif i <= 3 * nside:                # equatorial belt
            z[idx] = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
            nphi[idx] = 4 * nside
            s = (i - nside + 1) % 2
            phi0[idx] = s * np.pi / (4.0 * nside)
        else:                               # south cap
            i_m = 4 * nside - i
            z[idx] = -(1.0 - (i_m * i_m) / (3.0 * nside * nside))
            nphi[idx] = 4 * i_m
            phi0[idx] = np.pi / (4.0 * i_m)
    ring_start = np.concatenate([[0], np.cumsum(nphi)[:-1]])
    return HealpixGeometry(nside=nside, theta=np.arccos(z), nphi=nphi,
                           phi0=phi0, ring_start=ring_start)


def _cap_classes(ncap: int, lane: int = 128):
    """Group north-cap ring indices idx = 0..ncap-1 (ring i = idx+1, half
    ring width 2i) into contiguous classes padded to a common half-width
    that is a multiple of ``lane`` (capped below at a multiple of 8 for tiny
    grids).  Returns list of (idx_lo, idx_hi, w).

    ``lane`` stays at the JAX package's 128: the padded layout's offsets and
    length follow from the classes, so a padded-layout map lines up slot for
    slot with the JAX package's."""
    if ncap <= 0:
        return []
    wmax = 2 * ncap
    step = lane if wmax >= lane else max(8, -(-wmax // 8) * 8)
    classes = []
    idx_lo = 0
    w = step
    while idx_lo < ncap:
        # rings with half-width 2(idx+1) <= w  =>  idx <= w/2 - 1
        idx_hi = min(ncap, w // 2)
        classes.append((idx_lo, idx_hi, w))
        idx_lo = idx_hi
        w += step
    return classes


@dataclass(frozen=True, eq=False)
class HealpixLayout:
    """The section layout of one nside and the map layout in use (host
    arrays only, no transform tables).

    Padded section layout: [north cap class 0.. | belt | south cap class
    0..]; cap class c holds its rings as rows of width 2w, and the south-cap
    rows are stored in *north index order* (row k of class c is the mirror
    of north ring lo+k+1).  ``pix_of`` maps each RING pixel to its slot,
    ``src_of`` each slot to its RING pixel (0 on padding) and ``valid`` is
    1 on real pixels."""

    geo: HealpixGeometry
    layout: str
    cap_classes: tuple
    belt_off: int
    npadded: int
    pix_of: np.ndarray      # (npix,) padded slot of each RING pixel
    src_of: np.ndarray      # (npadded,) RING pixel of each slot
    valid: np.ndarray       # (npadded,) 1.0 on real pixels

    @property
    def nside(self) -> int:
        return self.geo.nside

    @property
    def ncap(self) -> int:
        return self.nside - 1

    @property
    def nbelt(self) -> int:
        return 2 * self.nside + 1

    @property
    def nb(self) -> int:
        """Pixels per belt ring."""
        return 4 * self.nside

    @property
    def npix_layout(self) -> int:
        """Length of the map vectors in this layout."""
        return self.npadded if self.layout == "padded" else self.geo.npix

    @property
    def layout_of_ring(self) -> np.ndarray:
        """(npix,) position of each RING pixel in this layout's maps."""
        if self.layout == "padded":
            return self.pix_of
        return np.arange(self.geo.npix)

    def cap_off(self, c: int) -> int:
        """Offset of cap class c inside the north (or south) cap section."""
        return int(sum((hi - lo) * 2 * w
                       for (lo, hi, w) in self.cap_classes[:c]))


@functools.lru_cache(maxsize=None)
def healpix_layout(nside: int, layout: str = "ring") -> HealpixLayout:
    """The padded section layout of ``nside`` (see ``HealpixLayout``)."""
    if layout not in ("ring", "padded"):
        raise ValueError(f"layout must be 'ring' or 'padded', got {layout!r}")
    geo = healpix_geometry(nside)
    ncap, nbelt, nb = nside - 1, 2 * nside + 1, 4 * nside
    classes = tuple(_cap_classes(ncap))
    cap_widths = [2 * w * (hi - lo) for (lo, hi, w) in classes]
    capn_off = np.concatenate([[0], np.cumsum(cap_widths)]).astype(np.int64)
    belt_off = int(capn_off[-1])
    caps_off = belt_off + nbelt * nb
    npadded = caps_off + int(capn_off[-1])
    nrings = geo.nrings
    pix_of = np.zeros(geo.npix, dtype=np.int64)
    src_of = np.zeros(npadded, dtype=np.int64)
    valid = np.zeros(npadded, dtype=np.float64)
    for c, (lo, hi, w) in enumerate(classes):
        for k in range(hi - lo):
            idx = lo + k
            i = idx + 1
            n_r = 4 * i
            base_n = int(capn_off[c]) + k * 2 * w
            base_s = caps_off + int(capn_off[c]) + k * 2 * w
            for base, r in ((base_n, idx), (base_s, nrings - 1 - idx)):
                start = geo.ring_start[r]
                # pixel p < 2i at row position p; p >= 2i at 2w - n_r + p
                p = np.arange(n_r)
                pos = np.where(p < 2 * i, p, 2 * w - n_r + p)
                pix_of[start + p] = base + pos
                src_of[base + pos] = start + p
                valid[base + pos] = 1.0
    for rb in range(nbelt):
        start = geo.ring_start[ncap + rb]
        base = belt_off + rb * nb
        p = np.arange(nb)
        pix_of[start + p] = base + p
        src_of[base + p] = start + p
        valid[base + p] = 1.0
    return HealpixLayout(geo=geo, layout=layout, cap_classes=classes,
                         belt_off=belt_off, npadded=npadded, pix_of=pix_of,
                         src_of=src_of, valid=valid)


class HealpixSHT(FlatAlmMethods, LegendreCore):
    """SHT on the HEALPix grid for one (nside, lmax, dtype, layout) on one
    device; the method surface of ``sht.transform.SHT`` with maps as flat
    pixel vectors (..., npix) in RING order or (..., npadded) in the padded
    section layout.

    ``table_dtype``, ``m_block`` and ``ring_split`` are ``SHT``'s options:
    the HEALPix rings mirror each other about the equator (4 nside - 1 of
    them, the equator ring alone), so ``ring_split`` holds every table over
    the 2 nside north rings."""

    map_ndim = 1   # maps are flat vectors

    def __init__(self, nside: int, lmax: int, dtype=torch.float32,
                 spin2: bool = False, layout: str = "ring", device="cuda",
                 table_dtype=None, m_block: int = 128,
                 ring_split: bool = False):
        lay = healpix_layout(nside, layout)
        geo = lay.geo
        self.lay = lay
        self.geo = geo
        self.nside = nside
        self.layout = layout
        self._init_core(lmax, geo.theta, dtype, device, table_dtype, m_block,
                        ring_split)
        L = lmax + 1
        dev = self.device
        t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a),
                                                dtype=dt, device=dev)

        # the full grid's tables are (L, L, 4 nside - 1) (2 nside rings under
        # the split): built and moved to the device one at a time, so the
        # host holds one float64 table (two for the split's W and X)
        theta_t = self._table_theta(geo.theta)
        self.lam0 = self._table(legendre_table(lmax, np.cos(theta_t)), "lam0")
        self.lam_p2 = self.lam_m2 = self.lam_w = self.lam_x = None
        if spin2:
            norm = np.sqrt((2.0 * np.arange(L) + 1.0)
                           / (4.0 * np.pi))[None, :, None]
            # (+2 Lambda, -2 Lambda) = d^l_{m,-2}, d^l_{m,+2}, normalized
            # (sht.legendre.spin2_lambda_tables, one table at a time)
            if self.ring_split:
                lp = wigner_d_table(lmax, -2, theta_t)
                lp *= norm
                lm_ = wigner_d_table(lmax, 2, theta_t)
                lm_ *= norm
                self._build_spin2_tables(lp, lm_)
                del lp, lm_
            else:
                tabs = []
                for s, name in ((-2, "lam_p2"), (2, "lam_m2")):
                    tab = wigner_d_table(lmax, s, theta_t)
                    tab *= norm
                    tabs.append(self._table(tab, name))
                    del tab
                self.lam_p2, self.lam_m2 = tabs

        self.nbelt = lay.nbelt
        self.belt_sl = slice(lay.ncap, lay.ncap + lay.nbelt)
        self.cap_classes = lay.cap_classes

        m = np.arange(L)
        # belt: folded DFT matrix (columns j = 0..nb/2 only; j and nb - j
        # combine as lo = C - S / hi = C + S) and the per-ring phi0 rotation
        nb = lay.nb
        nbh = nb // 2 + 1
        ang = 2.0 * np.pi * np.outer(m, np.arange(nbh)) / nb
        self.nb, self.nbh = nb, nbh
        self.belt_cos = self._trig(np.cos(ang))
        self.belt_sin = self._trig(np.sin(ang))
        bang = np.outer(geo.phi0[self.belt_sl], m)
        self.belt_rot_cos, self.belt_rot_sin = t(np.cos(bang)), t(np.sin(bang))

        # caps: width-classed folded tables shared by the north ring i and
        # its southern mirror; ring i's half-width is 2i and the table
        # columns j >= 2i are zero (padding is in the null space)
        cap_cos, cap_sin = [], []
        for (lo, hi, w) in self.cap_classes:
            nc = hi - lo
            Mc = np.zeros((nc, L, w))
            Ms = np.zeros((nc, L, w))
            for k in range(nc):
                i = lo + k + 1
                h = 2 * i
                a = np.outer(m, (np.pi / (2.0 * i)) * (np.arange(h) + 0.5))
                Mc[k, :, :h] = np.cos(a)
                Ms[k, :, :h] = np.sin(a)
            cap_cos.append(self._trig(Mc))
            cap_sin.append(self._trig(Ms))
        self.cap_cos = tuple(cap_cos)
        self.cap_sin = tuple(cap_sin)

        self._pix_of = t(lay.pix_of, torch.int64)
        self._src_of = t(lay.src_of, torch.int64)
        self._src_valid = t(lay.valid)
        # analysis scaling: uniform pixel area (iter=0 map2alm)
        self.pixel_area = geo.pixel_area
        self.nrings = geo.nrings

    # -- layout ------------------------------------------------------------

    @property
    def npadded(self) -> int:
        return self.lay.npadded

    @property
    def npix_layout(self) -> int:
        """Length of the map vectors this instance produces and takes."""
        return self.lay.npix_layout

    @property
    def valid(self) -> torch.Tensor:
        """(npadded,) 1.0 on real pixels, 0.0 on padding slots."""
        return self._src_valid

    def to_ring(self, padded: torch.Tensor) -> torch.Tensor:
        """Padded section layout (..., npadded) -> RING order (..., npix)."""
        return padded[..., self._pix_of]

    def from_ring(self, maps: torch.Tensor) -> torch.Tensor:
        """RING order (..., npix) -> padded layout (zeros on padding)."""
        return maps[..., self._src_of] * self._src_valid

    def _maps_out(self, padded):
        return self.to_ring(padded) if self.layout == "ring" else padded

    def _maps_in(self, maps):
        maps = maps.to(self.dtype)
        return self.from_ring(maps) if self.layout == "ring" else maps

    # -- azimuthal stage (padded section layout) ---------------------------

    def _belt_rot(self, Xre, Xim):
        c, s = self.belt_rot_cos, self.belt_rot_sin
        return Xre * c - Xim * s, Xre * s + Xim * c

    def _south_rows(self, X, lo, hi):
        """Ring Fourier rows of the southern mirrors of north-cap indices
        [lo, hi), in north index order (the mirror of idx is ring
        nr - 1 - idx)."""
        nr = self.nrings
        return X[..., nr - hi: nr - lo, :].flip(-2)

    def _cos_sin_eval(self, Xre, Xim):
        """padded (..., npadded) = sum_m Xre cos(m phi) - Xim sin(m phi)
        from (..., nrings, L) ring Fourier coefficients (rounded to the
        table dtype before each product, as in the JAX package)."""
        rnd = self._round_td
        batch = Xre.shape[:-2]
        outs_n, outs_s = [], []
        for c, (lo, hi, w) in enumerate(self.cap_classes):
            # north rows stacked with the reordered south rows: one product
            # per class reads each table once for both hemispheres
            Xr = torch.stack([Xre[..., lo:hi, :],
                              self._south_rows(Xre, lo, hi)], dim=-3)
            Xi = torch.stack([Xim[..., lo:hi, :],
                              self._south_rows(Xim, lo, hi)], dim=-3)
            C = torch.einsum("...krm,rmw->...krw", rnd(Xr),
                             self.cap_cos[c]).to(self.dtype)
            S = torch.einsum("...krm,rmw->...krw", rnd(Xi),
                             self.cap_sin[c]).to(self.dtype)
            # fold: f[j] = C_j - S_j, f[4i-1-j] = C_j + S_j (j < 2i); rows
            # are [lo | reversed(hi)] of width 2w
            row = torch.cat([C - S, (C + S).flip(-1)], dim=-1)
            outs_n.append(row[..., 0, :, :].reshape(batch + (-1,)))
            outs_s.append(row[..., 1, :, :].reshape(batch + (-1,)))
        bre, bim = self._belt_rot(Xre[..., self.belt_sl, :],
                                  Xim[..., self.belt_sl, :])
        C = torch.matmul(rnd(bre), self.belt_cos).to(self.dtype)
        S = torch.matmul(rnd(bim), self.belt_sin).to(self.dtype)
        # f[j] = lo_j (j <= nb/2), f[nb - j] = hi_j (j = 1..nb/2 - 1)
        belt = torch.cat([C - S, (C + S)[..., 1:-1].flip(-1)], dim=-1)
        return torch.cat(outs_n + [belt.reshape(batch + (-1,))] + outs_s,
                         dim=-1)

    def _cos_sin_adj(self, padded):
        """Transpose of ``_cos_sin_eval``: padded (..., npadded) -> (C, S)
        with C_rm = sum_j f cos(m phi_j), S_rm = sum_j f sin(m phi_j)
        (the folds rounded to the table dtype, as in the JAX package)."""
        rnd = self._round_td
        batch = padded.shape[:-1]
        nb = self.nb
        Cn, Sn, Cs, Ss = [], [], [], []
        for c, (lo, hi, w) in enumerate(self.cap_classes):
            nc = hi - lo
            width = nc * 2 * w
            off_n = self.lay.cap_off(c)
            off_s = self.lay.belt_off + self.nbelt * nb + off_n
            sec = torch.stack([padded[..., off_n: off_n + width],
                               padded[..., off_s: off_s + width]], dim=-2)
            rows = sec.reshape(batch + (2, nc, 2 * w))
            a = rows[..., :w]
            b = rows[..., w:].flip(-1)
            Cc = torch.einsum("...krw,rmw->...krm", rnd(a + b),
                              self.cap_cos[c]).to(self.dtype)
            Sc = torch.einsum("...krw,rmw->...krm", rnd(a - b),
                              self.cap_sin[c]).to(self.dtype)
            Cn.append(Cc[..., 0, :, :])
            Sn.append(Sc[..., 0, :, :])
            Cs.append(Cc[..., 1, :, :].flip(-2))
            Ss.append(Sc[..., 1, :, :].flip(-2))
        belt_off = self.lay.belt_off
        belt = padded[..., belt_off: belt_off
                      + self.nbelt * nb].reshape(batch + (self.nbelt, nb))
        lo_ = belt[..., : self.nbh]
        rev = belt[..., self.nbh - 1:].flip(-1)
        hi_ = F.pad(rev[..., :-1], (1, 1))
        Cb = torch.matmul(rnd(lo_ + hi_), self.belt_cos.T).to(self.dtype)
        Sb = torch.matmul(rnd(lo_ - hi_), self.belt_sin.T).to(self.dtype)
        # transpose of the phi0 rotation: the complex pair (C - iS) picks up
        # e^{-i m phi0}, which on the (C, +S) pair is a rotation by +phi0
        Cb, Sb = self._belt_rot(Cb, Sb)
        C = torch.cat(Cn + [Cb] + Cs[::-1], dim=-2)
        S = torch.cat(Sn + [Sb] + Ss[::-1], dim=-2)
        return C, S

    # -- spin 0 ------------------------------------------------------------

    def synthesis_state(self, x: torch.Tensor) -> torch.Tensor:
        """A: grid-packed alm state (..., nstate) -> map (..., npix_layout)."""
        F_ = self._lsynth_stack(self.lam0, self._state_grids(x))
        return self._maps_out(self._cos_sin_eval(F_[..., 0, :, :] * self.cm,
                                                 F_[..., 1, :, :] * self.cm))

    def adjoint_synthesis_state(self, maps: torch.Tensor) -> torch.Tensor:
        """A^T: exact transpose of ``synthesis_state``."""
        C, S = self._cos_sin_adj(self._maps_in(maps))
        # G_m = sum_j f e^{-im phi} = C - iS; the grid packing's output
        # scale absorbs the cm factor, as on the GL grid
        a2 = self._ladj_stack(self.lam0, torch.stack([C, -S], dim=-3))
        return self._grids_to_state(a2)

    def analysis_state(self, maps: torch.Tensor) -> torch.Tensor:
        """iter=0 map2alm: the pixel-area-scaled adjoint (an approximate
        inverse)."""
        return self.adjoint_synthesis_state(maps) * self.pixel_area

    # -- spin 2 ------------------------------------------------------------

    def _require_spin2(self):
        if self.lam_p2 is None and self.lam_w is None:
            raise ValueError("HealpixSHT built without spin2=True")

    def synthesis_spin2_state(self, e_state: torch.Tensor,
                              b_state: torch.Tensor):
        """(E, B) grid-packed alm states -> (Q, U) maps."""
        self._require_spin2()
        Fp_re, Fp_im, Fm_re, Fm_im = self._spin2_F(e_state, b_state)
        pos = self.pos
        Are = Fp_re + Fm_re * pos
        Aim = Fp_im + Fm_im * pos
        Bre = Fp_re - Fm_re * pos
        Bim = Fp_im - Fm_im * pos
        # Q = Re sum (Are + i Aim) e^{im phi}; U = Re sum (Bim - i Bre):
        # Q and U stacked, so each azimuthal table is read once for both
        out = self._maps_out(self._cos_sin_eval(
            torch.stack([Are, Bim], dim=-3), torch.stack([Aim, -Bre], dim=-3)))
        return out[..., 0, :], out[..., 1, :]

    def adjoint_synthesis_spin2_state(self, q_maps, u_maps):
        """Exact transpose of ``synthesis_spin2_state``."""
        self._require_spin2()
        qu = torch.stack([self._maps_in(q_maps), self._maps_in(u_maps)],
                         dim=-2)
        Cqu, Squ = self._cos_sin_adj(qu)
        Cq, Sq = Cqu[..., 0, :, :], Squ[..., 0, :, :]
        Cu, Su = Cqu[..., 1, :, :], Squ[..., 1, :, :]
        # C+_m = sum (Q + iU) e^{-im phi}: re = Cq + Su, im = Cu - Sq
        # C-_m = sum (Q + iU) e^{+im phi}: re = Cq - Su, im = Cu + Sq
        return self._spin2_alm(Cq + Su, Cu - Sq, Cq - Su, Cu + Sq)

    def analysis_spin2_state(self, q_maps, u_maps):
        """iter=0 map2alm of (Q, U): the pixel-area-scaled adjoint."""
        e, b = self.adjoint_synthesis_spin2_state(q_maps, u_maps)
        return e * self.pixel_area, b * self.pixel_area


def make_healpix_sht(nside: int, lmax: int | None = None,
                     dtype=torch.float32, spin2: bool = False,
                     layout: str = "ring", device="cuda", table_dtype=None,
                     m_block: int = 128,
                     ring_split: bool = False) -> HealpixSHT:
    """Build a HEALPix SHT; lmax defaults to 2 nside.  ``layout="padded"``
    keeps maps in the padded section layout (``to_ring`` / ``from_ring``
    at the boundaries); the options are ``HealpixSHT``'s."""
    if lmax is None:
        lmax = 2 * nside
    return HealpixSHT(nside, lmax, dtype=dtype, spin2=spin2, layout=layout,
                      device=device, table_dtype=table_dtype,
                      m_block=m_block, ring_split=ring_split)
