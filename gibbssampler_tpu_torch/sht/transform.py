"""Spherical-harmonic transforms, spin-0 and spin-2 (PyTorch counterpart of
``gibbssampler_tpu.sht.transform``).

  synthesis  (alm -> map):  per-m Legendre contraction  ->  azimuthal stage
  analysis   (map -> alm):  azimuthal stage             ->  weighted Legendre

The Legendre stage goes through the hand-written kernels
(``sht.lcore`` -> ``sht.legendre_kernels``), on the full tables or, with
``ring_split``, on the north half of an equator-symmetric grid.  The
azimuthal stage has the JAX package's three forms (``fft_mode``):

- "matmul" (default): the folded real cos/sin DFT as a ``torch.matmul``, a
  plain matrix product that the JAX package left to XLA;
- "fft": ``torch.fft.rfft`` / ``irfft`` for the spin-0 ring transforms
  (the JAX package calls XLA's FFT there; its spin-2 stage stays
  "matmul" in this mode, and so does the port's);
- "ct": one Cooley-Tukey split nphi = n1 n2 as two real matrix-product
  stages with a twiddle between them, the JAX package's form for backends
  without an FFT; it falls back to "matmul" when nphi has no useful
  factorization.

The ring-domain helpers of the blocked-MH engines (``ring_cs_of_maps``)
stay "matmul" in every mode, as in the JAX package.

With tables in another dtype than the compute dtype (``table_dtype``:
bfloat16 or float16 under float32, bfloat16, float16 or float32 under
float64, float64 under float32) the "matmul" and "ct" stages are the JAX
package's table-dtype products: their DFT, twiddle and Cooley-Tukey
matrices hold values rounded to the table dtype (kept in the wider of the
two dtypes), and each data operand is rounded to (or, for the float64
table, widened to) the table dtype just before its product
(``LegendreCore._round_td``), which runs in the wider dtype and is
rounded to the compute dtype; "fft" takes no table dtype, in the JAX
package and here.

On the Gauss-Legendre grid ``analysis`` is the
exact inverse of ``synthesis`` and ``adjoint_synthesis`` its exact
transpose.  The alm format is the grid-packed state (harmonics.gridstate);
maps are (..., nrings, nphi) real tensors, with any leading batch axes.

Precision: importing this module sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``, so that float32 matrix
products on the card run in full float32 and not in TF32 (about three
decimal digits), which would break the A / A^T transpose pairing the
samplers rely on.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .grids import SphereGrid, gauss_legendre_grid
from .lcore import FlatAlmMethods, LegendreCore
from .legendre import legendre_table, spin2_lambda_tables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["SHT", "make_sht"]

FFT_MODES = ("matmul", "fft", "ct")

# (sign_p, sign_m) of ``SHT.lsel_grid_spin2_single`` for an E-only and a
# B-only input
SPIN2_SINGLE_SIGNS = {"e": (-1.0, -1.0), "b": (1.0, -1.0)}


class SHT(FlatAlmMethods, LegendreCore):
    """Operator tables for one (grid, lmax, dtype) on one device.

    ``allow_aliasing``: synthesis (pointwise evaluation) and its transpose
    are exact on any nphi; only analysis as the inverse needs
    nphi > 2 lmax.  With the flag a grid with nphi <= 2 lmax + 1 is taken
    for synthesis and its adjoint (the floor transform over HEALPix belt
    rows, nphi = 2 lmax), and ``analysis_*`` raise.

    The JAX package's construction options, with its defaults:
    ``fft_mode`` ("matmul", "fft" or "ct": the module docstring);
    ``table_dtype`` (None: the compute dtype; bfloat16 or float16 with
    float32 compute; bfloat16, float16 or float32 with float64 compute;
    float64 with float32 compute; ``sht.lcore.resolve_table_dtype``);
    ``m_block`` (the JAX package's wedge m-blocking; stored and passed on
    to derived transforms, and no value of it changes a result or a
    launch: the kernels skip the l < m triangle row by row);
    ``ring_split`` (the north/south parity split, ``sht.lcore``; False on
    a grid that is not equator-symmetric)."""

    def __init__(self, grid: SphereGrid, lmax: int, dtype=torch.float32,
                 spin2: bool = False, device="cuda",
                 allow_aliasing: bool = False, fft_mode: str = "matmul",
                 table_dtype=None, m_block: int = 128,
                 ring_split: bool = False):
        if fft_mode not in FFT_MODES:
            raise ValueError(f"fft_mode={fft_mode!r}; one of {FFT_MODES}")
        self.grid = grid
        self.allow_aliasing = bool(allow_aliasing)
        self._init_core(lmax, grid.theta, dtype, device, table_dtype,
                        m_block, ring_split)
        L = lmax + 1
        if grid.nphi < 2 * lmax + 2 and not allow_aliasing:
            raise ValueError(
                f"grid nphi={grid.nphi} too small for lmax={lmax}; "
                f"need >= {2 * lmax + 2}")
        dev = self.device
        theta_t = self._table_theta(grid.theta)
        self.lam0 = self._table(legendre_table(lmax, np.cos(theta_t)), "lam0")
        # quadrature weights including the 2 pi / nphi azimuthal factor
        self.wq = torch.as_tensor(grid.weights * (2.0 * np.pi / grid.nphi),
                                  dtype=dtype, device=dev)
        self.nphi = grid.nphi
        self.nrings = grid.nrings
        # per-ring, per-m phase rotation for the first-pixel offset phi0
        m = np.arange(L)
        ang = np.outer(grid.phi0, m)                 # (nr, L)
        self.has_phase = bool(np.any(grid.phi0 != 0.0))
        self.phase_cos = torch.as_tensor(np.cos(ang), dtype=dtype, device=dev)
        self.phase_sin = torch.as_tensor(np.sin(ang), dtype=dtype, device=dev)
        # azimuthal DFT matrices folded over the reflection j <-> nphi - j:
        # columns j = 0..nphi/2 only; f[j] = C[j] - S[j], f[n - j] = C[j] + S[j]
        nh = grid.nphi // 2 + 1
        ang2 = 2.0 * np.pi * np.outer(m, np.arange(nh)) / grid.nphi
        self.nphi_half = nh
        self.dft_cos = self._trig(np.cos(ang2))
        self.dft_sin = self._trig(np.sin(ang2))
        self.fft_mode = fft_mode
        self._ct = None
        if fft_mode == "ct":
            self._ct = _ct_setup(grid.nphi, L, self._trig, self._round_td,
                                 dtype)
            if self._ct is None:
                self.fft_mode = "matmul"
        self.lam_p2 = self.lam_m2 = self.lam_w = self.lam_x = None
        if spin2:
            self._build_spin2_tables(*spin2_lambda_tables(lmax, theta_t))

    # -- azimuthal stage (real arithmetic) ---------------------------------

    def _rot(self, Fre, Fim, sign=+1):
        """Rotate ring Fourier coefficients by e^{sign * i m phi0_r}."""
        if not self.has_phase:
            return Fre, Fim
        c, s = self.phase_cos, sign * self.phase_sin
        return Fre * c - Fim * s, Fre * s + Fim * c

    def _unfold_half(self, lo, hi):
        """f over all nphi columns from the half-range results:
        f[j] = lo[j] (j = 0..n/2), f[n - j] = hi[j] (j = 1..n/2 - 1)."""
        return torch.cat([lo, hi[..., 1:-1].flip(-1)], dim=-1)

    def _fold_half(self, maps):
        """(u, v) with u[j] = f[j] + f[n-j], v[j] = f[j] - f[n-j]
        (j = 0 and n/2 self-paired): the transpose of _unfold_half."""
        lo = maps[..., : self.nphi_half]
        rev = maps[..., self.nphi_half - 1:].flip(-1)
        hi = F.pad(rev[..., :-1], (1, 1))
        return lo + hi, lo - hi

    def _halfspec_to_real(self, Are, Aim):
        """f[..., j] = sum_m Are cos(m theta_j) - Aim sin(m theta_j) over
        the ring angle theta_j = 2 pi j / nphi, m < L: "ct" or else the
        folded DFT matrices; (Are, Aim) rounded to the table dtype."""
        Are, Aim = self._round_td(Are), self._round_td(Aim)
        if self.fft_mode == "ct":
            return _ct_halfspec_to_real(self._ct, Are, Aim)
        C = torch.matmul(Are, self.dft_cos).to(self.dtype)
        S = torch.matmul(Aim, self.dft_sin).to(self.dtype)
        return self._unfold_half(C - S, C + S)

    def _real_to_halfspec(self, maps):
        """(C, S)[..., m] = (sum_j f cos(m theta_j), sum_j f sin(m theta_j)),
        m < L: the transpose of ``_halfspec_to_real``; the maps ("ct") or
        their folds rounded to the table dtype."""
        maps = maps.to(self.dtype)
        if self.fft_mode == "ct":
            return _ct_real_to_halfspec(self._ct, self._round_td(maps))
        u, v = self._fold_half(maps)
        rnd, dt = self._round_td, self.dtype
        return (torch.matmul(rnd(u), self.dft_cos.T).to(dt),
                torch.matmul(rnd(v), self.dft_sin.T).to(dt))

    def _ring_ifft_real(self, Fre, Fim):
        """f[.., r, j] = sum_m (2 - delta_m0) (Fre cos(m phi_j) - Fim sin)."""
        Fre, Fim = self._rot(Fre, Fim, +1)
        if self.fft_mode == "fft":
            pad = (0, self.nphi // 2 + 1 - (self.lmax + 1))
            Fc = torch.complex(F.pad(Fre, pad), F.pad(Fim, pad))
            return torch.fft.irfft(Fc, n=self.nphi, dim=-1) * self.nphi
        return self._halfspec_to_real(Fre * self.cm, Fim * self.cm)

    def _ring_fft_real(self, maps):
        """G_m = sum_j f e^{-i m phi_j}; returns (Gre, Gim), (..., nr, L)."""
        if self.fft_mode == "fft":
            G = torch.fft.rfft(maps.to(self.dtype), dim=-1)[..., : self.lmax + 1]
            return self._rot(G.real, G.imag, -1)
        C, S = self._real_to_halfspec(maps)
        return self._rot(C, -S, -1)

    # -- spin 0 ------------------------------------------------------------

    def synthesis_from_grids(self, g0: torch.Tensor) -> torch.Tensor:
        """Spin-0 synthesis from a prebuilt ``_state_grids`` array (shared
        by a cut / point-set transform pair)."""
        F_ = self._lsynth_stack(self.lam0, g0)
        return self._ring_ifft_real(F_[..., 0, :, :], F_[..., 1, :, :])

    def synthesis_state(self, x: torch.Tensor) -> torch.Tensor:
        """A: grid-packed alm state (..., nstate) -> map (..., nr, nphi)."""
        return self.synthesis_from_grids(self._state_grids(x))

    def _spin0_agrids(self, maps, ring_w=None):
        """Spin-0 analysis (ring weights ``ring_w``) or adjoint (None) up to
        the alm grids (..., 2, L, L), summable across transforms."""
        Gre, Gim = self._ring_fft_real(maps)
        if ring_w is not None:
            Gre, Gim = Gre * ring_w[:, None], Gim * ring_w[:, None]
        return self._ladj_stack(self.lam0, torch.stack([Gre, Gim], dim=-3))

    def _refuse_aliased_analysis(self):
        if self.allow_aliasing:
            raise ValueError("analysis is not an inverse on an aliased "
                             "(nphi <= 2 lmax) grid; only synthesis and "
                             "adjoint_synthesis are exact here")

    def analysis_state(self, maps: torch.Tensor) -> torch.Tensor:
        """Exact inverse of synthesis_state on a quadrature grid."""
        self._refuse_aliased_analysis()
        return self._grids_to_state(self._spin0_agrids(maps, self.wq))

    def adjoint_synthesis_state(self, maps: torch.Tensor) -> torch.Tensor:
        """A^T: exact transpose of ``synthesis_state`` w.r.t. the plain
        pixel and state dot products."""
        return self._grids_to_state(self._spin0_agrids(maps))

    # -- spin 2 ------------------------------------------------------------

    def _require_spin2(self):
        if self.lam_p2 is None and self.lam_w is None:
            raise ValueError("SHT built without spin2=True")

    def _require_dense_spin2(self, what: str):
        if self.lam_p2 is None:
            raise NotImplementedError(
                f"{what} spin-2 synthesis requires ring_split=False"
                + (" tables" if what == "binned" else ""))

    def synthesis_spin2_state(self, e_state: torch.Tensor,
                              b_state: torch.Tensor):
        """(E, B) grid-packed alm states -> (Q, U) maps.

        Q + iU = sum_lm a+_{lm} 2Y_lm with a+ = -(E + iB), a- = -(E - iB);
        negative m through the reality relations, all arithmetic real."""
        self._require_spin2()
        return self._spin2_maps_from_F(*self._spin2_F(e_state, b_state))

    def _spin2_maps_from_F(self, Fp_re, Fp_im, Fm_re, Fm_im):
        """(F+, F-) ring Fourier coefficients (..., nr, L) -> (Q, U) maps."""
        Fp_re, Fp_im = self._rot(Fp_re, Fp_im, +1)
        Fm_re, Fm_im = self._rot(Fm_re, Fm_im, +1)
        # P(phi) = sum_{m>=0} F+ e^{im phi} + sum_{m>0} conj(F-) e^{-im phi}
        Are = Fp_re + Fm_re * self.pos
        Aim = Fp_im + Fm_im * self.pos
        Bre = Fp_re - Fm_re * self.pos
        Bim = Fp_im - Fm_im * self.pos
        # Q = Re sum (Are + i Aim) w^mj ; U = Re sum (Bim - i Bre) w^mj
        return (self._halfspec_to_real(Are, Aim),
                self._halfspec_to_real(Bim, -Bre))

    def _spin2_ring_coefs(self, q_maps, u_maps):
        """(Q, U) maps -> unweighted (Cp_re, Cp_im, Cm_re, Cm_im) ring
        coefficients C+ = sum_j (Q + iU) e^{-im phi_j},
        C- = sum_j (Q + iU) e^{+im phi_j}."""
        qc, qs = self._real_to_halfspec(q_maps)
        uc, us = self._real_to_halfspec(u_maps)
        Cp_re, Cp_im = self._rot(qc + us, uc - qs, -1)
        Cm_re, Cm_im = self._rot(qc - us, uc + qs, +1)
        return Cp_re, Cp_im, Cm_re, Cm_im

    def _analysis_spin2_core(self, q_maps, u_maps, ring_w):
        self._require_spin2()
        w = ring_w[:, None]
        Cp_re, Cp_im, Cm_re, Cm_im = self._spin2_ring_coefs(q_maps, u_maps)
        # a+_{lm} = sum_r w 2lam_lm C+ ; a-_{lm} = sum_r w -2lam_lm conj(C-)
        return self._spin2_alm(Cp_re * w, Cp_im * w, Cm_re * w, Cm_im * w)

    def analysis_spin2_state(self, q_maps, u_maps):
        """Exact inverse: (Q, U) maps -> (E, B) grid-packed alm states."""
        self._refuse_aliased_analysis()
        return self._analysis_spin2_core(q_maps, u_maps, self.wq)

    def adjoint_synthesis_spin2_state(self, q_maps, u_maps):
        """Exact transpose of synthesis_spin2_state w.r.t. plain dots."""
        return self._analysis_spin2_core(q_maps, u_maps,
                                         torch.ones_like(self.wq))

    # -- ring half-spectrum (m-domain) representation -----------------------
    #
    # A synthesized map restricted to one ring is a finite cos/sin series in
    # the ring angle theta_j = 2 pi j / nphi,
    #     f[j] = sum_m  C_m cos(m theta_j) + S_m sin(m theta_j),
    # and with mmax <= nphi/2 the ring pixel dot product of two such series
    # is exact in the coefficients (discrete Parseval):
    #     sum_j f g = pw_cos . (C C') + pw_sin . (S S').
    # The blocked-MH table engine (samplers.cls_samplers) does its per-bin
    # likelihood algebra in this basis.

    def ring_dot_weights(self):
        """(pw_cos, pw_sin) Parseval weights of the ring pixel dot product
        in the cos/sin half-spectrum basis (m = 0, and the Nyquist column
        2 m = nphi, carry pw_cos = nphi, pw_sin = 0)."""
        n = self.nphi
        L = self.lmax + 1
        if n < 2 * self.lmax:
            raise ValueError(
                f"ring-domain dot products need nphi >= 2 lmax "
                f"(nphi={n}, lmax={self.lmax}): cross-mode aliasing")
        pwc = np.full(L, n / 2.0)
        pws = np.full(L, n / 2.0)
        pwc[0], pws[0] = float(n), 0.0
        if 2 * self.lmax == n:
            pwc[self.lmax], pws[self.lmax] = float(n), 0.0
        return (torch.as_tensor(pwc, dtype=self.dtype, device=self.device),
                torch.as_tensor(pws, dtype=self.dtype, device=self.device))

    def ring_cs_of_maps(self, maps: torch.Tensor):
        """(..., nr, nphi) pixel maps -> (Rc, Rs) raw ring sums
        Rc_m = sum_j f cos(m theta_j), Rs_m = sum_j f sin(m theta_j), each
        (..., nr, L), so that sum_j f a = sum_m (Cc Rc + Cs Rs) for any
        half-spectrum series a with coefficients (Cc, Cs)."""
        u, v = self._fold_half(maps.to(self.dtype))
        rnd, dt = self._round_td, self.dtype
        return (torch.matmul(rnd(u), self.dft_cos.T).to(dt),
                torch.matmul(rnd(v), self.dft_sin.T).to(dt))

    def lsel_grid_spin2_single(self, state: torch.Tensor, which: str):
        """The Legendre-stage input grid of a single-field spin-2 input (the
        other field zero), shared by both spin-2 tables.

        For E-only input (B = 0): ap = am = -(g_re, g_im) = -g, so the grid
        is g with signs (-1, -1).  For B-only (E = 0): ap = (g_im, -g_re)
        and am = -ap: the swapped grid with signs (+1, -1).  Returns
        (grid (..., 2, L, L), sign_p, sign_m)."""
        self._require_spin2()
        g = self._state_grids(state)
        if which not in SPIN2_SINGLE_SIGNS:
            raise ValueError(which)
        if which == "b":
            g = torch.stack([g[..., 1, :, :], -g[..., 0, :, :]], dim=-3)
        return (g, *SPIN2_SINGLE_SIGNS[which])

    # -- ell-selected (per-bin) syntheses: the blocked-MH coefficient and
    # phi-domain engines --------------------------------------------------

    def ring_cs_lsel_spin0(self, x: torch.Tensor, j_idx, seg=None):
        """Per-bin ell-selected spin-0 synthesis in the ring half-spectrum
        basis: (Cc, Cs), each (..., nb, nr, L), with map_b[j] = sum_m Cc
        cos(m theta_j) + Cs sin(m theta_j)."""
        return self.ring_cs_lsel_spin0_grids(self._state_grids(x), j_idx,
                                             seg)

    def ring_cs_lsel_spin0_grids(self, g0: torch.Tensor, j_idx, seg=None):
        """``ring_cs_lsel_spin0`` from a prebuilt ``_state_grids`` array
        (a sweep over many ell chunks of one state builds it once)."""
        F_ = self._lsel_F(self.lam0, g0, j_idx, seg)
        Fre, Fim = self._rot(F_[..., 0, :, :], F_[..., 1, :, :], +1)
        return self.cm * Fre, -(self.cm * Fim)

    def _spin2_lsel_cs(self, Fp, Fm, sign_p=1.0, sign_m=1.0):
        """Per-bin (F+, F-) stacks (..., nb, 2, nr, L) -> ((Qc, Qs), (Uc,
        Us)) half-spectrum coefficients, the assembly of
        ``_spin2_maps_from_F`` with F- weighted by sign_m (and F+ by
        sign_p) before the ring phase."""
        pos_p = sign_m * self.pos
        Are = sign_p * Fp[..., 0, :, :] + Fm[..., 0, :, :] * pos_p
        Aim = sign_p * Fp[..., 1, :, :] + Fm[..., 1, :, :] * pos_p
        Bre = sign_p * Fp[..., 0, :, :] - Fm[..., 0, :, :] * pos_p
        Bim = sign_p * Fp[..., 1, :, :] - Fm[..., 1, :, :] * pos_p
        Are, Aim = self._rot(Are, Aim, +1)
        Bre, Bim = self._rot(Bre, Bim, +1)
        # Q[j] = sum Are cos - Aim sin ; U[j] = sum Bim cos + Bre sin
        return (Are, -Aim), (Bim, Bre)

    def ring_cs_lsel_spin2_grids(self, g: torch.Tensor, sign_p, sign_m,
                                 j_idx, seg=None):
        """Per-bin ell-selected spin-2 synthesis from a prebuilt
        single-field grid (``lsel_grid_spin2_single``): ((Qc, Qs), (Uc,
        Us)), each (..., nb, nr, L)."""
        self._require_spin2()
        self._require_dense_spin2("ell-selected")
        return self._spin2_lsel_cs(self._lsel_F(self.lam_p2, g, j_idx, seg),
                                   self._lsel_F(self.lam_m2, g, j_idx, seg),
                                   sign_p, sign_m)

    def ring_cs_lsel_spin2(self, e_state: torch.Tensor,
                           b_state: torch.Tensor, j_idx, seg=None):
        """Per-bin ell-selected spin-2 synthesis of (E, B) in the ring
        half-spectrum basis: ((Qc, Qs), (Uc, Us)), each (..., nb, nr, L)."""
        self._require_spin2()
        self._require_dense_spin2("ell-selected")
        ap, am = self._spin2_stacks(e_state, b_state)
        return self._spin2_lsel_cs(self._lsel_F(self.lam_p2, ap, j_idx, seg),
                                   self._lsel_F(self.lam_m2, am, j_idx, seg))

    def synthesis_state_lsel(self, x: torch.Tensor, sel) -> torch.Tensor:
        """A applied to each ell subset of x: ``sel`` an (nb, L) host
        selector -> (..., nb, nr, nphi) maps."""
        F_ = self._lsynth_stack_binned(self.lam0, self._state_grids(x), sel)
        return self._ring_ifft_real(F_[..., 0, :, :], F_[..., 1, :, :])

    def synthesis_spin2_state_lsel(self, e_state: torch.Tensor,
                                   b_state: torch.Tensor, sel):
        """Spin-2 synthesis of each ell subset of (E, B): (Q, U), each
        (..., nb, nr, nphi)."""
        self._require_spin2()
        self._require_dense_spin2("binned")
        ap, am = self._spin2_stacks(e_state, b_state)
        Fp = self._lsynth_stack_binned(self.lam_p2, ap, sel)
        Fm = self._lsynth_stack_binned(self.lam_m2, am, sel)
        return self._spin2_maps_from_F(Fp[..., 0, :, :], Fp[..., 1, :, :],
                                       Fm[..., 0, :, :], Fm[..., 1, :, :])


def make_sht(lmax: int, grid: SphereGrid | None = None, dtype=torch.float32,
             spin2: bool = False, device="cuda", fft_mode: str = "matmul",
             table_dtype=None, m_block: int = 128,
             ring_split: bool = False) -> SHT:
    """Build an SHT for ``lmax`` (Gauss-Legendre grid by default); the
    options are ``SHT``'s."""
    if grid is None:
        grid = gauss_legendre_grid(lmax)
    return SHT(grid, lmax, dtype=dtype, spin2=spin2, device=device,
               fft_mode=fft_mode, table_dtype=table_dtype, m_block=m_block,
               ring_split=ring_split)


class _CT:
    """The mixed-radix azimuthal operator: DFT_n factored as two matrix
    stages with a twiddle between them (n = n1 n2; m = n1 a + b; j = j2 +
    n2 j1); for n ~ 2 lmax about 4x fewer products than the folded DFT.
    ``t`` makes a matrix of host values (rounded to the table dtype),
    ``rnd`` rounds the second stage's operand to the table dtype (the JAX
    package's ``astype`` between the stages); each matrix product is
    rounded to the compute dtype ``dtype`` (float64 products of a wider
    table)."""

    def __init__(self, n, n1, n2, A, L, t, rnd, dtype):
        self.n, self.n1, self.n2, self.A, self.L = n, n1, n2, A, L
        self.rnd, self.dtype = rnd, dtype
        w2 = 2.0 * np.pi * (np.arange(A)[:, None] * np.arange(n2)[None, :]) \
            / n2
        self.W2c, self.W2s = t(np.cos(w2)), t(np.sin(w2))       # (A, n2)
        tw = 2.0 * np.pi * (np.arange(n1)[:, None]
                            * np.arange(n2)[None, :]) / n
        self.TWc, self.TWs = t(np.cos(tw)), t(np.sin(tw))       # (n1, n2)
        w1 = 2.0 * np.pi * (np.arange(n1)[:, None]
                            * np.arange(n1)[None, :]) / n1
        self.W1c, self.W1s = t(np.cos(w1)), t(np.sin(w1))       # (n1, n1)


def _ct_setup(n, L, t, rnd, dtype):
    """Pick n = n1 n2 minimizing 4 ceil(L / n1) + 2 n1; None if no useful
    factorization exists."""
    best = None
    for n1 in range(2, n):
        if n % n1:
            continue
        cost = 4 * -(-L // n1) + 2 * n1
        if best is None or cost < best[0]:
            best = (cost, n1)
    if best is None or best[0] >= 2 * (n // 2 + 1) * L // n:
        return None
    n1 = best[1]
    return _CT(n, n1, n // n1, -(-L // n1), L, t, rnd, dtype)


def _ct_halfspec_to_real(ct, Gre, Gim):
    """f[..., j] = Re sum_{m<L} (Gre + i Gim)[m] e^{2 pi i m j / n}."""
    pad = ct.A * ct.n1 - ct.L
    if pad:
        Gre, Gim = F.pad(Gre, (0, pad)), F.pad(Gim, (0, pad))
    Xre = Gre.reshape(Gre.shape[:-1] + (ct.A, ct.n1))
    Xim = Gim.reshape(Xre.shape)
    # stage 1 over a: (..., a, b) x (a, j2) -> (..., b, j2)
    e = lambda x, w: torch.matmul(x.transpose(-1, -2), w).to(ct.dtype)
    T1re = e(Xre, ct.W2c) - e(Xim, ct.W2s)
    T1im = e(Xre, ct.W2s) + e(Xim, ct.W2c)
    T2re = ct.rnd(T1re * ct.TWc - T1im * ct.TWs)
    T2im = ct.rnd(T1re * ct.TWs + T1im * ct.TWc)
    # stage 2 over b: (..., b, j2) x (b, j1) -> (..., j1, j2), j = j2 + n2 j1
    out = (torch.matmul(ct.W1c.T, T2re).to(ct.dtype)
           - torch.matmul(ct.W1s.T, T2im).to(ct.dtype))
    return out.reshape(out.shape[:-2] + (ct.n,))


def _ct_real_to_halfspec(ct, maps):
    """(C, S)[..., m] = (sum_j f cos(2 pi m j / n), sum_j f sin(...)),
    m < L: the exact transpose of ``_ct_halfspec_to_real``."""
    x = maps.reshape(maps.shape[:-1] + (ct.n1, ct.n2))       # (..., j1, j2)
    # (b, j1) x (..., j1, j2) -> (..., b, j2)
    Ure = torch.matmul(ct.W1c, x).to(ct.dtype)
    Uim = -torch.matmul(ct.W1s, x).to(ct.dtype)
    Vre = ct.rnd(Ure * ct.TWc + Uim * ct.TWs)
    Vim = ct.rnd(Uim * ct.TWc - Ure * ct.TWs)
    # (..., b, j2) x (j2, a) -> (..., a, b)
    g = lambda v, w: torch.matmul(v, w.T).transpose(-1, -2).to(ct.dtype)
    Cre = g(Vre, ct.W2c) + g(Vim, ct.W2s)
    Cim = g(Vim, ct.W2c) - g(Vre, ct.W2s)
    Cre = Cre.reshape(Cre.shape[:-2] + (ct.A * ct.n1,))[..., : ct.L]
    Cim = Cim.reshape(Cim.shape[:-2] + (ct.A * ct.n1,))[..., : ct.L]
    return Cre, -Cim
