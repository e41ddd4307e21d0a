"""Shared parity checks of the port's table dtypes against the JAX package's
(``tests/test_torch_f16_tables.py``, ``tests/test_torch_wide_tables.py``):
one (table dtype, compute dtype) pair a ``Pair``, its comparison, and the
references and comparisons of the four contractions, the transforms, the
point sets, the ell-selected synthesis, the table engine's W tables and
``cg_cr``, with JAX's x64 on and every JAX call jitted with the transform
closed over (its tables become constants of the compiled program), as the
JAX package runs the path itself."""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from torch_parity import jax_model_arrays, n, tri_table
from gibbssampler_tpu.harmonics import ell_mask_state, nstate
from gibbssampler_tpu.sht import SHT as JaxSHT
from gibbssampler_tpu.sht import gauss_legendre_grid as jax_gl
from gibbssampler_tpu.sht.points import PointSHT as JaxPointSHT
from gibbssampler_tpu_torch.sht import PointSHT, make_sht
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

METHODS = ("synthesis_state", "adjoint_synthesis_state", "analysis_state",
           "synthesis_spin2_state", "adjoint_synthesis_spin2_state",
           "analysis_spin2_state")
LMAX_CUT = 16


def rel_err(mine, ref) -> np.ndarray:
    """|mine - ref| / max|ref|, elementwise."""
    ref = np.asarray(ref, dtype=np.float64)
    return (np.abs(n(mine).astype(np.float64) - ref)
            / np.abs(ref).max())


@dataclasses.dataclass(frozen=True)
class Pair:
    """A (table dtype, compute dtype) pair and how the port is held to the
    JAX package on it: every element within ``tol`` of max|ref|, or, with
    ``flips`` set, all but a fraction ``flips`` of them, and those within
    ``flip_tol`` (see ``close``)."""
    td: torch.dtype
    cd: torch.dtype
    tol: float
    flips: float = 0.0
    flip_tol: float = 0.0

    @property
    def jtd(self):
        return getattr(jnp, str(self.td)[6:])

    @property
    def jcd(self):
        return getattr(jnp, str(self.cd)[6:])

    @property
    def np_cd(self):
        return np.dtype(str(self.cd)[6:])

    def t(self, a) -> torch.Tensor:
        """A host array as a compute-dtype tensor."""
        return torch.as_tensor(np.asarray(a, dtype=self.np_cd))

    def close(self, mine, ref, what, stage=False):
        """The port's ``mine`` against JAX's ``ref``.  A pair with
        ``flips`` (a 16-bit table under float32 compute), on a whole
        transform (not ``stage``): the two packages sum float32 products in
        other orders, and where such a sum lies within its last bit of a
        16-bit rounding boundary, its rounding to the table dtype before the
        next stage lands on the two neighbours (a flip, one 16-bit step of
        that operand), which moves the outputs that depend on it by up to
        ``flip_tol`` of max|ref|; each stage, given the same input, is held
        to ``tol`` everywhere."""
        err = rel_err(mine, ref)
        if stage or not self.flips:
            assert err.max() <= self.tol, (
                f"{what}: {err.max():.3g} max|ref| > {self.tol}")
            return
        frac = float(np.mean(err > self.tol))
        assert frac <= self.flips and err.max() <= self.flip_tol, (
            f"{what}: {frac:.4f} of the elements beyond {self.tol} max|ref| "
            f"(at most {self.flips}), max {err.max():.3g} (at most "
            f"{self.flip_tol})")


def jit(fn, *args):
    """``fn(*args)`` compiled (``fn`` closes over the JAX transform)."""
    return jax.jit(fn)(*args)


# ---------------------------------------------------------------------------
# the four contractions
# ---------------------------------------------------------------------------

def contraction_inputs(pair, L, nr, C, seed):
    """A float64 table and batches x and g in the compute dtype."""
    rng = np.random.default_rng(seed)
    return (tri_table(L, nr, seed),
            rng.normal(size=(L, C, L)).astype(pair.np_cd),
            rng.normal(size=(L, nr, C)).astype(pair.np_cd))


def parity_masks(L, ms):
    """(even, odd) masks of l - m over (M, L, 1), m = ms."""
    odd = (np.arange(L)[None, :] - np.asarray(ms)[:, None]) % 2
    return (1 - odd)[:, :, None].astype(np.float64), odd[:, :, None]


def jax_tri(pair):
    """JAX's dense contractions: table-dtype operands, the compute dtype's
    result."""
    jtd, jcd = pair.jtd, pair.jcd

    @jax.jit
    def fn(lam, x, g):
        return (jnp.einsum("mlr,mcl->mrc", lam, x.astype(jtd),
                           preferred_element_type=jcd),
                jnp.einsum("mlr,mrc->mcl", lam, g.astype(jtd),
                           preferred_element_type=jcd))
    return fn


def jax_par(pair):
    """The JAX package's split contractions (lcore ``_lsynth_stack_sym`` /
    ``_ladj_stack_sym``) with the parity masks folded into the tables: E
    and O each in the compute dtype, then north E + O and south f (E - O);
    the adjoint folds the south rows in the compute dtype, then rounds (or
    widens) U and V."""
    jtd, jcd = pair.jtd, pair.jcd

    @jax.jit
    def fn(lamE, lamO, x, g, f):
        nh = lamE.shape[2]
        xb = x.astype(jtd)
        E = jnp.einsum("mlr,mcl->mrc", lamE, xb,
                       preferred_element_type=jcd).astype(jcd)
        O = jnp.einsum("mlr,mcl->mrc", lamO, xb,
                       preferred_element_type=jcd).astype(jcd)
        nr = g.shape[1]
        south = (f * (E - O))[:, : nr - nh][:, ::-1]
        gn = g[:, :nh]
        gs = jnp.zeros_like(gn).at[:, : nr - nh].set(g[:, nh:][:, ::-1]) * f
        U, V = (gn + gs).astype(jtd), (gn - gs).astype(jtd)
        return (jnp.concatenate([E + O, south], axis=1),
                jnp.einsum("mlr,mrc->mcl", lamE, U,
                           preferred_element_type=jcd).astype(jcd)
                + jnp.einsum("mlr,mrc->mcl", lamO, V,
                             preferred_element_type=jcd).astype(jcd))
    return fn


def dense_vs_jax(pair, L, nr, C, slab, edit=None):
    """legendre_{synth,adj}_tri's plain versions (the CPU path of the
    wrappers) on the pair against JAX's einsums, full table or a slab of
    every third row; ``edit(x, g)`` may set batch values first."""
    lam, x, g = contraction_inputs(pair, L, nr, C, L + nr)
    if edit:
        edit(x, g)
    ms = np.arange(1, L, 3) if slab else np.arange(L)
    lt = lk.cast_to(torch.as_tensor(lam[ms]), pair.td)
    msk = torch.as_tensor(ms, dtype=torch.int32) if slab else None
    out_s = lk.legendre_synth_tri(lt, torch.as_tensor(x[ms]), msk)
    out_a = lk.legendre_adj_tri(lt, torch.as_tensor(g[ms]), msk)
    assert out_s.dtype == out_a.dtype == pair.cd
    ref_s, ref_a = jax_tri(pair)(jnp.asarray(lam[ms], pair.jtd), x[ms],
                                 g[ms])
    pair.close(out_s, ref_s, "synth", stage=True)
    pair.close(out_a, ref_a, "adj", stage=True)


def parity_vs_jax(pair, L, nr, C, flip, slab, edit=None):
    """legendre_{synth,adj}_par's plain versions on a half table (odd nr:
    the equator row; even: none), flip and not, full and slab, against the
    JAX package's split contractions; ``edit(x, g, ms)`` may set batch
    values first."""
    nh = (nr + 1) // 2
    lam, x, _ = contraction_inputs(pair, L, nh, C, L + nr)
    g = np.random.default_rng(nr).normal(size=(L, nr, C)).astype(pair.np_cd)
    ms = np.arange(2, L, 3) if slab else np.arange(L)
    if edit:
        edit(x, g, ms)
    lt = lk.cast_to(torch.as_tensor(lam[ms]), pair.td)
    msk = torch.as_tensor(ms, dtype=torch.int32) if slab else None
    out_s = lk.legendre_synth_par(lt, torch.as_tensor(x[ms]), nr, flip, msk)
    out_a = lk.legendre_adj_par(lt, torch.as_tensor(g[ms]), flip, msk)
    ev, od = parity_masks(L, ms)
    lj = np.asarray(jnp.asarray(lam[ms], pair.jtd).astype(jnp.float64))
    ref_s, ref_a = jax_par(pair)(jnp.asarray(lj * ev, pair.jtd),
                                 jnp.asarray(lj * od, pair.jtd), x[ms], g[ms],
                                 -1.0 if flip else 1.0)
    pair.close(out_s, ref_s, "synth par", stage=True)
    pair.close(out_a, ref_a, "adj par", stage=True)


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------

def state_inputs(pair, lmax, maps_shape, seed):
    """(x, f, e, b, q, u): spin-0 and spin-2 states and maps of two
    chains, in the compute dtype."""
    rng = np.random.default_rng(seed)
    ns = nstate(lmax)
    st = lambda spin: rng.normal(size=(2, ns)) * ell_mask_state(lmax, spin)
    out = (st(0), rng.normal(size=(2,) + maps_shape), st(2), st(2),
           *(rng.normal(size=(2,) + maps_shape) for _ in range(2)))
    return tuple(a.astype(pair.np_cd) for a in out)


def compare_transforms(pair, js, ts, maps_shape, what):
    """Synthesis, adjoint and analysis, spin 0 and 2, port against JAX."""
    x, f, e, b, q, u = state_inputs(pair, ts.lmax, maps_shape, 11)
    ref = jit(lambda x, f, e, b, q, u: (
        js.synthesis_state(x), js.adjoint_synthesis_state(f),
        js.analysis_state(f), js.synthesis_spin2_state(e, b),
        js.adjoint_synthesis_spin2_state(q, u),
        js.analysis_spin2_state(q, u)), x, f, e, b, q, u)
    args = {"synthesis_state": (x,), "adjoint_synthesis_state": (f,),
            "analysis_state": (f,), "synthesis_spin2_state": (e, b),
            "adjoint_synthesis_spin2_state": (q, u),
            "analysis_spin2_state": (q, u)}
    for meth, r in zip(METHODS, ref):
        mine = getattr(ts, meth)(*map(pair.t, args[meth]))
        mine = mine if isinstance(mine, tuple) else (mine,)
        r = r if isinstance(r, tuple) else (r,)
        for k, (a, rr) in enumerate(zip(mine, r)):
            assert a.dtype == pair.cd
            pair.close(a, rr, f"{what} {meth}[{k}]")


def compare_gl_stages(pair, js, ts, what):
    """Each stage of the GL transforms on the same input in both packages:
    the Legendre synthesis and adjoint (spin 0 and the spin-2 pair), and
    the azimuthal stages, held to ``tol`` everywhere."""
    x, f, e, b, q, u = state_inputs(pair, ts.lmax, (ts.nrings, ts.nphi), 12)
    g2 = np.asarray(jit(lambda x: js._state_grids(x), x))
    F = jit(lambda g: js._lsynth_stack(js.lam0, g), g2)
    pair.close(ts._lsynth_stack(ts.lam0, pair.t(g2)), F, f"{what} lsynth",
               stage=True)
    Fre, Fim = (np.asarray(a) for a in (F[..., 0, :, :], F[..., 1, :, :]))
    pair.close(ts._ring_ifft_real(pair.t(Fre), pair.t(Fim)),
               jit(lambda a, b: js._ring_ifft_real(a, b), Fre, Fim),
               f"{what} ring ifft", stage=True)
    G = jit(lambda f: js._ring_fft_real(f), f)
    for k, (a, r) in enumerate(zip(ts._ring_fft_real(pair.t(f)), G)):
        pair.close(a, r, f"{what} ring fft[{k}]", stage=True)
    Gs = np.stack([np.asarray(a) for a in G], axis=-3)
    pair.close(ts._ladj_stack(ts.lam0, pair.t(Gs)),
               jit(lambda g: js._ladj_stack(js.lam0, g), Gs),
               f"{what} ladj", stage=True)
    F2 = [np.asarray(a) for a in jit(lambda e, b: js._spin2_F(e, b), e, b)]
    for k, (a, r) in enumerate(zip(ts._spin2_F(pair.t(e), pair.t(b)), F2)):
        pair.close(a, r, f"{what} spin2 F[{k}]", stage=True)
    for k, (a, r) in enumerate(zip(
            ts._spin2_maps_from_F(*map(pair.t, F2)),
            jit(lambda *F: js._spin2_maps_from_F(*F), *F2))):
        pair.close(a, r, f"{what} spin2 maps[{k}]", stage=True)
    C2 = [np.asarray(a)
          for a in jit(lambda q, u: js._spin2_ring_coefs(q, u), q, u)]
    for k, (a, r) in enumerate(zip(
            ts._spin2_ring_coefs(pair.t(q), pair.t(u)), C2)):
        pair.close(a, r, f"{what} spin2 ring coefs[{k}]", stage=True)
    for k, (a, r) in enumerate(zip(
            ts._spin2_alm(*map(pair.t, C2)),
            jit(lambda *C: js._spin2_alm(*C), *C2))):
        pair.close(a, r, f"{what} spin2 alm[{k}]", stage=True)


def compare_points(pair):
    """``PointSHT`` values and adjoints, spin 0 and 2, and the flat-slot
    per-bin values with and without a segment matrix."""
    lmax = 16
    rng = np.random.default_rng(4)
    nrows, p = 6, 5
    theta = np.sort(rng.uniform(0.2, 2.9, nrows))
    phi = rng.uniform(0, 2 * np.pi, (nrows, p))
    valid = (rng.uniform(size=(nrows, p)) < 0.8).astype(np.float64)
    valid[:, 0] = 1.0
    js = JaxPointSHT(theta, phi, valid, lmax, dtype=pair.jcd, spin2=True,
                     table_dtype=pair.jtd)
    ts = PointSHT(theta, phi, valid, lmax, dtype=pair.cd, spin2=True,
                  device="cpu", table_dtype=pair.td)
    ns = nstate(lmax)
    x, e, b = ((rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2))
               .astype(pair.np_cd) for _ in range(3))
    f, q, u = (rng.normal(size=(2, nrows, p)).astype(pair.np_cd)
               for _ in range(3))
    ref = jit(lambda x, f, e, b, q, u: (
        (js.synthesis_state(x),), (js.adjoint_synthesis_state(f),),
        js.synthesis_spin2_state(e, b),
        js.adjoint_synthesis_spin2_state(q, u)), x, f, e, b, q, u)
    t = pair.t
    mine = ((ts.synthesis_state(t(x)),), (ts.adjoint_synthesis_state(t(f)),),
            ts.synthesis_spin2_state(t(e), t(b)),
            ts.adjoint_synthesis_spin2_state(t(q), t(u)))
    for k, (a, r) in enumerate(zip(mine, ref)):
        for i, (aa, rr) in enumerate(zip(a, r)):
            pair.close(aa, rr, f"points [{k}][{i}]")
    j_idx = np.array([3, 5, 6, 9, 12, 16])
    seg = np.zeros((6, 3))
    seg[np.arange(6), [0, 0, 1, 1, 2, 2]] = 1.0
    gsel = rng.normal(size=(2, 2, lmax + 1, 6)).astype(pair.np_cd)
    for sg in (None, seg):
        r0 = jit(lambda g: js.values_flat_spin0_gsel(g, j_idx, sg), gsel)
        pair.close(ts.values_flat_spin0_gsel(t(gsel), j_idx, sg), r0,
                   f"flat spin0 seg={sg is not None}")
        for sp, sm in ((-1.0, -1.0), (1.0, -1.0)):
            r2 = jit(lambda g: js.values_flat_spin2_gsel(
                g, sp, sm, j_idx, sg), gsel)
            for a, r in zip(ts.values_flat_spin2_gsel(t(gsel), sp, sm,
                                                      j_idx, sg), r2):
                pair.close(a, r, f"flat spin2 {sp} {sm} seg={sg is not None}")


def compare_lsel(pair):
    """``_lsel_F`` through ``ring_cs_lsel_spin0`` / ``ring_cs_lsel_spin2``
    on a GL transform, with and without ``seg``."""
    lmax = 16
    js = JaxSHT(jax_gl(lmax), lmax, dtype=pair.jcd, spin2=True,
                table_dtype=pair.jtd)
    ts = make_sht(lmax, dtype=pair.cd, spin2=True, device="cpu",
                  table_dtype=pair.td)
    rng = np.random.default_rng(6)
    ns = nstate(lmax)
    x, e, b = ((rng.normal(size=(2, ns)) * ell_mask_state(lmax, 2))
               .astype(pair.np_cd) for _ in range(3))
    j_idx = np.array([2, 4, 5, 8, 11, 15, 16])
    seg = np.zeros((7, 3))
    seg[np.arange(7), [0, 0, 1, 1, 1, 2, 2]] = 1.0
    t = pair.t
    for sg in (None, seg):
        r0 = jit(lambda x: js.ring_cs_lsel_spin0(x, j_idx, sg), x)
        for a, r in zip(ts.ring_cs_lsel_spin0(t(x), j_idx, sg), r0):
            pair.close(a, r, f"lsel spin0 seg={sg is not None}", stage=True)
        r2 = jit(lambda e, b: js.ring_cs_lsel_spin2(e, b, j_idx, sg), e, b)
        m2 = ts.ring_cs_lsel_spin2(t(e), t(b), j_idx, sg)
        for (a1, a2), (r1, r2_) in zip(m2, r2):
            pair.close(a1, r1, f"lsel spin2 seg={sg is not None}", stage=True)
            pair.close(a2, r2_, f"lsel spin2 seg={sg is not None}",
                       stage=True)


def tables_hold_the_table_dtype(pair):
    """``make_sht`` stores lam0, lam_p2 / lam_m2 (dense) and lam_w / lam_x
    (split) in the table dtype, the split's equator rows apart in the
    compute dtype, each entry numpy's one rounding of the float64 table;
    the DFT matrices hold table-dtype values (in the wider dtype)."""
    np_td = np.dtype(str(pair.td)[6:])
    for split in (False, True):
        kw = dict(dtype=pair.cd, spin2=True, device="cpu", ring_split=split)
        tt = make_sht(16, table_dtype=pair.td, **kw)
        ref = make_sht(16, table_dtype=torch.float64, dtype=torch.float64,
                       spin2=True, device="cpu", ring_split=split)
        names = ("lam0", "lam_w", "lam_x") if split else ("lam0", "lam_p2",
                                                           "lam_m2")
        for name in names:
            a, r = getattr(tt, name), getattr(ref, name)
            assert a.dtype == pair.td
            want = r.numpy().astype(np_td)
            if split:
                want[:, :, -1] = 0
            assert np.array_equal(a.numpy(), want), name
        assert set(tt.eq_rows) == (set(names) if split else set())
        for name, row in tt.eq_rows.items():
            assert row.dtype == pair.cd
            assert torch.equal(row, getattr(ref, name)[:, :, -1].to(pair.cd))
        dft = make_sht(16, dtype=torch.float64, device="cpu").dft_cos
        assert np.array_equal(tt.dft_cos.to(torch.float64).numpy(),
                              dft.numpy().astype(np_td).astype(np.float64))


def model_tables_equal_jax(pair, tol=0.0):
    """``interop.model_from_numpy`` with the pair's "table_dtype" (its
    name) builds the JAX model's tables: the full grid's spin-2 tables to
    ``tol`` of their max (0: bit for bit) and its DFT matrices bit for
    bit."""
    from gibbssampler_tpu.inference import example_dl
    from gibbssampler_tpu.inference import simulate_dataset as jax_simulate
    from gibbssampler_tpu_torch.interop import model_from_numpy
    lmax = 16
    grid = jax_gl(lmax)
    fields = np.stack([example_dl(lmax, "ee"), example_dl(lmax, "bb")])
    sht = JaxSHT(grid, lmax, dtype=pair.jcd, spin2=True,
                 table_dtype=pair.jtd)
    model, _ = jax_simulate(jax.random.PRNGKey(0), lmax, spin=2,
                            dl_fields=fields, noise_sigma2=0.5,
                            fwhm_radians=0.05, dtype=pair.jcd, sht=sht)
    arrays = dict(jax_model_arrays(model), table_dtype=str(pair.td)[6:])
    tm = model_from_numpy(arrays, device="cpu", dtype=pair.cd)
    assert tm.sht.table_dtype == pair.td and tm.sht.dtype == pair.cd
    for name in ("lam_p2", "lam_m2"):
        a = getattr(tm.sht, name)
        r = np.asarray(getattr(model.sht, name)[0])
        assert a.dtype == pair.td and r.dtype == np.dtype(str(pair.td)[6:])
        err = np.abs(a.numpy().astype(np.float64) - r).max()
        assert err <= tol * np.abs(r).max(), (name, err)
    for name in ("dft_cos", "dft_sin"):
        r = np.asarray(getattr(model.sht, name)).astype(np.float64)
        assert np.array_equal(getattr(tm.sht, name).double().numpy(), r)


# ---------------------------------------------------------------------------
# the band cut model: the table engine's W tables and cg_cr
# ---------------------------------------------------------------------------

def band_models(pair, noise=0.5, cut=0.3, amp=10.0, beam=0.05):
    """A spin-2 band-masked GL dataset at lmax 16 on the pair's tables, in
    the JAX package (its cut decomposition) and in the port (built by
    ``interop.model_from_numpy`` from the JAX arrays, the table dtype as a
    numpy dtype)."""
    from gibbssampler_tpu.inference import example_dl
    from gibbssampler_tpu.inference import simulate_dataset as jax_simulate
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu_torch.interop import model_from_numpy
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    grid = jax_gl(LMAX_CUT)
    keep = (np.abs(np.pi / 2 - grid.theta) > cut).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    fields = np.stack([example_dl(LMAX_CUT, "ee", amp=amp),
                       example_dl(LMAX_CUT, "bb", amp=amp)])
    sht = JaxSHT(grid, LMAX_CUT, dtype=pair.jcd, spin2=True,
                 table_dtype=pair.jtd)
    model, _ = jax_simulate(jax.random.PRNGKey(0), LMAX_CUT, spin=2,
                            dl_fields=fields, noise_sigma2=noise,
                            fwhm_radians=beam, mask=mask, dtype=pair.jcd,
                            sht=sht)
    mc = jax_cut(model)
    arrays = dict(jax_model_arrays(model), table_dtype=np.dtype(pair.jtd))
    tc = with_cut_decomposition(model_from_numpy(arrays, device="cpu",
                                                 dtype=pair.cd))
    assert mc.cut_sht.table_dtype == pair.jtd
    assert tc.cut_sht.table_dtype == tc.sht.table_dtype == pair.td
    assert tc.cut_sht.lam_p2.dtype == pair.td and tc.cut_sht.dtype == pair.cd
    return mc, tc, fields


def w_tables_vs_jax(pair, mc, tc):
    """``_prepare_tchunks`` on the cut tables against the JAX package's
    (with and without the Nyquist split of the m = lmax column)."""
    from gibbssampler_tpu.samplers import cls_samplers as jcs
    from gibbssampler_tpu_torch.samplers import cls_samplers as tcs
    w1 = tc.w_cut[0, :, 0]
    chunks = [(1, np.array([4, 7, 8, 12, LMAX_CUT]), None, None, None)]
    for nyq in (False, True):
        mine = tcs._prepare_tchunks(tc, tc.cut_sht, chunks, w1, pair.cd,
                                    nyq=nyq)
        ref = jit(lambda w: [c[1:] for c in jcs._prepare_tchunks(
            mc, mc.cut_sht, chunks, w, pair.jcd, nyq=nyq)], n(w1))
        for (kind, lamA, lamB, W, _om, lnyq), rk in zip(mine, ref):
            assert kind == "s2"
            rk = (kind,) + tuple(rk)
            pairs = [(lamA, rk[1]), (lamB, rk[2]), (W, rk[3])]
            if nyq:
                pairs += [(lnyq[0], rk[5][0]), (lnyq[1], rk[5][1])]
            for k, (a, r) in enumerate(pairs):
                assert a.dtype == pair.cd
                pair.close(a, np.asarray(r, np.float64), f"nyq={nyq} [{k}]",
                           stage=True)


def cg_cr_vs_jax(pair, mc, tc, fields, tol, nch=3, iters=20):
    """``cg_cr`` of ``nch`` chains, each with its own prior, for exactly
    ``iters`` iterations (tol 0: no tolerance stop), against JAX's vmapped
    ``cg_cr`` on the same noise pools, to ``tol`` of max|ref|; both count
    ``iters`` iterations a chain."""
    from gibbssampler_tpu.harmonics import variance_expansion_state as jvar
    from gibbssampler_tpu.samplers import cr as jcr
    from gibbssampler_tpu_torch.samplers import cr as tcr
    rng = np.random.default_rng(7)
    var = np.stack([np.asarray(jvar(jnp.asarray(f), LMAX_CUT))
                    for f in fields])
    var = var[None] * np.exp(0.5 * rng.normal(size=(nch, 1, 1)))
    pool = {"state": rng.normal(size=(nch, 1, mc.nfields, mc.nstate)),
            "pix": rng.normal(size=(nch, 1) + tuple(mc.noise.tau.shape))}
    var = var.astype(pair.np_cd)
    pool = {k: v.astype(pair.np_cd) for k, v in pool.items()}
    keys = jax.random.split(jax.random.PRNGKey(5), nch)
    bt = mc.bt_ninv_d()
    ref = jax.jit(jax.vmap(lambda k, v, p: jcr.cg_cr(
        k, mc, v, bt, tol=0.0, maxiter=iters, noise=p)))(
            keys, jnp.asarray(var),
            {k: jnp.asarray(v) for k, v in pool.items()})
    mine = tcr.cg_cr(tc, pair.t(var), tc.bt_ninv_d(), tol=0.0, maxiter=iters,
                     noise={k: pair.t(v) for k, v in pool.items()})
    assert (n(mine[1].extra) == iters).all()
    np.testing.assert_array_equal(n(mine[1].extra), np.asarray(ref[1].extra))
    err = rel_err(mine[0], ref[0]).max()
    assert err <= tol, f"cg_cr state: {err:.3g} max|ref| > {tol}"


# the ASIS band slice of tests/test_torch_bf16.py: EE one block, BB a
# 4-bin block and seven 2-bin blocks
ASIS_BINS = [np.arange(2, LMAX_CUT + 2),
             np.array([2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 17])]
ASIS_BLOCKS = [[(0, LMAX_CUT - 1)],
               [(0, 3)] + [(i, i + 1) for i in range(3, 10)]]


def asis_steps_vs_jax(pair, mc, tc, fields, n_steps=3, nch=4, tol=2e-4):
    """``n_steps`` ASIS iterations of ``nch`` chains on the band cut model
    (table engine), the JAX scheme's jitted vmapped step against the
    port's on the same pools, MALA uniforms, gamma variates and MH
    uniforms, each iteration from its own state: the CR and MH accepts
    equal (a flip fails naming the chains, blocks and the log-uniform the
    two log-ratios straddle), the state and D_ell within ``tol`` of
    max|ref| (programs whose sums run in other orders, through an MH sweep
    that feeds each block's accepted state to the next).  Runs the JAX
    side as the compute dtype's programs run: with x64 off under float32
    (the caller sets it)."""
    from gibbssampler_tpu.harmonics.spectra import bin_sum as jax_bin_sum
    from gibbssampler_tpu.schemes import ASISGibbs as JaxASIS
    from gibbssampler_tpu.schemes import GibbsState as JaxState
    from gibbssampler_tpu_torch.interop import state_from_numpy
    from gibbssampler_tpu_torch.schemes import ASISGibbs
    from torch_parity import jax_mh_uniforms
    dl0 = [np.array([f[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])])
           for f, b in zip(fields, ASIS_BINS)]
    sig = [0.3 * d for d in dl0]
    kw = dict(n_iter_mh=1, cr_method="aux_mala",
              cr_options={"n_gibbs": 1, "tau": 0.02})
    jsch = JaxASIS(mc, ASIS_BINS, ASIS_BLOCKS, sig, **kw)
    tsch = ASISGibbs(tc, ASIS_BINS, ASIS_BLOCKS, sig, **kw)
    assert tsch.mh_plan.engine == "table"
    dls = tuple(np.tile(d, (nch, 1)).astype(pair.np_cd) for d in dl0)
    var = np.asarray(jit(jax.vmap(jsch.var_cls),
                         tuple(jnp.asarray(d) for d in dls)))
    s0 = (np.sqrt(var) * np.random.default_rng(0).normal(size=var.shape)
          ).astype(pair.np_cd)
    jstep = jax.jit(jax.vmap(jsch.step))
    jstate = JaxState(s=jnp.asarray(s0), dl=tuple(jnp.asarray(d)
                                                  for d in dls))
    tstate = state_from_numpy(s0, dls, device="cpu", dtype=pair.cd)
    ell = jnp.arange(LMAX_CUT + 1, dtype=pair.jcd)
    alphas = []
    for b in ASIS_BINS:
        a = jax_bin_sum(2.0 * ell + 1.0, b, LMAX_CUT) / 2.0 - 1.0
        alphas.append(jnp.where(a <= 0, 1.0, a))
    ntot = sum(len(b) - 1 for b in ASIS_BINS)
    nblocks = sum(map(len, ASIS_BLOCKS))
    offs = np.cumsum([0] + [len(b) for b in ASIS_BLOCKS])
    rng = np.random.default_rng(1)
    for it in range(n_steps):
        pool = {"state": rng.normal(size=(nch, 2, 2, tc.nstate)),
                "aux": rng.normal(size=(nch, 1) + tuple(tc.w_cut.shape))}
        pool = {k: v.astype(pair.np_cd) for k, v in pool.items()}
        keys = jax.random.split(jax.random.PRNGKey(100 + it), nch)
        jstate, jinfo = jstep(keys, jstate,
                              {k: jnp.asarray(v) for k, v in pool.items()})
        u, gam, up, ua = [], [[], []], [], []
        for key in keys:
            k1, k2, k3 = jax.random.split(key, 3)
            ka = jax.random.split(jax.random.split(k1)[1])[1]
            u.append(float(jax.random.uniform(ka, dtype=pair.jcd)))
            for f, kf in enumerate(jax.random.split(k2, 2)):
                gam[f].append(np.asarray(jax.random.gamma(kf, alphas[f])))
            p_, a_ = jax_mh_uniforms(k3, 1, ntot, nblocks)
            up.append(p_)
            ua.append(a_)
        tstate, tinfo = tsch.step(
            tstate, noise={k: pair.t(v) for k, v in pool.items()},
            u=pair.t(u), gammas=tuple(pair.t(g) for g in gam),
            u_prop=pair.t(up), u_acc=pair.t(ua))
        log_ua = np.log(np.asarray(ua))[:, 0]            # (chains, blocks)
        for what, mine, ref, log_u in (
                [("CR", tinfo["cr_accept"], jinfo["cr_accept"], np.log(u))]
                + [(f"MH field {f}", tinfo["mh_accept"][f],
                    jinfo["mh_accept"][f], log_ua[:, offs[f]: offs[f + 1]])
                   for f in range(2)]):
            mine = n(mine).reshape(np.shape(log_u))
            ref = np.asarray(ref).reshape(np.shape(log_u))
            bad = np.argwhere(mine != ref)
            assert bad.size == 0, (
                f"iteration {it} {what} accept flipped at (chain, block) "
                f"{bad.tolist()}: the port's and JAX's log-ratios straddle "
                f"log u = {[float(log_u[tuple(i)]) for i in bad]}")
        for what, mine, ref in [("s", tstate.s, jstate.s),
                                ("dl[0]", tstate.dl[0], jstate.dl[0]),
                                ("dl[1]", tstate.dl[1], jstate.dl[1])]:
            err = rel_err(mine, ref).max()
            assert err <= tol, f"iteration {it} {what}: {err:.3g} > {tol}"
