"""The port's m-sharded SHT (parallel.shard_sht) and the kernels' m-slab
form: the slab plain versions against the full table's rows, the row
assignment, the sharded transforms against the JAX package's unsharded
ones, and the m-sharded Gibbs, CR and ASIS runs against the unsharded port
(counterparts of tests/test_parallel.py's m-axis tests), in gloo processes
on the CPU (tests/torch_parallel_workers.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as tpw
from torch_parity import jax_model_arrays, make_masked, t64, tri_table
from gibbssampler_tpu.harmonics import ell_mask_state, nstate
from gibbssampler_tpu.inference import example_dl, simulate_dataset
from gibbssampler_tpu.sht import make_sht as jax_make_sht
from gibbssampler_tpu.sht.healpix import make_healpix_sht as jax_healpix
from gibbssampler_tpu_torch.parallel import m_rows, shard_sht
from gibbssampler_tpu_torch.sht import PointSHT
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

LMAX = 9          # L = 10: not divisible by 4, as in tests/test_parallel.py
ATOL = 1e-12


def _row_bound(L, n_m):
    return 2 * math.ceil(L / (2 * n_m)) + 1


# ---------------------------------------------------------------------------
# the row assignment and the slab form's plain versions (one process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,n_m", [(10, 1), (10, 2), (10, 4), (513, 2),
                                   (513, 4), (7, 3), (3, 4), (64, 5)])
def test_m_rows_deal_pairs_within_the_bound(L, n_m):
    """Every degree order on exactly one process; rows i and M-1-i hold a
    pair (m, L-1-m) (the middle row of an odd M is L // 2 alone); at most
    2 ceil(L / (2 n_m)) + 1 rows each, equal work (L + 1 degree rows a
    pair) within one pair between processes."""
    rows = m_rows(L, n_m)
    assert len(rows) == n_m
    assert sorted(m for r in rows for m in r) == list(range(L))
    for r in rows:
        M = len(r)
        assert M <= _row_bound(L, n_m)
        for i in range(M // 2):
            assert r[i] + r[M - 1 - i] == L - 1
            assert r[i] < r[M - 1 - i]
        if M % 2:
            assert r[M // 2] == L // 2
    work = [sum(L - m for m in r) for r in rows]
    assert max(work) - min(work) <= L + 1
    if (L, n_m) == (513, 2):    # the two-way split of the lmax-512 tables
        assert [len(r) for r in rows] == [257, 256]


def _slab_case(seed, L=11, nr=5, C=3, M=6):
    rng = np.random.default_rng(seed)
    lam = tri_table(L, nr, seed=seed)
    ms = rng.choice(L, size=M, replace=False).astype(np.int32)
    x = rng.normal(size=(L, C, L))
    g = rng.normal(size=(L, nr, C))
    return lam, ms, x, g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slab_plain_versions_equal_the_full_tables_rows(seed):
    """For random ms, each slab result equals the matching rows of the
    full-table result; the wrappers on CPU tensors take the plain slab
    form.  The plain slab versions zero l < ms[i] themselves: a table with
    garbage in its zero triangle gives the same result."""
    lam, ms, x, g = _slab_case(seed)
    full_s = lk.legendre_synth_tri_plain(t64(lam), t64(x))
    full_a = lk.legendre_adj_tri_plain(t64(lam), t64(g))
    msi = torch.as_tensor(ms)
    junk = lam + np.random.default_rng(seed + 7).normal(size=lam.shape) * (
        np.arange(lam.shape[0])[None, :, None]
        < np.arange(lam.shape[0])[:, None, None])
    for tab in (lam, junk):
        s = lk.legendre_synth_tri_plain(t64(tab[ms]), t64(x[ms]), msi)
        a = lk.legendre_adj_tri_plain(t64(tab[ms]), t64(g[ms]), msi)
        np.testing.assert_allclose(s.numpy(), full_s.numpy()[ms], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(a.numpy(), full_a.numpy()[ms], rtol=0,
                                   atol=1e-12)
    lk.reset_launch_counts()
    ws = lk.legendre_synth_tri(t64(lam[ms]), t64(x[ms]), msi)
    wa = lk.legendre_adj_tri(t64(lam[ms]), t64(g[ms]), msi)
    assert torch.equal(ws, lk.legendre_synth_tri_plain(t64(lam[ms]),
                                                       t64(x[ms]), msi))
    assert torch.equal(wa, lk.legendre_adj_tri_plain(t64(lam[ms]),
                                                     t64(g[ms]), msi))
    assert wa.transpose(0, 1).is_contiguous()   # (C, M, L) memory
    assert (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches,
            sum(lk.legendre_synth_tri.slabs.values())) == (0, 0, 0)


def test_slab_wrappers_reject_bad_ms():
    lam, ms, x, g = _slab_case(0)
    L = lam.shape[0]
    sl, sx = t64(lam[ms]), t64(x[ms])
    with pytest.raises(ValueError):           # int64, not int32
        lk.legendre_synth_tri(sl, sx, torch.as_tensor(ms, dtype=torch.int64))
    with pytest.raises(ValueError):           # one row short
        lk.legendre_synth_tri(sl, sx, torch.as_tensor(ms[:-1]))
    with pytest.raises(ValueError):           # a degree order >= L
        bad = ms.copy()
        bad[0] = L
        lk.legendre_adj_tri(sl, t64(g[ms]), torch.as_tensor(bad))
    with pytest.raises(ValueError):           # M rows need ms
        lk.legendre_synth_tri(sl, sx)
    with pytest.raises(ValueError):           # more rows than L
        big = np.concatenate([ms, ms])
        lk.legendre_synth_tri(t64(lam[big]), t64(x[big]),
                              torch.as_tensor(np.concatenate([ms, ms])))


@pytest.mark.parametrize("what", ["object", "sharded"])
def test_shard_sht_refuses_what_is_no_unsharded_transform(what):
    """shard_sht takes an unsharded Legendre transform; anything else, an
    m-sharded copy too, raises TypeError before the mesh is read."""
    from gibbssampler_tpu_torch.parallel.sharding import _sharded_class
    arg = (object() if what == "object" else
           _sharded_class(PointSHT).__new__(_sharded_class(PointSHT)))
    with pytest.raises(TypeError):
        shard_sht(arg, None)


# ---------------------------------------------------------------------------
# the m-sharded transforms against JAX's unsharded ones
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def masked_spin2():
    """tests/test_cut.py's band-masked spin-2 dataset at lmax 9: the JAX
    model and its cut decomposition."""
    model, cut, _ = make_masked(spin=2, sigma2=0.5, lmax=LMAX)
    return model, cut


def _jax_transform(kind, masked):
    if kind == "gl":
        return jax_make_sht(LMAX, dtype=jnp.float64, spin2=True)
    if kind == "healpix":
        return jax_healpix(8, LMAX, dtype=jnp.float64, spin2=True)
    return masked[1].cut_sht


def _map_shape(js):
    return ((js.geo.npix,) if hasattr(js, "geo")
            else (js.grid.nrings, js.grid.nphi))


@pytest.mark.parametrize("n_m", [2, 4])
@pytest.mark.parametrize("kind", ["gl", "healpix", "cut"])
def test_m_sharded_transforms_match_jax(tmp_path, masked_spin2, kind, n_m):
    """Spin-0 and spin-2 synthesis, analysis and adjoint of the m-sharded
    transform equal the JAX package's unsharded one (<= 1e-12) on every
    process; each process holds at most 2 ceil(L / (2 n_m)) + 1 of the L
    rows of every table, and together they hold each row once."""
    js = _jax_transform(kind, masked_spin2)
    rng = np.random.default_rng(hash((kind, n_m)) % 2 ** 32)
    ns, shp = nstate(LMAX), _map_shape(js)
    x = rng.normal(size=(2, ns)) * ell_mask_state(LMAX, 0)
    e, b = (rng.normal(size=(2, ns)) * ell_mask_state(LMAX, 2)
            for _ in range(2))
    f, q, u = (rng.normal(size=(2,) + shp) for _ in range(3))
    res = tpw.spawn(tpw.sht_transforms, n_m, tmp_path, kind, LMAX,
                    jax_model_arrays(masked_spin2[0]), x, f, e, b, q, u)
    J = jnp.asarray
    syn_q, syn_u = js.synthesis_spin2_state(J(e), J(b))
    adj_e, adj_b = js.adjoint_synthesis_spin2_state(J(q), J(u))
    ana_e, ana_b = js.analysis_spin2_state(J(q), J(u))
    ref = {"syn0": js.synthesis_state(J(x)),
           "adj0": js.adjoint_synthesis_state(J(f)),
           "ana0": js.analysis_state(J(f)),
           "syn_q": syn_q, "syn_u": syn_u, "adj_e": adj_e, "adj_b": adj_b,
           "ana_e": ana_e, "ana_b": ana_b}
    L = LMAX + 1
    for out in res:
        for k, want in ref.items():
            np.testing.assert_allclose(out[k], np.asarray(want), rtol=0,
                                       atol=ATOL, err_msg=f"{kind} {k}")
        assert (out["rows"] <= _row_bound(L, n_m)).all()
        assert (out["rows"] == len(out["ms"])).all()
    assert sorted(np.concatenate([o["ms"] for o in res]).tolist()) \
        == list(range(L))


# ---------------------------------------------------------------------------
# m-sharded runs against the unsharded port
# ---------------------------------------------------------------------------

def _check_sharded_run(res, nfields, mesh, keys=("dl", "cr_accept")):
    """Each process's chains equal the unsharded port run of its chains
    (rtol 1e-7, atol 1e-10, as tests/test_parallel.py) and are equal on
    every process of its m group."""
    names = [f"dl{f}" for f in range(nfields)] + [
        k for k in keys if k != "dl"]
    for out in res:
        for k in names:
            np.testing.assert_allclose(out[f"s_{k}"], out[f"u_{k}"],
                                       rtol=1e-7, atol=1e-10, err_msg=k)
            assert np.isfinite(out[f"s_{k}"]).all()
    for c in range(mesh[0]):
        group = [o for o in res if o["coord"][0] == c]
        assert len(group) == mesh[1]
        for o in group[1:]:
            for k in names:
                np.testing.assert_array_equal(o[f"s_{k}"],
                                              group[0][f"s_{k}"])


def _dataset(key, spin, lmax=LMAX, mask=None):
    kinds = {0: ["tt"], 2: ["ee", "bb"], 3: ["tt", "ee", "bb"]}[spin]
    fields = np.stack([example_dl(lmax, k, amp=10.0) for k in kinds])
    model, _ = simulate_dataset(jax.random.PRNGKey(key), lmax, spin=spin,
                                dl_fields=fields, noise_sigma2=0.5
                                if spin else 1.0, mask=mask,
                                dtype=jnp.float64)
    return jax_model_arrays(model), fields


def test_m_sharded_gibbs_step(tmp_path):
    """CenteredGibbs with the cg CR on a (2, 2) mesh: the m-sharded chains
    equal the unsharded port run (tests/test_parallel.py:54)."""
    arrays, fields = _dataset(3, 0)
    bins = np.arange(2, LMAX + 2)
    spec = {"mesh": (2, 2), "scheme": "centered", "cr": "cg",
            "opts": {"cg_tol": 1e-9, "cg_maxiter": 200}, "bins": [bins],
            "dl0": (fields[0][2:],), "nchains": 4, "n_iter": 10, "seed": 4}
    res = tpw.spawn(tpw.sharded_chains, 4, tmp_path, arrays, spec)
    assert res[0]["s_dl0"].shape == (2, 10, LMAX - 1)
    assert not np.array_equal(res[0]["s_dl0"], res[-1]["s_dl0"])
    _check_sharded_run(res, 1, spec["mesh"])


@pytest.mark.parametrize("method,spin", [("cg", 2), ("rjpo", 2), ("cg", 3)])
def test_m_sharded_cr_matches_unsharded(tmp_path, method, spin):
    """cg / rjpo CR solves with the tables split over 4 processes (L 10,
    not divisible by 4) reproduce the unsharded chains
    (tests/test_parallel.py:133)."""
    arrays, fields = _dataset(5, spin)
    bins = np.arange(2, LMAX + 2)
    nf = len(fields)
    spec = {"mesh": (1, 4), "scheme": "centered", "cr": method,
            "opts": {"cg_tol": 1e-10, "cg_maxiter": 400},
            "bins": [bins] * nf,
            "dl0": tuple(np.maximum(f[2:], 1e-6) for f in fields),
            "nchains": 2, "n_iter": 8, "seed": 6}
    res = tpw.spawn(tpw.sharded_chains, 4, tmp_path, arrays, spec)
    for out in res:
        assert (out["rows"] <= _row_bound(LMAX + 1, 4)).all()
    _check_sharded_run(res, nf, spec["mesh"])


def test_sharded_cut_fastpath_matches_unsharded(tmp_path):
    """The flagship configuration (cut decomposition, the rank-one blocked
    MH, overrelaxed CR) with both transforms m-sharded, chains and m
    sharded on a (2, 2) mesh over 4 processes, reproduces the unsharded
    port's chains (tests/test_parallel.py:167)."""
    from gibbssampler_tpu.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(LMAX)
    lat = np.abs(np.pi / 2 - grid.theta)
    mask = np.broadcast_to((lat > 0.3)[:, None],
                           (grid.nrings, grid.nphi)).astype(np.float64)
    arrays, fields = _dataset(7, 2, mask=mask)
    bins = np.arange(2, LMAX + 2)
    nb = len(bins) - 1
    blocks = [[(0, nb)], [(0, nb // 2)] + [(i, i + 1)
                                           for i in range(nb // 2, nb)]]
    spec = {"mesh": (2, 2), "scheme": "asis", "cr": "overrelax", "cut": True,
            "bins": [bins] * 2, "blocks": blocks,
            "sig": [np.maximum(np.abs(f[2:]), 1e-5) * 0.4 for f in fields],
            "dl0": tuple(np.maximum(f[2:], 1e-6) for f in fields),
            "nchains": 4, "n_iter": 10, "seed": 8}
    res = tpw.spawn(tpw.sharded_chains, 4, tmp_path, arrays, spec)
    for out in res:
        assert out["cut_mh"].all()          # both on the rank-one fast path
    _check_sharded_run(res, 2, spec["mesh"], keys=("dl", "cr_accept", "mh0",
                                                   "mh1"))
