"""Helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through the JAX package
and the port; arrays cross between the two only as numpy.  Everything runs
in float64 on the CPU with one torch thread (the suite runs several pytest
workers side by side).  jax is imported only inside the helpers that build
JAX models, so the card cases also run where jax is not installed
(``python -m pytest --noconftest tests/test_torch_legendre_kernels.py``).
"""

import numpy as np
import pytest
import torch

from gibbssampler_tpu_torch.interop import model_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition

torch.set_num_threads(1)

LMAX = 10


def t64(a) -> torch.Tensor:
    """numpy / jax array -> float64 CPU tensor."""
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def n(a) -> np.ndarray:
    """tensor / jax array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def tri_table(L, nr, seed=0, integer=False) -> np.ndarray:
    """(L, L, nr) float64 table [m, l, r], zero for l < m.  ``integer``
    draws small integers, whose products and sums every float type holds
    exactly (so a float32-output kernel compares at float64 tolerance)."""
    rng = np.random.default_rng(seed)
    lam = (rng.integers(-3, 4, size=(L, L, nr)).astype(np.float64) if integer
           else rng.normal(size=(L, L, nr)))
    return lam * (np.arange(L)[None, :, None] >= np.arange(L)[:, None, None])


def make_masked(spin=0, sigma2=1.0, band=0.3, seed=0, fwhm=0.05, lmax=LMAX):
    """The JAX model pair of tests/test_cut.py::make_masked: a band-masked
    dataset on the GL grid, plain and with the cut decomposition."""
    import jax
    import jax.numpy as jnp
    from gibbssampler_tpu.inference import example_dl, simulate_dataset
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(lmax)
    lat = np.abs(np.pi / 2 - grid.theta)
    keep = (lat > band).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    fields = (example_dl(lmax, amp=10.0)[None] if spin == 0 else
              np.stack([example_dl(lmax, "ee", amp=10.0),
                        example_dl(lmax, "bb", amp=10.0)]))
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), lmax, spin=spin,
                                dl_fields=fields, noise_sigma2=sigma2,
                                fwhm_radians=fwhm, mask=mask,
                                dtype=jnp.float64)
    return model, jax_cut(model), fields


def jax_model_arrays(model) -> dict:
    """The fields ``interop.model_from_numpy`` takes, from a JAX SkyModel
    on the Gauss-Legendre or the HEALPix grid."""
    out = {"d": np.asarray(model.d), "tau": np.asarray(model.noise.tau),
           "q_map": np.asarray(model.noise.q_map),
           "omega": model.noise.omega, "bl": np.asarray(model.bl),
           "spin": model.spin}
    if hasattr(model.sht, "geo"):
        out.update(grid="healpix", nside=model.sht.nside,
                   layout=model.sht.layout)
        return out
    g = model.sht.grid
    out.update(theta=g.theta, weights=g.weights, phi0=g.phi0, nphi=g.nphi)
    return out


def port_model(jax_model, cut=False, sparse_split=None):
    """The port's model of the same dataset on the CPU (optionally
    cut-decomposed, with ``sparse_split`` as in with_cut_decomposition)."""
    m = model_from_numpy(jax_model_arrays(jax_model), device="cpu")
    return with_cut_decomposition(m, sparse_split) if cut else m


def holey_mask(grid, seed=3, nholes=6, band=0.25, apo=0.15):
    """Apodized band + square holes at random positions: the planckish
    shape at toy scale (tests/test_sparse.py::holey_mask)."""
    lat = np.abs(np.pi / 2 - grid.theta)
    x = np.clip((lat - band) / apo, 0.0, 1.0)
    keep = 0.5 - 0.5 * np.cos(np.pi * x)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi)).copy()
    rng = np.random.default_rng(seed)
    for _ in range(nholes):
        r = rng.integers(0, grid.nrings)
        c = rng.integers(0, grid.nphi)
        mask[max(0, r - 1): r + 2, max(0, c - 1): c + 2] = 0.0
    return mask


def make_holey(spin=2, sigma2=0.5, seed=0, lmax=16, mask=None):
    """The JAX model pair of tests/test_sparse.py::make_holey: a dataset on
    the GL grid under ``holey_mask`` (or ``mask``), plain and with the
    floor + sparse-hole split."""
    import jax
    import jax.numpy as jnp
    from gibbssampler_tpu.inference import example_dl, simulate_dataset
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu.sht import gauss_legendre_grid
    grid = gauss_legendre_grid(lmax)
    mask = holey_mask(grid) if mask is None else mask
    fields = (example_dl(lmax, amp=10.0)[None] if spin == 0 else
              np.stack([example_dl(lmax, "ee", amp=10.0),
                        example_dl(lmax, "bb", amp=10.0)]))
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), lmax, spin=spin,
                                dl_fields=fields, noise_sigma2=sigma2,
                                fwhm_radians=0.05, mask=mask,
                                dtype=jnp.float64)
    return model, jax_cut(model, sparse_split=True), fields


def jax_mh_uniforms(key, n_iter, ntot, nblocks):
    """The uniforms the JAX blocked-MH samplers draw from ``key``, as the
    port takes them: (n_iter, ntot) proposal uniforms and (n_iter,
    nblocks) block-accept uniforms.  Per sweep key k: kp, ka = split(k);
    truncated_normal(kp) draws uniform(kp, (ntot,)); block b's uniform is
    uniform(split(ka, nblocks)[b])."""
    import jax
    import jax.numpy as jnp
    up, ua = [], []
    for k in jax.random.split(key, n_iter):
        kp, ka = jax.random.split(k)
        up.append(np.asarray(jax.random.uniform(kp, (ntot,),
                                                dtype=jnp.float64)))
        ua.append(np.asarray(jax.vmap(
            lambda kk: jax.random.uniform(kk, dtype=jnp.float64))(
                jax.random.split(ka, nblocks))))
    return np.stack(up), np.stack(ua)


def valid_normal(rng, shape, lmax, lmin=2) -> np.ndarray:
    """N(0, 1) state values on the valid slots with l >= lmin, 0 elsewhere
    (a whitened map's support)."""
    from gibbssampler_tpu_torch.harmonics import ell_mask_state
    return rng.normal(size=shape) * ell_mask_state(lmax, lmin)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda", 0)


def planckish_mask(grid, nholes=200, seed=5):
    """bench.py's planckish GL mask (bench.py:190-211): an apodized
    +-11.5 deg band with a 3 deg cosine ramp, plus ``nholes`` holes of
    0.35 deg radius at random positions over the sphere."""
    lat = np.abs(np.pi / 2 - grid.theta)
    b0, apo = np.radians(11.5), np.radians(3.0)
    x = np.clip((lat - b0) / apo, 0.0, 1.0)
    keep = 0.5 - 0.5 * np.cos(np.pi * x)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi)).copy()
    rng = np.random.default_rng(seed)
    rhole = np.radians(0.35)
    phi = 2.0 * np.pi * np.arange(grid.nphi) / grid.nphi
    ct, st = np.cos(grid.theta), np.sin(grid.theta)
    for _ in range(nholes):
        ct0 = rng.uniform(-1.0, 1.0)
        st0 = np.sqrt(1.0 - ct0 * ct0)
        ph0 = rng.uniform(0.0, 2.0 * np.pi)
        cosd = (ct0 * ct[:, None]
                + st0 * st[:, None] * np.cos(phi[None, :] - ph0))
        mask[cosd > np.cos(rhole)] = 0.0
    return mask


def make_masked_healpix(spin=2, sigma2=0.5, band_deg=20.0, seed=0,
                        fwhm=0.05, nside=8, layout="padded"):
    """The JAX model pair of tests/test_cut.py::make_masked_healpix: a
    dataset on the HEALPix grid under a +-band_deg galactic band (whole
    belt rings), plain and with the cut decomposition."""
    import jax
    import jax.numpy as jnp
    from gibbssampler_tpu.inference import example_dl, simulate_dataset
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu.sht.healpix import make_healpix_sht
    from gibbssampler_tpu.sht.healpix_pix import galactic_band_mask
    lmax = 2 * nside
    sht = make_healpix_sht(nside, lmax, dtype=jnp.float64,
                           spin2=(spin >= 2), layout=layout)
    mask = galactic_band_mask(nside, band_deg)
    fields = (example_dl(lmax, amp=10.0)[None] if spin == 0 else
              np.stack([example_dl(lmax, "ee", amp=10.0),
                        example_dl(lmax, "bb", amp=10.0)]))
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), lmax, spin=spin,
                                dl_fields=fields, noise_sigma2=sigma2,
                                fwhm_radians=fwhm, mask=mask,
                                dtype=jnp.float64, sht=sht)
    return model, jax_cut(model), fields


def holey_healpix_mask(nside=8):
    """tests/test_sparse.py::make_holey_healpix's mask: a 20 deg band plus
    holes on a cap ring (all of the first ring), in the belt and on the
    south cap, in RING order."""
    from gibbssampler_tpu_torch.sht import galactic_band_mask
    mask = galactic_band_mask(nside, 20.0)
    mask[0:4] = 0.0
    mask[200:203] = 0.0
    mask[-3:] = 0.0
    return mask


def make_holey_healpix(spin=2, sigma2=0.5, seed=0, layout="padded",
                       sparse_split=True):
    """The JAX model of tests/test_sparse.py::make_holey_healpix (nside 8,
    lmax 16), plain and with the cut decomposition (split by default)."""
    import jax
    import jax.numpy as jnp
    from gibbssampler_tpu.inference import example_dl, simulate_dataset
    from gibbssampler_tpu.ops import with_cut_decomposition as jax_cut
    from gibbssampler_tpu.sht.healpix import make_healpix_sht
    nside, lmax = 8, 16
    sht = make_healpix_sht(nside, lmax, dtype=jnp.float64,
                           spin2=(spin >= 2), layout=layout)
    fields = (example_dl(lmax, amp=10.0)[None] if spin == 0 else
              np.stack([example_dl(lmax, "ee", amp=10.0),
                        example_dl(lmax, "bb", amp=10.0)]))
    model, _ = simulate_dataset(jax.random.PRNGKey(seed), lmax, spin=spin,
                                dl_fields=fields, noise_sigma2=sigma2,
                                fwhm_radians=0.1,
                                mask=holey_healpix_mask(nside),
                                dtype=jnp.float64, sht=sht)
    return model, jax_cut(model, sparse_split=sparse_split), fields


def planckish_healpix_mask(nside, nholes=200, seed=5):
    """bench.py's planckish HEALPix mask (bench.py:160-178) in RING order:
    an apodized +-11.5 deg band with a 3 deg cosine ramp, plus ``nholes``
    holes of 0.35 deg radius at random positions over the sphere."""
    from gibbssampler_tpu_torch.sht import pix2ang_ring
    theta, phi = pix2ang_ring(nside, np.arange(12 * nside * nside))
    lat = np.abs(np.pi / 2 - theta)
    b0, apo = np.radians(11.5), np.radians(3.0)
    x = np.clip((lat - b0) / apo, 0.0, 1.0)
    mask = 0.5 - 0.5 * np.cos(np.pi * x)
    rng = np.random.default_rng(seed)
    rhole = np.radians(0.35)
    ct, st = np.cos(theta), np.sin(theta)
    for _ in range(nholes):
        ct0 = rng.uniform(-1.0, 1.0)
        st0 = np.sqrt(1.0 - ct0 * ct0)
        ph0 = rng.uniform(0.0, 2.0 * np.pi)
        mask[ct0 * ct + st0 * st * np.cos(phi - ph0) > np.cos(rhole)] = 0.0
    return mask
