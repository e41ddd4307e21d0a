"""The port's spectra and grid-packed state helpers against the JAX
package's (float64, CPU)."""

import numpy as np
import jax.numpy as jnp
import torch

from torch_parity import n, t64
from gibbssampler_tpu import harmonics as jh
from gibbssampler_tpu.diagnostics import summarize_chains as jax_summary
from gibbssampler_tpu.inference import example_dl as jax_example_dl
from gibbssampler_tpu_torch import harmonics as th
from gibbssampler_tpu_torch.harmonics import spectra as tspectra
from gibbssampler_tpu_torch.diagnostics import summarize_chains
from gibbssampler_tpu_torch.inference import example_dl

LMAX = 16
BINS = np.array([2, 3, 5, 9, 14, 17])


def test_state_masks_match():
    a, b = th.state_masks(LMAX), jh.state_masks(LMAX)
    for name in ("valid", "in_scale", "out_scale", "state_of_flat",
                 "flat_of_state", "state_valid_flat"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(th.ell_mask_state(LMAX, 2),
                                  jh.ell_mask_state(LMAX, 2))


def test_spectra_and_state_ops_match():
    rng = np.random.default_rng(0)
    dl = np.abs(rng.normal(size=(3, LMAX + 1)))
    x = rng.normal(size=(3, th.nstate(LMAX)))
    binned = rng.normal(size=(3, len(BINS) - 1))
    pairs = [
        (th.dl_to_cl_factor(LMAX, t64(0).dtype), jh.dl_to_cl_factor(
            LMAX, jnp.float64)),
        (th.unfold_bins(t64(binned), BINS, LMAX),
         jh.unfold_bins(jnp.asarray(binned), BINS, LMAX)),
        (th.bin_sum(t64(dl), BINS, LMAX),
         jh.bin_sum(jnp.asarray(dl), BINS, LMAX)),
        (th.gauss_beam(0.05, LMAX, t64(0).dtype),
         jh.gauss_beam(0.05, LMAX, jnp.float64)),
        (th.variance_expansion_state(t64(dl), LMAX),
         jh.variance_expansion_state(jnp.asarray(dl), LMAX)),
        (th.almxfl_state(t64(x), t64(dl), LMAX),
         jh.almxfl_state(jnp.asarray(x), jnp.asarray(dl), LMAX)),
        (th.alm2cl_state(t64(x), LMAX),
         jh.alm2cl_state(jnp.asarray(x), LMAX)),
    ]
    for mine, ref in pairs:
        np.testing.assert_allclose(n(mine), n(ref), rtol=1e-14, atol=0)


def test_example_dl_and_summaries_match():
    for kind in ("tt", "ee", "bb"):
        np.testing.assert_array_equal(example_dl(LMAX, kind),
                                      jax_example_dl(LMAX, kind))
    chains = np.random.default_rng(1).normal(size=(4, 60, 3)).cumsum(axis=1)
    a, b = summarize_chains(chains), jax_summary(chains)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-14)


def test_constant_tables_are_copied_once():
    """The helpers' constant tables (dl -> cl factor, unfold gathers, bin
    sums, valid-slot masks) reach a device once: repeated calls add nothing
    to the cache and return the cached tensor."""
    dl = t64(np.abs(np.random.default_rng(2).normal(size=(2, LMAX + 1))))
    binned = t64(np.ones((2, len(BINS) - 1)))

    def calls():
        th.variance_expansion_state(dl, LMAX)
        th.unfold_bins(binned, BINS, LMAX)
        th.bin_sum(dl, BINS, LMAX)
        th.alm2cl_state(th.expand_cl_state(dl, LMAX), LMAX)

    calls()
    before = dict(tspectra._DEVICE_CONSTANTS)
    calls()
    assert tspectra._DEVICE_CONSTANTS == before
    assert th.dl_to_cl_factor(LMAX, torch.float64) is \
        th.dl_to_cl_factor(LMAX, torch.float64)
