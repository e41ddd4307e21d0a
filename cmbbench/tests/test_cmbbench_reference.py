"""The reference's transforms, pixelizations and masks against the measured
package on the CPU, in float64 (the tests may read the package; the
reference modules themselves do not import it)."""

import numpy as np
import pytest
import torch

from cmbbench import inputs as inp
from cmbbench.reference.sphere import FullRings, PointRings, spin2_tables

LMAX = 12
L = LMAX + 1


def _state(n, seed):
    from gibbssampler_tpu_torch.harmonics.gridstate import state_masks
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, 2, 2 * L * L), generator=g, dtype=torch.float64)
    return x * torch.as_tensor(state_masks(LMAX).valid.reshape(-1))


def test_spin2_tables_match_package():
    from gibbssampler_tpu_torch.sht.legendre import spin2_lambda_tables
    theta = np.array([0.05, 0.4, 1.2, 1.5707, 2.3, 3.1])
    lp, lm = spin2_lambda_tables(LMAX, theta)
    tab = spin2_tables(LMAX, torch.as_tensor(theta)).numpy()
    np.testing.assert_allclose(tab[0], lp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tab[1], lm, rtol=0, atol=1e-12)


@pytest.mark.parametrize("grid", ["gl", "healpix"])
def test_sky_synthesis_and_adjoint_match_package(grid):
    from gibbssampler_tpu_torch.sht import make_healpix_sht, make_sht
    if grid == "gl":
        sht = make_sht(LMAX, dtype=torch.float64, spin2=True, device="cpu")
        cfg = {"grid": {"kind": "gl"}, "lmax": LMAX}
    else:
        sht = make_healpix_sht(4, LMAX, dtype=torch.float64, spin2=True,
                               layout="ring", device="cpu")
        cfg = {"grid": {"kind": "healpix", "nside": 4}, "lmax": LMAX}
    pix = inp.pixelization(cfg)
    x = _state(3, 1)
    q, u = sht.synthesis_spin2_state(x[:, 0], x[:, 1])
    y = inp.sky_synth(LMAX, pix, x)
    np.testing.assert_allclose(y[:, 0], q.reshape(3, -1), atol=1e-12)
    np.testing.assert_allclose(y[:, 1], u.reshape(3, -1), atol=1e-12)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    a = inp.sky_adjoint(LMAX, pix, w)
    shape = q.shape[1:]
    ae, ab = sht.adjoint_synthesis_spin2_state(w[:, 0].reshape((3,) + shape),
                                               w[:, 1].reshape((3,) + shape))
    np.testing.assert_allclose(a[:, 0], ae, atol=1e-12)
    np.testing.assert_allclose(a[:, 1], ab, atol=1e-12)


def test_points_match_package():
    from gibbssampler_tpu_torch.sht.points import PointSHT
    th = np.array([0.4, 1.1, 2.5])
    ph = np.random.default_rng(1).uniform(0, 2 * np.pi, (3, 4))
    va = np.ones((3, 4))
    va[2, 3] = 0.0
    ps = PointSHT(th, ph, va, LMAX, dtype=torch.float64, spin0=False,
                  spin2=True, device="cpu")
    x = _state(2, 3)
    q, u = ps.synthesis_spin2_state(x[:, 0], x[:, 1])
    y = PointRings(LMAX, th, ph, va, "cpu").synth(x)
    np.testing.assert_allclose(y[:, 0], q, atol=1e-12)
    np.testing.assert_allclose(y[:, 1], u, atol=1e-12)


def test_full_rings_with_offsets_equal_points():
    th = np.array([0.7, 1.3])
    phi0 = np.array([0.0, 0.1])
    nphi = 2 * LMAX + 4
    j = np.arange(nphi)
    ph = phi0[:, None] + 2 * np.pi * j[None, :] / nphi
    x = _state(2, 4)
    a = FullRings(LMAX, th, nphi, phi0, "cpu").synth(x)
    b = PointRings(LMAX, th, ph, np.ones_like(ph), "cpu").synth(x)
    np.testing.assert_allclose(a, b.reshape(2, 2, -1), atol=1e-12)


@pytest.mark.parametrize("nside", [4, 16])
def test_healpix_pixelization_matches_package(nside):
    from gibbssampler_tpu_torch.sht import pix2ang_ring
    pix = inp.pixelization({"grid": {"kind": "healpix", "nside": nside},
                            "lmax": 2 * nside})
    th, ph = pix2ang_ring(nside, np.arange(12 * nside * nside))
    np.testing.assert_allclose(pix.theta[pix.ring_of_pixel()], th,
                               atol=1e-13)
    np.testing.assert_allclose(pix.phi_of_pixel(), ph, atol=1e-13)
    assert (pix.locate(th, ph) == np.arange(th.size)).all()


def test_masks_are_the_flagships():
    import json
    from cmbbench.harness import PKG
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.sht import make_sht
    gl = json.loads((PKG / "configs" / "gl_band.json").read_text())
    pix = inp.pixelization(gl)
    sht = make_sht(gl["lmax"], dtype=torch.float64, spin2=False,
                   device="cpu")
    ref = flagship.flagship_mask("gl", "band", sht)
    np.testing.assert_array_equal(inp.make_mask(gl, pix), ref.reshape(-1))
    hp = json.loads((PKG / "configs" / "healpix_planckish.json").read_text())
    pix = inp.pixelization(hp)
    ref = flagship.healpix_planckish_mask(hp["grid"]["nside"])
    np.testing.assert_allclose(inp.make_mask(hp, pix), ref, atol=1e-15)


def test_configs_are_the_flagships():
    import json
    from cmbbench.harness import PKG
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.interop import port_tuned_proposal_sigmas
    bins, blocks = flagship.asis_bins_blocks(512)
    for name, grid, mask in (("gl_band", "gl", "band"),
                             ("healpix_planckish", "healpix", "planckish")):
        c = json.loads((PKG / "configs" / f"{name}.json").read_text())
        assert [list(b) for b in bins] == c["bins"]
        assert [[list(x) for x in bl] for bl in blocks] == c["blocks"]
        sig = port_tuned_proposal_sigmas(
            flagship.RECORDS, "asis", grid, mask, 512,
            [len(b) - 1 for b in bins], "aux_mala")
        for a, b in zip(sig, c["prop_sigma"]):
            np.testing.assert_array_equal(a, b)
        assert abs(c["sigma2"] - flagship.NOISE_SIGMA2) < 1e-15
        assert c["fwhm_deg"] == flagship.FWHM_DEG
