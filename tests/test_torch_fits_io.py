"""The port's file I/O against the JAX package's: the HEALPix nest <-> ring
maps, FITS maps written by either package and read by the other (RING and
NESTED, float32 and float64), the theory-spectrum loader, and the FITS
mask pipeline on the port's grid."""

import numpy as np
import pytest
import torch

from gibbssampler_tpu.inference import fits_io as jfits
from gibbssampler_tpu.inference.spectra_io import load_cls as jax_load_cls
from gibbssampler_tpu_torch.inference import (load_cls, nest2ring,
                                              read_healpix_map, ring2nest,
                                              write_healpix_map)
from gibbssampler_tpu_torch.ops import NoiseModel
from gibbssampler_tpu_torch.sht import (ang2pix_ring, galactic_band_mask,
                                        healpix_geometry, pix2ang_ring,
                                        ud_grade)


@pytest.mark.parametrize("nside", [1, 2, 4, 8, 16])
def test_nest_ring_maps_match_jax(nside):
    """Both index maps equal JAX's, whole and at chosen pixels, and are
    inverse permutations."""
    npix = 12 * nside * nside
    np.testing.assert_array_equal(nest2ring(nside), jfits.nest2ring(nside))
    np.testing.assert_array_equal(ring2nest(nside), jfits.ring2nest(nside))
    pix = np.random.default_rng(nside).integers(0, npix, size=17)
    np.testing.assert_array_equal(nest2ring(nside, pix),
                                  jfits.nest2ring(nside, pix))
    np.testing.assert_array_equal(ring2nest(nside, pix),
                                  jfits.ring2nest(nside, pix))
    assert (ring2nest(nside)[nest2ring(nside)] == np.arange(npix)).all()


@pytest.mark.parametrize("nside", [2, 4, 8])
def test_nest_hierarchy_on_port_pixels(nside):
    """Nested child q at 2 nside lies in nested parent q // 4, through the
    port's own RING pixel functions."""
    fine = 2 * nside
    q = np.arange(12 * fine * fine)
    th, ph = pix2ang_ring(fine, nest2ring(fine, q))
    assert (ang2pix_ring(nside, th, ph) == nest2ring(nside, q // 4)).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("ordering", ["RING", "NESTED"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fits_files_cross_read(tmp_path, writer, ordering, dtype):
    """A file written by either package is byte-identical to the other's
    and reads back identically in both, all columns and one."""
    maps = np.random.default_rng(3).normal(size=(2, 12 * 8 * 8))
    names = ["I_STOKES", "Q_STOKES"]
    paths = {}
    for who, write in (("jax", jfits.write_healpix_map),
                       ("port", write_healpix_map)):
        paths[who] = tmp_path / f"{who}.fits"
        write(paths[who], maps, ordering=ordering, dtype=dtype, names=names)
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    path = paths[writer]
    back, hdr = read_healpix_map(path, field=None)
    jback, jhdr = jfits.read_healpix_map(path, field=None)
    np.testing.assert_array_equal(back, jback)
    assert hdr == jhdr and hdr["_names"] == names and hdr["NSIDE"] == 8
    np.testing.assert_allclose(back, maps.astype(dtype), rtol=0, atol=0)
    one, _ = read_healpix_map(path, field=1, dtype=np.float32)
    np.testing.assert_array_equal(
        one, jfits.read_healpix_map(path, field=1, dtype=np.float32)[0])


def test_fits_rejects_a_bad_length(tmp_path):
    with pytest.raises(ValueError, match="HEALPix length"):
        write_healpix_map(tmp_path / "bad.fits", np.zeros(100))


def test_load_cls_matches_jax(tmp_path):
    """npy, npz and CAMB-style text (D_ell and C_ell input, the K -> muK
    conversion) load as JAX loads them."""
    rng = np.random.default_rng(0)
    arr = rng.uniform(1.0, 2.0, size=(4, 20))
    p_npy = str(tmp_path / "cls.npy")
    np.save(p_npy, arr)
    p_npz = str(tmp_path / "cls.npz")
    np.savez(p_npz, tt=arr[0], ee=arr[1, :9])
    txt = str(tmp_path / "cls.txt")
    ell = np.arange(2, 16)
    np.savetxt(txt, np.column_stack([ell, rng.uniform(size=(14, 2))]))
    for path, kw in ((p_npy, {}), (p_npz, {}),
                     (txt, {"columns": ("tt", "ee"), "input_is_dl": False}),
                     (txt, {"k_to_uk": True})):
        out, ref = load_cls(path, 15, **kw), jax_load_cls(path, 15, **kw)
        assert sorted(out) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k])
            assert out[k][0] == 0.0 and out[k][1] == 0.0
    out = load_cls(p_npy, lmax=15)
    assert out["tt"].shape == (16,) and out["tt"][5] == arr[0, 5]


def test_mask_pipeline_via_fits(tmp_path):
    """A NESTED FITS mask read back, ud_graded and turned into the port's
    noise model, as the runner does."""
    m16 = galactic_band_mask(16, 20.0)
    path = tmp_path / "mask.fits"
    write_healpix_map(path, m16, ordering="NESTED", dtype=np.float32)
    m, _ = read_healpix_map(path)
    np.testing.assert_allclose(m, m16, atol=1e-6)
    noise = NoiseModel.white_healpix(
        0.2 ** 2, healpix_geometry(8), nfields=2,
        mask=(ud_grade(m, 8) > 0.5).astype(float), dtype=torch.float64,
        device="cpu")
    assert 0.55 < float(noise.f_sky[0]) < 0.8
