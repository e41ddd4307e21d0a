"""Spherical harmonic transforms on the Gauss-Legendre and HEALPix grids and
at point sets, with the Legendre stage in hand-written CUDA kernels."""

from .grids import SphereGrid, gauss_legendre_grid, subgrid_rows
from .legendre import legendre_table, wigner_d_table, spin2_lambda_tables
from .lcore import grid_symmetric
from .legendre_kernels import legendre_synth_tri, legendre_adj_tri
from .points import PointSHT, group_points_by_ring
from .transform import SHT, make_sht
from .healpix import (HealpixGeometry, HealpixLayout, HealpixSHT,
                      healpix_geometry, healpix_layout, make_healpix_sht)
from .healpix_pix import (ang2pix_ring, galactic_band_mask, pix2ang_ring,
                          ud_grade)

__all__ = [
    "SphereGrid", "gauss_legendre_grid", "subgrid_rows",
    "legendre_table", "wigner_d_table", "spin2_lambda_tables",
    "legendre_synth_tri", "legendre_adj_tri", "grid_symmetric",
    "PointSHT", "group_points_by_ring",
    "SHT", "make_sht",
    "HealpixGeometry", "HealpixLayout", "HealpixSHT", "healpix_geometry",
    "healpix_layout", "make_healpix_sht",
    "ang2pix_ring", "pix2ang_ring", "ud_grade", "galactic_band_mask",
]
