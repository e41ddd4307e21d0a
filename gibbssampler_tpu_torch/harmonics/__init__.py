"""alm packing conventions, spectra, variance expansion, binning."""

from .packing import (AlmIndexMaps, index_maps, nflat, nhealpy, flat_to_grid,
                      grid_to_flat, flat_to_healpy, healpy_to_flat)
from .spectra import (dl_to_cl_factor, dl_to_cl, cl_to_dl, variance_expansion,
                      variance_expansion_matrix, bin_index, unfold_bins,
                      bin_sum, alm2cl, almxfl, gauss_beam)
from .gridstate import (nstate, state_masks, expand_cl_state,
                        variance_expansion_state, almxfl_state, alm2cl_state,
                        ell_mask_state, flat_to_state, state_to_flat)

__all__ = [
    "AlmIndexMaps", "index_maps", "nflat", "nhealpy",
    "flat_to_grid", "grid_to_flat", "flat_to_healpy", "healpy_to_flat",
    "dl_to_cl_factor", "dl_to_cl", "cl_to_dl",
    "variance_expansion", "variance_expansion_matrix",
    "bin_index", "unfold_bins", "bin_sum", "alm2cl", "almxfl", "gauss_beam",
    "nstate", "state_masks", "expand_cl_state", "variance_expansion_state",
    "almxfl_state", "alm2cl_state", "ell_mask_state",
    "flat_to_state", "state_to_flat",
]
