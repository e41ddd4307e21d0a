"""alm packing conventions, spectra, variance expansion, binning."""

from .packing import AlmIndexMaps, index_maps, nflat
from .spectra import (dl_to_cl_factor, dl_to_cl, bin_index, unfold_bins,
                      bin_sum, gauss_beam)
from .gridstate import (nstate, state_masks, expand_cl_state,
                        variance_expansion_state, almxfl_state, alm2cl_state,
                        ell_mask_state)

__all__ = [
    "AlmIndexMaps", "index_maps", "nflat",
    "dl_to_cl_factor", "dl_to_cl", "bin_index", "unfold_bins", "bin_sum",
    "gauss_beam",
    "nstate", "state_masks", "expand_cl_state", "variance_expansion_state",
    "almxfl_state", "alm2cl_state", "ell_mask_state",
]
