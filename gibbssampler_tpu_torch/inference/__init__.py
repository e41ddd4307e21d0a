"""Experiment layer: simulation, configuration, the runner, checkpoints and
file I/O."""

from .simulate import example_dl, synfast, simulate_dataset
from .runner import RunConfig, run_experiment, save_checkpoint, load_checkpoint
from .spectra_io import load_cls, KCMB_UK
from .fits_io import (read_healpix_map, write_healpix_map, nest2ring,
                      ring2nest)

__all__ = ["example_dl", "synfast", "simulate_dataset",
           "RunConfig", "run_experiment", "save_checkpoint",
           "load_checkpoint", "load_cls", "KCMB_UK",
           "read_healpix_map", "write_healpix_map", "nest2ring", "ring2nest"]
