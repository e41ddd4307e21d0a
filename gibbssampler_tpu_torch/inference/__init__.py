"""Experiment layer: dataset simulation."""

from .simulate import example_dl, simulate_dataset

__all__ = ["example_dl", "simulate_dataset"]
