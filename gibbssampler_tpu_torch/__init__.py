"""gibbssampler_tpu_torch — the CMB power-spectrum Gibbs sampler in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``gibbssampler_tpu`` (JAX on TPU), which stays the reference the
port is checked against.  This package imports torch, numpy and scipy, and
never jax.  It covers the centered masked-polarization path so far:

harmonics   grid-packed alm state, D_ell <-> C_ell, binning, beams
sht         Gauss-Legendre transforms, spin 0 and 2; the Legendre stage runs
            in the CUDA kernels of csrc/legendre_tri.cu (built at first use)
ops         noise model, SkyModel, the cut-sky complement decomposition
samplers    exact and aux-Gibbs + MALA constrained realizations, the
            conjugate inverse-gamma D_ell draw
schemes     CenteredGibbs over a leading chain axis
inference   dataset simulation
diagnostics ESS, R-hat, chain summaries
interop     carry the JAX package's dataset and state across as numpy
"""

__version__ = "0.1.0"
