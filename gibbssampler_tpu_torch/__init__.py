"""gibbssampler_tpu_torch — the CMB power-spectrum Gibbs sampler in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``gibbssampler_tpu`` (JAX on TPU), which stays the reference the
port is checked against.  This package imports torch, numpy and scipy, and
never jax.  It covers the centered, non-centered, ASIS and PNCP
masked-polarization schemes so far:

harmonics   grid-packed alm state, D_ell <-> C_ell, binning, beams
sht         Gauss-Legendre transforms, spin 0 and 2; the Legendre stage runs
            in the CUDA kernels of csrc/legendre_tri.cu (built at first use)
ops         noise model, SkyModel, the cut-sky complement decomposition,
            batched per-chain CG (plain and mixed precision)
samplers    constrained realizations: exact, the CG family (CG, RJPO,
            pCN) and the auxiliary-variable family (aux-Gibbs,
            overrelaxation, MALA / ULA, aux-Gibbs + MALA); the conjugate
            inverse-gamma D_ell draw, the blocked MH D_ell step
schemes     CenteredGibbs, NonCenteredGibbs, ASISGibbs and PNCPGibbs over
            a leading chain axis
parallel    proposal scales of the MH step and their warm-up adaptation;
            the ("chains", "m") process mesh, chain sharding, the
            collectives over the chains, the m-sharded SHT
inference   dataset simulation
diagnostics ESS, R-hat, chain summaries
interop     carry the JAX package's dataset and state across as numpy;
            read the tuned proposal records
flagship    bench.py's flagship ASIS and PNCP configurations on the port
tune        ``python -m gibbssampler_tpu_torch.tune``: tune their proposal
            scales on the card into tuned_proposals.json
launch_pod  ``torchrun ... -m gibbssampler_tpu_torch.launch_pod``: one
            process per card (tools/launch_pod.py's counterpart)
"""

__version__ = "0.1.0"
