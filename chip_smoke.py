#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py             (from the repository root; one card)
    python3 chip_smoke.py --profile   (adds a torch.profiler table of each
                                       ASIS and PNCP slice and of one CG
                                       solve)
    python3 chip_smoke.py --f64-parts (only phases 1-2 and the float64
                                       kernels' parts, dense and parity:
                                       see phase_f64_parts)

Phases, each reported on its own lines; any failure raises and exits
non-zero:

1. needs torch.cuda.is_available(); prints the card's name and power limit
   (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
2. builds the CUDA kernels from gibbssampler_tpu_torch/csrc (one nvcc per
   source, started together, sm_90a) and prints ptxas's registers, spills
   and shared memory for every kernel, and the plans (threads, dynamic
   shared memory, resident blocks an SM) of the float64 kernels and of the
   narrow-table float64 kernels (legendre_kernels.narrow_plan) at the
   narrow phase's dense and parity shapes, the parity synthesis' ring
   tiles held equal to legendre_kernels.narrow_par_synth_plan's, and the
   float64-table float32 kernels' (f64f32) plans at phase 18's shapes held
   equal to wide_synth_plan / wide_adj_plan (dense) and
   wide_par_synth_plan / wide_par_adj_plan (parity; with ptxas's registers
   and spills of synth_par_wide and adj_par_wide), with the card; builds
   and loads the native
   table engine (csrc/tables.cpp, g++), failing if it does not load;
3. compares each kernel with its plain PyTorch version (true float32) on
   the card at the JAX package's Pallas test shapes, a ragged shape, the
   main-path shapes (65 band rings, 83 floor rings and 211 point rows of
   the planckish mask, 193 floor rings and 391 point rows of the HEALPix
   planckish mask, the 513-ring GL and the 1023-ring HEALPix grids) and a
   batch of 200, in float32 (<= 1e-5 max|ref|) and float64 (<= 1e-12),
   with contiguous operands and with the strided views the main path
   passes, the outputs given NaN-filled memory; checks adjointness; and
   times kernel and plain version (one torch.einsum call) at L 513, C 256
   and each main-path row count, with TFLOP/s, GB/s and the bound: the
   larger of the bytes over 3.35 TB/s and the FLOPs over the 3xTF32 rate,
   495 / 3 TFLOP/s; and times the float64 kernels against their float64
   einsum at the CG phase's shapes (the 65 cut rings and the 513-ring full
   grid, 16 and 32 columns; at 16 columns, the mixed ladder's float32
   shapes, in float32 too), with the bound of the bytes over 3.35 TB/s or
   the FLOPs over the 67 TFLOP/s float64 tensor-core peak; and checks the
   float64 kernels alone at an even L with odd nr and at 1 and 17 columns;
   then both kernels in their m-slab form (float32 at C 256, float64 at C
   16) on each slab of the two-way split at L 513 (257 and 256 rows, the
   rows parallel.m_rows deals), at the band's 65 rings and the 513-ring
   grid, against the plain slab version and the slab's bound, beside the
   unsharded time;
4. checks the lmax-512 transforms in float32 (round trip and the cut
   transform's adjointness, on GL rings and on the HEALPix floor's 193
   belt rows at nphi 1024 = 2 lmax), and at lmax 16 in float64, card
   against CPU on the same injected variates (<= 1e-9, CR and MH accepts
   equal), one step each of: CenteredGibbs with the aux_mala, cg, rjpo and
   pcn CRs on a band mask and with cg on a holey mask (the floor +
   sparse-hole split); ASISGibbs on the band mask, on the holey mask and
   on a holey HEALPix mask at nside 8 (padded layout, cap-ring holes in the
   point set, the table engine's ring-phase and Nyquist paths);
   NonCenteredGibbs; and PNCPGibbs on the table engine (EE fully centered,
   BB non-centered from l = 10);
5. on a band-masked polarized sky at lmax 512 (GL grid 513 x 1026, cut
   decomposition over 65 rings, float32, 128 chains) runs four paths,
   each with the kernel launch counts set to 0 before it and read after
   it: the centered aux-Gibbs + MALA slice; the flagship ASIS slice
   (aux_mala CR, inverse-gamma draw, whiten, the table-engine blocked MH
   with bench.py's bins and blocks and the port's tuned record, recenter);
   the same ASIS slice with the overrelaxed CR and its record; and a short
   warm-up adaptation (adapt_segments, 2 segments x 10 iterations x 32
   chains from the analytic seeds), which must move each block's scale
   the way its acceptance asks while the MH plan and its tables stay the
   same objects.  Each slice runs the initial CR draw, 10 warm-up and 50
   timed iterations; checks the D_ell, the exact launch counts per
   iteration and that the MH acceptances of the EE block, the BB big
   block and the BB singles lie in [0.15, 0.6]; and reports ms/iter, the
   MH step's ms/iter (CUDA events), median pooled and BB-tail ESS/s,
   per-chain ESS per iteration and peak memory;
6. at the ASIS slice's final state: one MH sweep at full width in float64
   (4 chains): the table engine against the direct nc_cls_sample on the
   same uniforms (D_ell <= 1e-9, accepts equal); the float32
   log-likelihood's rounding against float64; and the float32 rounding of
   the log-ratios the accept tests compare with a uniform, the first
   big-block candidate's, one MALA move's and one pCN move's, over all
   chains, in the form the sampler uses (every difference formed before
   its reduction) and in the old form (differences of O(1e6)-term totals),
   against float64 (the exact pCN form's under 0.1 nats); then, on the
   same uniforms and against the same direct sweep, the phi-domain
   (mdomain False) and the coefficient m-domain (mdomain "m") engines, and
   the blocking with EE and BB one block each on the phi engine against
   its own direct sweep;
7. bench.py's PNCP configuration (BENCH_SCHEME=pncp, BENCH_LCUT none,300)
   on the same dataset with its tuned record: EE fully centered, BB
   single-bin blocks from l = 300 on the table engine with the identity
   re-centering below l_cut; the slice as in phase 5 (8 + 6 launches per
   iteration, the BB singles' acceptance in [0.15, 0.6]), then one float64
   MH sweep at full width, the table engine against the direct path on
   the PNCP likelihood; then the phi slice: the ASIS band slice of phase
   5 with mh_fast="phi" (the phi-domain engine, the same record),
   PHI_TIMED timed iterations, its MH step's ms/iter beside phase 5's
   table engine; and one float32 sweep of the coefficient engine at 128
   chains beside the table engine's, timed with CUDA events; then the
   parallel phase (gibbssampler_tpu_torch.parallel, on phase 5's ASIS
   band scheme, the one flagship.build makes): (a) NCCL at world size 1 in
   this process, sharded_run on a (1, 1) CUDA mesh (128 chains, PAR_ITERS
   iterations) bit-equal to scheme.run with the same generator, the
   collectives over its chains against numpy; (b) two gloo processes
   sharing the card (par_worker): on a (2, 1) mesh each runs its 64
   chains of the slice, bit-equal to this process's unsharded run of
   them, the pooled statistics against numpy over all 128; on a (1, 2)
   mesh the m-sharded full-grid (513 rings) and cut (65 rings) spin-2
   transforms in float32 at 128 chains against the unsharded ones (rows
   257 / 256 of 513, table bytes), and one float64 cg_cr at tol 1e-5 on
   CG_CHAINS chains, m-sharded against unsharded (per-chain iterations
   equal, D_ell within 1e-9), both kernels launched in their slab form;
   (c) torchrun --standalone --nproc_per_node 1 -m
   gibbssampler_tpu_torch.launch_pod on NCCL at lmax 512 (PAR_LAUNCH),
   its npz checked;
8. the CG family at full width in float64 (the band dataset, 8 chains,
   the prior of the true spectrum in unit bins): cg_cr at tol 1e-5 and
   1e-6 (every chain converged, per-chain iterations beside the JAX
   package's record, ms per solve and per iteration, 2 + 2 launches per
   iteration, the true residual), rjpo_cr at 1e-5 from the CG draw, the
   mixed-precision ladder (float32 apply on the 3xTF32 kernels, float64
   vectors and true residuals, replacement every 10) at both tolerances,
   capped at 1000 iterations, and a CenteredGibbs slice with the cg CR (the initial draw and 3
   iterations);
9. the same ASIS slice and float64 checks on bench.py's planckish mask (an
   apodized band plus 200 point-source holes): checks the split's 83
   floor rings, 1547 hole pixels and 211 x 64 point rows, and the exact
   launch counts per iteration (each cut transform fused with the point
   set's); the float64 sweep also on the phi engine and with mdomain "m"
   (which the split sends to phi); then the same mask cut without the
   split (every ring a hole touches; w_cut not azimuthally uniform), where
   "auto" takes the phi engine, against the direct path;
10. with the GL models freed, the HEALPix planckish path (bench.py's
   BENCH_GRID=healpix BENCH_MASK=planckish): nside 256 in the padded
   layout, the same sky under bench.py's HEALPix planckish mask; checks the
   split's 193 floor rings at nphi 1024 (97 phased), 1140 hole pixels (434
   on cap rings) in 391 x 8 point rows and the floor transform against the
   full 1023-ring synthesis at the floor pixels; runs the ASIS slice with
   its tuned record and the float64 checks, the phi engine among them;
11. with those models freed, the runner (gibbssampler_tpu_torch.inference.
   run_experiment) on examples/run_polarization.py's configuration at
   lmax 512 (RUNNER_CFG: GL band 10 deg, 32 chains, asis with aux_gibbs,
   the direct MH engine on 8-bin blocks): once uninterrupted, then
   crashed by its verbose callback after the first segment's checkpoint
   and resumed; the resumed results equal the uninterrupted ones bit for
   bit (chains, CR and MH acceptance histories, summaries), their keys
   are RUNNER_KEYS, the D_ell finite and positive, the checkpoint gone;
   ms/iter per segment, acceptances and peak memory;
12. the runner on a HEALPix FITS mask: a 20 deg galactic band at nside 512
   written NESTED by the port and read back equal, ud_graded to nside 256
   by the runner (centered, aux_gibbs, 8 chains, time_steps): f_sky, the
   model kind (cut decomposition or full-transform fallback, confirmed by
   the launches' row counts), finite chains, positive step times;
13. joint TQU: (a) the exact joint scheme through the runner at lmax 512
   on the full sky (32 chains, 40 iterations, r_te 0.5): the posterior TE
   correlation against the realization's over l 50-400 within
   te_tolerance, every block positive definite; (b) one float64
   cg_joint_cr solve on a spin-3 band-cut model (4 chains, tol 1e-6, the
   reference's noise levels): every chain converged, the true residual
   recomputed with the full-grid operator <= 1e-6; on that model (T and
   P noise unequal) one float64 MH sweep of the engine "auto" takes, the
   coefficient engine, and on the same sky at equal noise the table
   engine, each against the direct path;
14. the flat (healpy-order) alm interface on the full grids' transforms:
   synfast at lmax 512 (spin 2 on GL, spin 0 on HEALPix nside 256), alm2cl
   of each draw against its input C_l within FLAT_CV_SIGMAS
   cosmic-variance deviations, the state and healpy round trips, the GL
   flat round trip and the flat adjointness on both grids; then phase 3's
   checks at every (L, nr, C, dtype) that the engine sweeps and phases
   11-14 launched and phase 3 does not cover (the wrappers' per-shape
   counts);
15. the transform options (phase_options, after the flat phase): (a) both
   kernels' ring-parity mode against its plain version, with and without
   flip, and against the dense kernel on the mirrored full table, at L 513
   on the GL grid's 257 and HEALPix's 512 north rings (float32, C 256 and
   512) and at the CG shapes (float64, C 16 and 32), and a slab of each,
   timed beside the plain version and the dense kernel with the bound of
   the half table, each kernel with its launch (the float32 synthesis'
   ring tile, the float64 plans, shared memory, resident blocks an SM); (b) the
   full-grid transforms ring-split against dense
   on GL lmax 512 and HEALPix nside 256, spin 0 and 2, synthesis, adjoint
   and analysis: float32 at 128 chains (<= 1e-5), float64 at 8 (<= 1e-12),
   ms per transform and table bytes of each; (c) the flagship ASIS band
   scheme without the cut decomposition, ring_split True and False
   (SPLIT_ITERS), ms/iter, acceptances and launches per iteration: the
   split path launches no dense kernel, the dense path no parity kernel,
   and the split path's parity launches are printed by shape; (e) before
   it, flagship.build of the split scheme cold (an empty table cache) and
   warm, and the native table engine against numpy at lmax 64;
   (d) the cut ASIS band slice under fft_mode "fft" and "ct" beside phase
   5's "matmul" (FFT_ITERS), the cut transforms inheriting the mode, and
   one synthesis of each against "matmul";
16. the bfloat16 table mode (after the options phase; phase_bf16_*): (a)
   the four bfloat16-table kernels (csrc/legendre_tri_bf16.cu: the dense
   pair and the parity pair, float32 batch and output) against their
   plain versions (<= 1e-5 max|ref|) and the float64 operator (<= 1e-2),
   the outputs given NaN-filled memory: the dense pair at phase 3's
   shapes, contiguous and in the main path's views, with the adjointness
   on the rounded batches; the parity pair at the GL grid's 257 and
   HEALPix's 512 north rings, flip and not, its synthesis against the
   dense kernel on the mirrored table and timed beside it; a slab of each
   pair; each timed at
   L 513, C 256 beside its plain version and torch.einsum on the
   bfloat16 tensors (cuBLAS), with the bound of the bfloat16 table, the
   float32 batch and output over 3.35 TB/s or the FLOPs over 989 TFLOP/s;
   (b) GL lmax 512 (dense and ring-split) and HEALPix nside 256 spin-2
   transforms with bfloat16 tables against float32 ones at 128 chains:
   max|err|/max|ref|, ms per transform, table bytes; (c) bench.py's
   BENCH_TABLE_DTYPE=bfloat16, the ASIS band slice from
   flagship.build(table_dtype="bfloat16") at full width, cut to 5 + 20
   iterations: ms/iter, MH ms/iter, acceptances in [0.15, 0.6], exactly
   12 + 6 bfloat16 launches per iteration and no float32 or float64
   Legendre launch, peak memory;
17. float64 compute on narrow tables (after the bf16 phase;
   phase_narrow_*): (a) the four narrow-table kernels
   (csrc/legendre_tri_narrow_f64.cu: bfloat16 or float32 table, float64
   batch and sums) with each table dtype against their plain versions
   (<= 1e-12 max|ref|), the outputs given NaN-filled memory, at L 513: the
   dense pair at the band's 65 cut rings and the 513-ring grid (16 and 32
   columns), the parity pair at the grid's 257 north rings (16 and 32
   columns, flip and not), slab 0 of the two-way split of each; each timed
   beside its plain version, the float64 kernel on the float64 table and
   torch.einsum on the upcast table (the kernels and the einsum on the
   device, replayed from a CUDA graph of 20 calls; the plain version and
   the wrapper call back to back), with the bound of the narrow table,
   the float64 batch and output over 3.35 TB/s or the FLOPs over 67
   TFLOP/s; (b) the CG phase's float64 band dataset built on float64,
   float32 and bfloat16 tables (flagship.dataset with flagship_sht(...,
   dtype=float64, table_dtype=...)), and its cut transform, the GL full
   grid ring-split and HEALPix nside 256 with narrow tables against the
   float64-table ones at 8 chains (max|err|/max|ref|, ms per transform,
   table bytes); (c) cg_cr on each of the three datasets at tol 1e-5 (8
   chains): per chain iterations, convergence and the true residual with
   the solve's operator and with the float64-table one, ms per iteration,
   2 + 2 launches per iteration of the table dtype's kernels only; the
   float32 and float64 tables must converge, the bfloat16 ones (whose
   operator rounds its batch and is not linear) are solved to caps of 25
   to 300 iterations and their floor printed; float16 tables under
   float64 compute (f16f64) run through (a)-(c) as a third narrow table
   dtype (the 16-bit ones capped, finite), and (a) ends with the
   one-rounding check of the f16f64 kernels on float16 edge values, bit
   for bit (f16f64_edges);
18. the remaining table pairs (phase_pairs): (a) the float16-table
   kernels (csrc/legendre_tri_f16.cu) and the float64-table float32
   kernels (csrc/legendre_tri_narrow_f64.cu, f64f32) against their plain
   versions (<= 1e-5 and one float32 ulp of max|ref|) at L 513, C 256:
   dense at 65 and 513 rings, parity at 257 north rings (flip and not;
   the parity adjoint with g of unit stride on r and on c), slab 0 of
   each; each timed beside its plain version, the float32
   kernel on the float32 table and torch.einsum on the upcast or widened
   operands, with its bound; (b) GL lmax 512 (dense, ring-split) and
   HEALPix nside 256 spin-2 transforms on float16 and on float64 tables
   against float32 ones at 128 chains; (c) the ASIS band slice on float64
   tables (5 + 20 iterations, 12 + 6 f64f32 launches an iteration and no
   other, acceptances in [0.15, 0.6]), then on float16 tables if the
   largest |value| at every float16 rounding site over one iteration
   stays below 65504, else the overflow is printed;
19. prints the kernels' JSON line, the float32 and the float64 kernels
   each with their launches summed over the paths, their parity modes
   with the options phase's launches, the four bfloat16-table kernels
   with the bf16 phase's (b) and (c), the four narrow-table float64
   kernels, one entry for each table dtype, with the narrow phase's (b)
   and (c), and the four kernels of each remaining pair with phase 18's
   (b) and (c), then {"ok": true, "device": {...}} last.

The configurations come from gibbssampler_tpu_torch.flagship, the
proposal scales from the port's records (gibbssampler_tpu_torch/
tuned_proposals.json, written by python -m gibbssampler_tpu_torch.tune); a
missing record fails the run.  It imports nothing of JAX; the port is
imported from this file's directory.
"""

import dataclasses
import json
import re
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

LMAX = 512
NCHAINS = 128
N_WARM = 10
N_TIMED = 50
PER_ITER = 6          # spin-2 cut transforms of each kind per aux_mala step
# per ASIS iteration: synthesis 6 (CR) + 6 (MH: u0 and the moves of the two
# big blocks, two tables each), adjoint 6 (CR)
ASIS_PER_ITER = (12, 6)
# with the overrelaxed CR (one sweep): synthesis 4 (the initial aux draw and
# the sweep's) + 6 (MH), adjoint 4
OVERRELAX_PER_ITER = (10, 4)
# bench.py's flagship binning: EE unit bins in one block; BB unit bins up to
# l = 396, then 16 wide bins; a 277-bin big block, then 133 single-bin
# blocks (12 chunks of them)
ASIS_NBINS = (511, 410)
ASIS_BIG = 277
ASIS_CHUNKS = 12
# the MH acceptances of the EE block, the BB big block and the BB singles
# (their mean) with the tuned records
ACCEPT_WINDOW = (0.15, 0.6)
# the warm-up adaptation phase: segments, iterations per segment, chains
ADAPT = (2, 10, 32)
CUT_RINGS = 65
BB_TAIL_FROM = 300    # bench.py's BB-tail ESS: bins from l = 300
# bench.py's planckish GL mask at lmax 512: its floor + sparse-hole split
# has 83 floor rings and 1547 hole pixels in 211 point rows of width 64;
# per ASIS iteration every cut transform is fused with the point set's,
# two tables each on both
PLANCKISH_FLOOR_RINGS = 83
PLANCKISH_HOLE_PIX = 1547
PLANCKISH_POINT_ROWS = (211, 64)
PLANCKISH_PER_ITER = (24, 12)
# bench.py's HEALPix planckish path: nside lmax / 2 (4 nside - 1 = 1023
# rings), padded layout.  Its split has the floor over 193 belt rings
# (415-607) at nphi 4 nside = 2 lmax, 97 of them with phi0 != 0, and 1140
# hole pixels, 434 of them on cap rings, in 391 point rows of width 8; the
# launches per iteration are the GL planckish path's
NSIDE = LMAX // 2
HEALPIX_RINGS = 4 * NSIDE - 1
HEALPIX_FLOOR_RINGS = 193
HEALPIX_PHASED_ROWS = 97
HEALPIX_HOLE_PIX = 1140
HEALPIX_CAP_HOLE_PIX = 434
HEALPIX_POINT_ROWS = (391, 8)
HEALPIX_PER_ITER = (24, 12)
# the kernels' timed row counts: band cut rings, planckish floor rings,
# HEALPix floor rings, planckish point rows, HEALPix point rows, the GL and
# the HEALPix full grids
TIMED_NR = (CUT_RINGS, PLANCKISH_FLOOR_RINGS, HEALPIX_FLOOR_RINGS,
            PLANCKISH_POINT_ROWS[0], HEALPIX_POINT_ROWS[0], LMAX + 1,
            HEALPIX_RINGS)
# the CG phase (float64 on the band's cut rings, unit bins at the true
# spectrum, as tools/cg_scale.py sets it up): chains (8, as that record),
# tolerances, the cap, the mixed ladder's replacement cadence, and the JAX
# package's record for the 11.5 deg band at lmax 512 in float64, lockstep
# max over 8 chains (docs/CG512_TABLE.txt)
CG_CHAINS = 8
CG_TOLS = (1e-5, 1e-6)
CG_MAXITER = 4000
# the mixed ladder's cap: it cycles from its 9th replacement on, so 1000
# iterations show the cycle (a cap of CG_MAXITER would only repeat it and
# take the time the runner and joint phases need)
CG_MIXED_MAXITER = 1000
CG_REPLACE_EVERY = 10
CG_JAX_ITERS = {1e-5: 234, 1e-6: 351}
CG_SLICE_ITERS = 3
# bench.py's PNCP configuration (BENCH_SCHEME=pncp, BENCH_LCUT none,300): the
# ASIS bins, EE fully centered (no block), BB single-bin blocks from l = 300
# (bins 298-409); per iteration synthesis 6 (CR) + 2 (MH: u0), adjoint 6
PNCP_LCUT = (513, 300)
PNCP_SINGLES = 112
PNCP_PER_ITER = (8, 6)
# the pCN move of the float32 rounding check, and its limit in nats for
# the exact form at the ASIS band slice's final state
PCN_BETA = 0.1
PCN_EXACT_LIMIT = 0.1
# the float64 kernels' timed shapes: the CG phase's cut rings and full grid
# at its chains' column count (the first two: the main-path records; the
# mixed ladder's float32 apply runs at them too, so phase 3 also checks the
# float32 kernels there), and at twice it
F64_TIMED = ((CUT_RINGS, 2 * CG_CHAINS), (LMAX + 1, 2 * CG_CHAINS),
             (CUT_RINGS, 4 * CG_CHAINS), (LMAX + 1, 4 * CG_CHAINS))
# float64-only correctness shapes: an even L with odd nr (the odd m's table
# slabs start on an 8-byte, not a 16-byte, boundary) and ragged columns
F64_EXTRA = ((64, 33, 16), (37, 19, 1), (37, 19, 17))
# the runner phase: examples/run_polarization.py's configuration with lmax
# raised from its default 128 to bench.py's 512 (GL 513 x 1026, the cut
# decomposition over the band's rings, 64 + 64 eight-bin MH blocks on the
# direct engine), run once, then crashed after its first segment and
# resumed; the results keys the JAX runner writes for it
# (tests/test_torch_runner.py holds the list against the JAX runner)
RUNNER_CFG = dict(lmax=LMAX, spin=2, grid="gl", scheme="asis",
                  cr_method="aux_gibbs", cr_options={"n_gibbs": 20},
                  noise_sigma2=0.04, fwhm_deg=0.5, mask_band_deg=10.0,
                  nchains=32, dtype="float32", n_iter=20, segment=10)
RUNNER_KEYS = sorted(["config", "cr_accept_chain", "cr_accepts",
                      "durations"] + [f"{k}_{f}" for f in range(2) for k in
                                      ("dl_chain", "ess", "mean",
                                       "mh_accept", "rhat")])
# the FITS phase: a galactic band mask at nside 2 x 256, written NESTED
FITS_BAND_DEG = 20.0
RUNNER_FITS_CFG = dict(lmax=LMAX, grid="healpix", nside=NSIDE, spin=2,
                       scheme="centered", cr_method="aux_gibbs",
                       cr_options={"n_gibbs": 5}, nchains=8, n_iter=6,
                       segment=3, time_steps=True)
# the joint phase: (a) the exact joint scheme on the full sky through the
# runner, its TE check over l 50-400 after 10 iterations; (b) one float64
# joint CG solve on a spin-3 band-cut model at the reference's noise levels
# per pixel, 40^2 muK^2 in T and 0.2^2 in Q and U (with 0.2^2 in T too the
# TT signal-to-noise reaches 1e9 and CG needs 2275 iterations already at
# lmax 128, on the CPU)
JOINT_CFG = dict(lmax=LMAX, spin=3, scheme="joint", r_te=0.5,
                 noise_sigma2=0.04, fwhm_deg=0.5, nchains=32, n_iter=40,
                 segment=20, time_steps=True)
JOINT_TE_ELLS = (50, 400)
JOINT_BURN = 10
JOINT_CG_NOISE = (40.0 ** 2, 0.2 ** 2, 0.2 ** 2)
JOINT_CG_BAND_DEG = 10.0
JOINT_CG_CHAINS = 4
JOINT_CG_TOL = 1e-6
# the phi slice (bench.py's ASIS band configuration with mh_fast="phi"):
# its timed iterations, cut from N_TIMED to fit the script's time budget
PHI_TIMED = 30
# the flat (healpy-order) interface phase: synfast draws at lmax 512, spin
# 2 on GL and spin 0 on HEALPix nside NSIDE.  alm2cl of a draw against its
# input C_l: each hat-C_l / C_l - 1 has standard deviation sqrt(2 / (2l +
# 1)) (cosmic variance); FLAT_CV_SIGMAS of them bound each l, and the mean
# over l = 2..lmax is bound likewise by its own deviation
FLAT_CV_SIGMAS = 6.0
# the parallel phase (gibbssampler_tpu_torch.parallel): the ASIS band slice
# chain-sharded over NCCL at world size 1 and over two gloo processes that
# share the card, PAR_ITERS iterations each (split R-hat needs two samples
# in each half), then the pod launcher, cut to PAR_LAUNCH's chains and
# iterations for the script's time
PAR_ITERS = 4
PAR_SEED = 21
PAR_LAUNCH = {"lmax": LMAX, "nchains": 32, "n_iter": 10}
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
TF32X3_FLOPS_PER_S = 495e12 / 3      # 3 TF32 tensor-core products each
# H100 SXM float64 tensor-core peak; the float64 kernels stream the table
# on the FMA pipes, whose peak is about half of it
FP64_FLOPS_PER_S = 67e12


# the MH step's ms/iter and the slice's ms/iter of each ASIS slice, by
# label (phase_asis_slice)
MH_MS = {}
SLICE_MS = {}
# device memory allocated when run_slice's timed run starts (bytes): what
# a slice's peak is read against
SLICE_HELD = {}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def holey_healpix_mask(nside):
    """A 20 deg band plus holes on the first (cap) ring, in the belt and on
    the south cap, in RING order (tests/test_sparse.py::make_holey_healpix)."""
    from gibbssampler_tpu_torch.sht import galactic_band_mask
    mask = galactic_band_mask(nside, 20.0)
    mask[0:4] = 0.0
    mask[200:203] = 0.0
    mask[-3:] = 0.0
    return mask


def holey_mask(grid, seed=3, nholes=6, band=0.25, apo=0.15):
    """An apodized band and square holes at random positions: the
    planckish shape at toy scale (tests/test_sparse.py::holey_mask)."""
    lat = np.abs(np.pi / 2 - grid.theta)
    x = np.clip((lat - band) / apo, 0.0, 1.0)
    keep = 0.5 - 0.5 * np.cos(np.pi * x)
    mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi)).copy()
    rng = np.random.default_rng(seed)
    for _ in range(nholes):
        r = rng.integers(0, grid.nrings)
        c = rng.integers(0, grid.nphi)
        mask[max(0, r - 1): r + 2, max(0, c - 1): c + 2] = 0.0
    return mask


def tri_table(torch, L, nr, dtype, dev, gen):
    lam = torch.randn((L, L, nr), generator=gen, dtype=dtype, device=dev)
    tri = (torch.arange(L, device=dev)[None, :]
           >= torch.arange(L, device=dev)[:, None])
    return (lam * tri[:, :, None].to(dtype)).contiguous()


def time_ms(torch, fn, reps):
    """Mean ms per call from CUDA events over ``reps`` calls after 2 warm."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Mean device ms per call: ``reps`` calls captured in one CUDA graph
    (after 2 warm calls on a side stream) and replayed between CUDA events,
    so that no host time (a wrapper's checks, its launch) sits between the
    calls.  ``fn`` must not synchronize with the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def x_view(x):
    """x as ``_lsynth_stack`` passes it: the (m, C, l) view of (C, m, l)
    grids."""
    return x.transpose(0, 1).contiguous().transpose(0, 1)


def g_view(g):
    """g as ``_ladj_stack`` passes it: the (m, r, C) view of an (m, C, r)
    copy."""
    return g.transpose(1, 2).contiguous().transpose(1, 2)


def work(name, L, nr, C, itemsize=4):
    """(FLOPs of the triangle, bytes that must move) of one call: the batch
    and table halves read once, the output written once (the adjoint's
    zeros of l < m included)."""
    tri = L * (L + 1) // 2
    if name == "legendre_synth_tri":
        nbytes = C * tri + nr * tri + L * nr * C
    else:
        nbytes = nr * tri + L * nr * C + C * L * L
    return 2 * nr * C * tri, nbytes * itemsize


def bound(flops, nbytes, flops_per_s=TF32X3_FLOPS_PER_S):
    """(ms, what bounds it): the least time of one call, the larger of its
    bytes over the HBM rate and its FLOPs over ``flops_per_s`` (the 3xTF32
    rate for float32, the float64 tensor-core peak for float64)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(lk, card="card"):
    """Build every kernel source (nvcc in parallel) and the native table
    engine (g++); print ptxas's report of each kernel, the float32
    kernels' dynamic shared memory and the plans of the float64 and the
    narrow-table float64 kernels, with the card."""
    from gibbssampler_tpu_torch.sht import legendre as tl
    t0 = time.time()
    built = lk.build()
    print(f"built {', '.join(os.path.relpath(so) for so, _ in built.values())}"
          f" in {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    check(tl.native_engine() is not None,
          "the native table engine (csrc/tables.cpp) did not build or load")
    print(f"native table engine built and loaded in {time.time() - t0:.1f} s",
          flush=True)
    keys = ("Compiling entry function", "spill", "Used")
    for _, report in built.values():
        for ln in report.splitlines():
            if any(k in ln for k in keys):
                print(f"  ptxas: {ln.strip()}", flush=True)
    print(f"  float32 kernels' dynamic shared memory (bytes): "
          f"{lk.f32_dynamic_smem()}", flush=True)
    print(f"  bfloat16-table kernels' dynamic shared memory (bytes): "
          f"{lk.bf16_dynamic_smem()}", flush=True)
    print(f"  bfloat16-table kernels' resident blocks an SM (cudaOccupancy"
          f"MaxActiveBlocksPerMultiprocessor): {lk.bf16_blocks_per_sm()}",
          flush=True)
    print(f"  float16-table kernels' dynamic shared memory (bytes): "
          f"{lk.bf16_dynamic_smem('f16')}, resident blocks an SM: "
          f"{lk.bf16_blocks_per_sm('f16')} [{card}]", flush=True)
    for nr, C in PAIR_DENSE_SHAPES:
        plan = lk.narrow_plan(nr, C)["f64f32"]
        sp, ap = plan["synth"], plan["adj"]
        ws, wa = lk.wide_synth_plan(nr, C), lk.wide_adj_plan(nr, C)
        check(sp["ring_tiles"] == ws["ring_tiles"]
              and sp["threads"] == 32 * ws["warps"]
              and sp["warp_rings"] == ws["warp_rings"]
              and sp["col_tile"] == ws["col_tile"],
              f"float64-table dense synthesis plan at nr {nr}, C {C}: {sp}, "
              f"legendre_kernels.wide_synth_plan {ws}")
        check(ap["threads"] == 32 * wa["warps"]
              and ap["col_tile"] == wa["col_tile"] and ap["rows"] == wa["rows"],
              f"float64-table dense adjoint plan at nr {nr}, C {C}: {ap}, "
              f"legendre_kernels.wide_adj_plan {wa}")
        print(f"  float64-table float32 kernels' (f64f32) threads, dynamic "
              f"shared memory (bytes), resident blocks an SM, synthesis "
              f"ring tiles and the dense pair's columns a block at nr {nr}, "
              f"C {C}: {plan} (wide_synth_plan {ws}, wide_adj_plan {wa}) "
              f"[{card}]", flush=True)
    report = built["legendre_tri_narrow_f64"][1]
    for nr, C in PAIR_PAR_SHAPES:
        plan = lk.narrow_plan(nr, C)["f64f32"]
        sp, ap = plan["synth_par"], plan["adj_par"]
        ws = lk.wide_par_synth_plan((nr + 1) // 2, C)
        wa = lk.wide_par_adj_plan(nr, C)
        check(sp["ring_tiles"] == ws["ring_tiles"]
              and sp["threads"] == 32 * ws["warps"]
              and sp["warp_rings"] == ws["warp_rings"]
              and sp["col_tile"] == ws["col_tile"],
              f"float64-table parity synthesis plan at nr {nr}, C {C}: {sp}, "
              f"legendre_kernels.wide_par_synth_plan {ws}")
        check(ap["threads"] == 32 * wa["warps"]
              and ap["col_tile"] == wa["col_tile"] and ap["rows"] == wa["rows"],
              f"float64-table parity adjoint plan at nr {nr}, C {C}: {ap}, "
              f"legendre_kernels.wide_par_adj_plan {wa}")
        print(f"  float64-table float32 parity kernels' (f64f32) threads, "
              f"dynamic shared memory (bytes), resident blocks an SM, "
              f"synthesis ring tiles, columns a block and adjoint rows l a "
              f"block at nr {nr} (nh {(nr + 1) // 2}), C {C}: synthesis {sp}, "
              f"adjoint {ap} (wide_par_synth_plan {ws}, wide_par_adj_plan "
              f"{wa}); ptxas {ptxas_usage(report, '_par_wide')} [{card}]",
              flush=True)
    for nr, C in F64_TIMED:
        print(f"  float64 kernels' threads and dynamic shared memory "
              f"(bytes) at nr {nr}, C {C}: {lk.f64_plan(nr, C)}", flush=True)
    for nr, C in NARROW_DENSE_SHAPES:
        plan = {dt: {k: v for k, v in p.items() if k in ("synth", "adj")}
                for dt, p in lk.narrow_plan(nr, C).items()}
        for dt, p in plan.items():
            es = NARROW_TABLE_BYTES[dt]
            for kind in ("synth", "adj"):
                want = lk.narrow_col_tile(kind, es, nr, C)
                check(p[kind]["col_tile"] == want,
                      f"narrow-table {dt} {kind} plan at nr {nr}, C {C}: "
                      f"{p[kind]}, legendre_kernels.narrow_col_tile {want}")
        print(f"  narrow-table float64 dense kernels' threads, dynamic shared "
              f"memory (bytes), resident blocks an SM and synthesis ring "
              f"tiles at nr {nr}, C {C}: {plan} [{card}]", flush=True)
    for nr, C in NARROW_PAR_SHAPES:
        plan = {dt: {k: v for k, v in p.items() if k.endswith("_par")}
                for dt, p in lk.narrow_plan(nr, C).items()}
        want = lk.narrow_par_synth_plan((nr + 1) // 2, C)
        for dt, p in plan.items():
            sp = p["synth_par"]
            if dt == "f64f32":  # the wide parity pair's plan: above
                continue
            check(sp["ring_tiles"] == want["ring_tiles"]
                  and sp["warp_rings"] == want["warp_rings"]
                  and sp["threads"] == 32 * want["warps"],
                  f"narrow parity synthesis plan {dt} at nr {nr}, C {C}: "
                  f"{sp}, legendre_kernels.narrow_par_synth_plan {want}")
        print(f"  narrow-table float64 parity kernels' threads, dynamic "
              f"shared memory (bytes), resident blocks an SM and synthesis "
              f"ring tiles at nr {nr} (nh {(nr + 1) // 2}), C {C}: {plan} "
              f"(narrow_par_synth_plan {want}) [{card}]", flush=True)


def ptxas_usage(report, marker):
    """{kernel: ptxas's registers and spill lines} of the entry functions
    of ``report`` (nvcc -Xptxas -v) whose mangled name holds ``marker``,
    each named by its name and template arguments."""
    out, name = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"([a-z][a-z_]*%s\w*?I(?:L\w\d+E)+)"
                          % re.escape(marker), ln)
            name = m.group(1) if m else None
        elif name and ("spill" in ln or "Used" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


TOLS = {"float32": 1e-5, "float64": 1e-12}


def kernel_check(torch, lk, L, nr, C, dtype, dev, gen, label="kernels"):
    """Both kernels against their plain versions at (L, nr, C, dtype), on
    contiguous operands and on the strided views the main path passes,
    the outputs given NaN-filled memory, with the adjointness of the pair.
    Returns (lam, {layout: (x, g, {kernel: max|err|})})."""
    tol = TOLS[str(dtype)[6:]]
    lam = tri_table(torch, L, nr, dtype, dev, gen)
    x0 = torch.randn((L, C, L), generator=gen, dtype=dtype, device=dev)
    g0 = torch.randn((L, nr, C), generator=gen, dtype=dtype, device=dev)
    # y = K1 x + noise, so that <K1 x, y> is large
    y0 = (lk.legendre_synth_tri_plain(lam, x0)
          + torch.randn((L, nr, C), generator=gen, dtype=dtype, device=dev))
    res = {}
    for lay, (x, g, y) in {"contiguous": (x0, g0, y0),
                           "state views": (x_view(x0), g_view(g0),
                                           g_view(y0))}.items():
        errs, rels = {}, {}
        for name, kern, plain, b, shape in (
                ("legendre_synth_tri", lk.legendre_synth_tri,
                 lk.legendre_synth_tri_plain, x, (L, nr, C)),
                ("legendre_adj_tri", lk.legendre_adj_tri,
                 lk.legendre_adj_tri_plain, g, (C, L, L))):
            # NaN in the memory the output will be given: the kernel must
            # write every element, the adjoint's l < m zeros too
            torch.full(shape, float("nan"), dtype=dtype, device=dev)
            out = kern(lam, b)
            ref = plain(lam, b)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            check(err <= tol * scale,
                  f"{name} L={L} nr={nr} C={C} {dtype} {lay}: max|err| "
                  f"{err} > {tol} * {scale}")
            errs[name] = err
            rels[name] = err / scale
        lhs = float((lk.legendre_synth_tri(lam, x).double()
                     * y.double()).sum())
        rhs = float((x.double() * lk.legendre_adj_tri(lam, y).double()).sum())
        rel = abs(lhs - rhs) / abs(lhs)
        check(rel <= (1e-5 if dtype == torch.float32 else 1e-12),
              f"adjointness L={L} nr={nr} C={C} {dtype} {lay}: {rel}")
        print(f"{label} L={L} nr={nr} C={C} {str(dtype)[6:]} {lay}: "
              f"max|err|/max|ref| synth {rels['legendre_synth_tri']:.2e} adj "
              f"{rels['legendre_adj_tri']:.2e} (<= {tol}), adjointness "
              f"{rel:.2e}", flush=True)
        res[lay] = (x, g, errs)
    return lam, res


def phase3_shapes(torch):
    """The (L, nr, C, dtype) shapes phase 3 checks."""
    f32, f64 = torch.float32, torch.float64
    return ([(L, nr, C, (f32, f64)) for L, nr, C in
             [(16, 12, 8), (37, 19, 10), (LMAX + 1, CUT_RINGS, 200)]
             + [(LMAX + 1, nr, 2 * NCHAINS) for nr in TIMED_NR]]
            + [(LMAX + 1, nr, C, (f32, f64) if C == 2 * CG_CHAINS
                else (f64,)) for nr, C in F64_TIMED]
            + [(*sh, (f64,)) for sh in F64_EXTRA])


def phase_kernels(torch, lk, dev, card):
    """Kernel vs plain on the card, contiguous and in the main path's
    layouts; returns the main-path records, float32 and float64."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain versions must run in true float32 (allow_tf32 is on)")
    gen = torch.Generator(device=dev).manual_seed(0)
    rec, rec64 = {}, {}
    for L, nr, C, dtypes in phase3_shapes(torch):
        for dtype in dtypes:
            lam, res = kernel_check(torch, lk, L, nr, C, dtype, dev, gen)
            if L == LMAX + 1 and (
                    (C == 2 * NCHAINS and dtype == torch.float32)
                    or ((nr, C) in F64_TIMED and dtype == torch.float64)):
                into = rec if dtype == torch.float32 else rec64
                # keyed by nr at the main path's columns
                key = nr if C in (2 * NCHAINS, 2 * CG_CHAINS) \
                    else f"{nr} C{C}"
                for lay, (x, g, errs) in res.items():
                    for name, r in time_kernels(torch, lk, lam, x, g, lay,
                                                card, errs).items():
                        into.setdefault(name, {})[key] = r
            del lam, res
    torch.cuda.empty_cache()
    return rec, rec64


def phase_new_shapes(torch, lk, dev, card, shapes):
    """Phase 3's checks at every shape the engine sweeps and the runner,
    joint and flat phases launched that phase 3 does not cover (``shapes`` maps (kernel, L, nr,
    C, dtype) to its launches in those phases), each timed as phase 3
    times the main path's layout.  Returns (the shapes checked, the
    float32 and the float64 records keyed "<nr> C<C>")."""
    covered = {(L, nr, C, dt) for L, nr, C, dts in phase3_shapes(torch)
               for dt in dts}
    gen = torch.Generator(device=dev).manual_seed(3)
    new = sorted({k[1:] for k in shapes if k[1:] not in covered},
                 key=lambda k: (str(k[3]), k[:3]))
    rec, rec64 = {}, {}
    for L, nr, C, dtype in new:
        lam, res = kernel_check(torch, lk, L, nr, C, dtype, dev, gen,
                                label="kernels (a new phases' shape)")
        x, g, errs = res["state views"]
        into = rec if dtype == torch.float32 else rec64
        for name, r in time_kernels(torch, lk, lam, x, g, "state views",
                                    card, errs).items():
            into.setdefault(name, {})[f"{nr} C{C}"] = r
        del lam, res, x, g
    torch.cuda.empty_cache()
    return new, rec, rec64


def time_kernels(torch, lk, lam, x, g, lay, card, errs):
    """Kernel and plain times (plain, kernel, kernel, plain) with rates
    and the bound; returns the records of the main path's layout."""
    L, nr, C = lam.shape[0], lam.shape[2], x.shape[1]
    f32 = lam.dtype == torch.float32
    reps = 5 if nr > LMAX and f32 else 20
    rec = {}
    for name, kern, plain, b in (
            ("legendre_synth_tri", lk.legendre_synth_tri,
             lk.legendre_synth_tri_plain, x),
            ("legendre_adj_tri", lk.legendre_adj_tri,
             lk.legendre_adj_tri_plain, g)):
        p1 = time_ms(torch, lambda: plain(lam, b), reps)
        k1 = time_ms(torch, lambda: kern(lam, b), reps)
        k2 = time_ms(torch, lambda: kern(lam, b), reps)
        p2 = time_ms(torch, lambda: plain(lam, b), reps)
        ms, pms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
        flops, nbytes = work(name, L, nr, C, lam.element_size())
        tflops, gbs = flops / ms * 1e-9, nbytes / ms * 1e-6
        bound_ms, bound_by = bound(
            flops, nbytes, TF32X3_FLOPS_PER_S if f32 else FP64_FLOPS_PER_S)
        rate = (f"({tflops / 67:.1%} of 67 fp32 FMA; 3xTF32 "
                f"{3 * tflops / 495:.1%} of 495 TF32)" if f32 else
                f"({tflops / 33.5:.1%} of 33.5 fp64 FMA, {tflops / 67:.1%} "
                f"of 67 fp64 tensor-core)")
        print(f"time {name} L={L} nr={nr} C={C} {str(lam.dtype)[6:]} {lay}: "
              f"kernel {ms:.4f} ms, plain einsum {pms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of it "
              f"reached; kernel {tflops:.2f} TFLOP/s on the triangle {rate}, "
              f"{gbs:.0f} GB/s ({gbs / 3350:.1%} of 3350) [{card}]",
              flush=True)
        if lay == "state views":
            # the plain version is itself the one library call that
            # computes the function (torch.einsum in true float32 or in
            # float64)
            rec[name] = {"design": "3xtf32-mma.sync" if f32
                         else "fp64-fma-stream",
                         "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": pms, "tflops": tflops}
    return rec


# builds of the float64 kernels that keep some of their parts
# (LEGENDRE_F64_PARTS in csrc/legendre_tri_f64.cu): the table's copies
# with the table's shared-memory reads, the batch's copies, the products
# with their shared-memory reads and no copies
F64_PARTS = {"whole": 7, "table copies": 1, "batch copies": 2,
             "products": 4}


# the float64 parity kernels' shape in phase_f64_parts: the GL grid's 513
# rings (257 north) at the CG family's split spin-2 columns of 8 chains;
# the parity adjoint also at the columns of 4
F64_PAR_PARTS = (LMAX + 1, 4 * CG_CHAINS)


def phase_f64_parts(torch, lk, dev, card):
    """Each float64 dense kernel at the F64_TIMED shapes, both parity
    kernels at F64_PAR_PARTS and the parity adjoint at half its columns
    (L 513, the state views), built whole and with one part alone: ms and
    the share of the whole call's bound that each reaches, the builds in
    turn both ways in one process.  A part alone computes a wrong result
    on purpose; the whole is held to the plain version.  Returns {"kernel
    nr C": {part: ms}}."""
    gen = torch.Generator(device=dev).manual_seed(0)
    f64, L = torch.float64, LMAX + 1
    defines = {p: () if v == 7 else (f"LEGENDRE_F64_PARTS={v}",)
               for p, v in F64_PARTS.items()}
    for d in defines.values():
        lk.build(d)
    res = {}
    nr_p, C_p = F64_PAR_PARTS
    for nr, C, names in [(nr, C, ("synth_tri", "adj_tri"))
                         for nr, C in F64_TIMED] + [
            (nr_p, C_p, ("synth_par", "adj_par")),
            (nr_p, C_p // 2, ("adj_par",))]:
        par = names[0].endswith("_par")
        nt = (nr + 1) // 2 if par else nr
        lam = tri_table(torch, L, nt, f64, dev, gen)
        x = x_view(torch.randn((L, C, L), generator=gen, dtype=f64,
                               device=dev))
        g = g_view(torch.randn((L, nr, C), generator=gen, dtype=f64,
                               device=dev))
        cases = [(f"legendre_{n}", getattr(lk, f"legendre_{n}"),
                  getattr(lk, f"legendre_{n}_plain"),
                  x if n.startswith("synth") else g,
                  (nr,) if n == "synth_par" else ()) for n in names]
        for name, kern, plain, b, args in cases:
            lk.build()
            ref = plain(lam, b, *args)
            err = float((kern(lam, b, *args) - ref).abs().max()
                        / ref.abs().max())
            check(err <= 1e-12, f"{name} nr={nr} C={C} float64: max|err| / "
                  f"max|ref| {err}")
            bound_ms = bound(*(work_par(name, L, nr, C, 8) if par
                               else work(name, L, nr, C, 8)),
                             FP64_FLOPS_PER_S)[0]
            ms = {}
            for order in (list(defines), list(defines)[::-1]):
                for part in order:
                    lk.build(defines[part])
                    ms.setdefault(part, []).append(
                        time_ms(torch, lambda: kern(lam, b, *args), 20))
            row = {p: sum(t) / len(t) for p, t in ms.items()}
            res[f"{name} {nr} {C}"] = row
            print(f"f64 parts {name} L={L} nr={nr} C={C} state views: bound "
                  f"{bound_ms:.4f} ms; " + "; ".join(
                      f"{p} {t:.4f} ms ({bound_ms / t:.1%})"
                      for p, t in row.items()) + f" [{card}]", flush=True)
        del lam, x, g
    lk.build()
    return res


def cut_adjointness(torch, cut, e, b, gen):
    """|<A (e, b), y> - <(e, b), A^T y>| / |<A (e, b), y>| of a spin-2 cut
    transform, y = A (e, b) + noise, accumulated in float64."""
    q, u = cut.synthesis_spin2_state(e, b)
    q2 = q + torch.randn(q.shape, generator=gen, dtype=q.dtype,
                         device=q.device)
    u2 = u + torch.randn(u.shape, generator=gen, dtype=u.dtype,
                         device=u.device)
    ae, ab = cut.adjoint_synthesis_spin2_state(q2, u2)
    lhs = float((q.double() * q2.double()).sum()
                + (u.double() * u2.double()).sum())
    rhs = float((e.double() * ae.double()).sum()
                + (b.double() * ab.double()).sum())
    return abs(lhs - rhs) / abs(lhs)


def phase_sht(torch, dev, hp_mask):
    """lmax-512 float32 transforms on the card; returns the full SHT."""
    from gibbssampler_tpu_torch.harmonics import ell_mask_state, nstate
    from gibbssampler_tpu_torch.ops import healpix_cut_weights
    from gibbssampler_tpu_torch.sht import (SHT, SphereGrid, healpix_layout,
                                            make_sht, subgrid_rows)
    t0 = time.time()
    sht = make_sht(LMAX, dtype=torch.float32, spin2=True, device=dev)
    print(f"sht lmax={LMAX} grid {sht.nrings}x{sht.nphi}: tables built in "
          f"{time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    f32 = dict(dtype=torch.float32, device=dev)
    m2 = torch.as_tensor(ell_mask_state(LMAX, 2), **f32)
    m0 = torch.as_tensor(ell_mask_state(LMAX, 0), **f32)
    e = torch.randn((2, nstate(LMAX)), generator=gen, **f32) * m2
    b = torch.randn((2, nstate(LMAX)), generator=gen, **f32) * m2
    x = torch.randn((2, nstate(LMAX)), generator=gen, **f32) * m0
    e2, b2 = sht.analysis_spin2_state(*sht.synthesis_spin2_state(e, b))
    x2 = sht.analysis_state(sht.synthesis_state(x))
    rt2 = float(torch.maximum((e2 - e).abs().max(), (b2 - b).abs().max())
                / e.abs().max())
    rt0 = float((x2 - x).abs().max() / x.abs().max())
    # ~3e-7 at lmax 32-128 in float32 on the CPU, growing slowly with lmax
    check(rt2 <= 5e-5 and rt0 <= 5e-5,
          f"float32 round trip rel err spin2 {rt2} spin0 {rt0} > 5e-5")
    lat = np.abs(np.pi / 2 - sht.grid.theta)
    rows = np.where(lat <= 0.2)[0]
    cut = SHT(subgrid_rows(sht.grid, rows), LMAX, dtype=torch.float32,
              spin2=True, device=dev)
    rel = cut_adjointness(torch, cut, e, b, gen)
    check(rel <= 1e-5, f"cut transform adjointness {rel} > 1e-5")
    # the HEALPix floor transform of bench.py's planckish mask: its belt
    # rows (the host-side split only) at nphi 2 lmax, with their phi0
    lay = healpix_layout(NSIDE, "padded")
    geo = lay.geo
    hp_rows = healpix_cut_weights(lay, hp_mask[lay.src_of][None] * lay.valid,
                                  lay.valid)[0]
    hcut = SHT(SphereGrid(name="healpix floor", theta=geo.theta[hp_rows],
                          weights=np.ones(hp_rows.size), nphi=lay.nb,
                          phi0=geo.phi0[hp_rows]),
               LMAX, dtype=torch.float32, spin2=True, device=dev,
               allow_aliasing=True)
    check(hcut.nphi == 2 * LMAX and hcut.has_phase,
          "HEALPix floor transform: not at nphi 2 lmax with phased rows")
    hrel = cut_adjointness(torch, hcut, e, b, gen)
    check(hrel <= 1e-5, f"HEALPix floor transform adjointness {hrel} > 1e-5")
    print(f"sht float32: round trip max rel err spin2 {rt2:.2e} spin0 "
          f"{rt0:.2e}; cut transform ({rows.size} rings) adjointness "
          f"{rel:.2e}; HEALPix nside {NSIDE} floor transform "
          f"({hp_rows.size} belt rows, nphi {hcut.nphi}) adjointness "
          f"{hrel:.2e}", flush=True)
    return sht


def small_dataset(torch, lmax, kind="band"):
    """The lmax-16 band-masked, holey-masked or HEALPix holey-masked
    (nside lmax / 2, padded layout) polarized dataset of the small-step
    phase, as the numpy fields ``interop.model_from_numpy`` takes."""
    from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
    from gibbssampler_tpu_torch.sht import gauss_legendre_grid, make_healpix_sht
    gen = torch.Generator().manual_seed(2)
    dls = np.stack([example_dl(lmax, "ee"), example_dl(lmax, "bb")])
    sht = None
    if kind == "healpix":
        sht = make_healpix_sht(lmax // 2, lmax, dtype=torch.float64,
                               spin2=True, layout="padded", device="cpu")
        mask = holey_healpix_mask(lmax // 2)
    else:
        grid = gauss_legendre_grid(lmax)
        if kind == "holey":
            mask = holey_mask(grid)
        else:
            keep = (np.abs(np.pi / 2 - grid.theta) > 0.2).astype(np.float64)
            mask = np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
    cpu_model, _ = simulate_dataset(lmax, 2, dls, 0.2 ** 2,
                                    fwhm_radians=np.radians(0.5), mask=mask,
                                    dtype=torch.float64, device="cpu",
                                    sht=sht, gen=gen)
    arrays = {"d": cpu_model.d.numpy(), "tau": cpu_model.noise.tau.numpy(),
              "q_map": cpu_model.noise.q_map.numpy(),
              "omega": cpu_model.noise.omega, "bl": cpu_model.bl.numpy(),
              "spin": 2}
    if kind == "healpix":
        arrays.update(grid="healpix", nside=lmax // 2, layout="padded")
    else:
        g = cpu_model.sht.grid
        arrays.update(theta=g.theta, weights=g.weights, phi0=g.phi0,
                      nphi=g.nphi)
    return arrays, dls


# the small card-vs-CPU steps: name -> (mask, scheme, CR method)
SMALL_STEPS = {
    "centered": ("band", "centered", "aux_mala"),
    "asis": ("band", "asis", "aux_mala"),
    "asis holey": ("holey", "asis", "aux_mala"),
    "asis healpix holey": ("healpix", "asis", "aux_mala"),
    "centered cg": ("band", "centered", "cg"),
    "centered rjpo": ("band", "centered", "rjpo"),
    "centered pcn": ("band", "centered", "pcn"),
    "centered cg holey": ("holey", "centered", "cg"),
    "noncentered": ("band", "noncentered", "aux_mala"),
    "pncp": ("band", "pncp", "aux_mala"),
}


def small_scheme(model, name, kind, cr, bins, blocks, sig):
    """The small-step phase's scheme ``name`` on ``model``; checks that the
    blocked-MH schemes run on the table engine (PNCP with its identity
    re-centering; on HEALPix with the ring-phase and Nyquist paths)."""
    from gibbssampler_tpu_torch.schemes import (ASISGibbs, CenteredGibbs,
                                                NonCenteredGibbs, PNCPGibbs)
    kw = dict(cr_method=cr, cr_options={"n_gibbs": 1, "tau": 0.02}
              if cr == "aux_mala" else {})
    if kind == "centered":
        return CenteredGibbs(model, bins, **kw)
    if kind == "pncp":
        # EE fully centered, BB non-centered from l = 10
        scheme = PNCPGibbs(model, bins, blocks, sig,
                           l_cut=(int(bins[0][-1]), 10), **kw)
        check(scheme.mh_plan is not None and scheme.mh_plan.lowm is not None
              and scheme.blocks_list[0] == (), "small PNCP step off the "
              "table engine's identity re-centering")
    else:
        cls = ASISGibbs if kind == "asis" else NonCenteredGibbs
        scheme = cls(model, bins, blocks, sig, **kw)
    check(scheme._use_cut_mh, f"small {name} step off the table engine")
    if model.noise.pix_ndim == 1:
        plan = scheme.mh_plan
        check(plan.ph_c is not None
              and all(c.lnyq is not None for c in plan.chunks),
              f"small {name} step off the table engine's ring-phase and "
              "Nyquist paths")
    return scheme


def phase_small_steps(torch, dev):
    """One step of each scheme of SMALL_STEPS at lmax 16 in float64, card
    against CPU, on the same dataset and injected variates: CenteredGibbs
    with the aux_mala, cg, rjpo and pcn CRs (cg on a holey mask too),
    ASISGibbs on a band, a holey (floor + sparse-hole split) and a holey
    HEALPix mask (nside 8, padded layout, cap-ring holes in the point set),
    NonCenteredGibbs and PNCPGibbs (EE fully centered, BB non-centered from
    l = 10, the table engine's identity re-centering): the kernels inside
    every path, the CG solver, the point-set transform and the MH table
    engine (on HEALPix with its ring-phase and Nyquist paths) on the
    card."""
    from gibbssampler_tpu_torch.interop import model_from_numpy
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    from gibbssampler_tpu_torch.schemes.gibbs import GibbsState
    lmax, nch = 16, 4
    cbins = np.array([2, 4, 7, 11, 17])
    abins = [np.arange(2, lmax + 2), np.array([2, 3, 4, 5, 6, 7, 8, 9, 10,
                                               12, 15, 17])]
    ablocks = [[(0, lmax - 1)], [(0, 4)] + [(i, i + 1) for i in range(4, 11)]]
    data = {}
    for name, (mask, kind, cr) in SMALL_STEPS.items():
        if mask not in data:
            data[mask] = small_dataset(torch, lmax, mask)
        arrays, dls = data[mask]
        bins = [cbins, cbins] if kind == "centered" else abins
        dl0 = [np.tile([d[lo:hi].mean() for lo, hi in zip(b[:-1], b[1:])],
                       (nch, 1)) for d, b in zip(dls, bins)]
        sig = [0.3 * d[0] for d in dl0]
        rng = np.random.default_rng(3)
        outs = []
        for device in ("cpu", dev):
            model = with_cut_decomposition(model_from_numpy(arrays, device))
            check(model.has_sparse == (mask != "band"),
                  f"small {name} step: sparse split {model.has_sparse}")
            scheme = small_scheme(model, name, kind, cr, bins, ablocks, sig)
            t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                          device=device)
            if not outs:
                var = scheme.var_cls(tuple(t(d) for d in dl0)).cpu().numpy()
                s0 = np.sqrt(var) * rng.normal(size=var.shape)
                pool = {k: rng.normal(size=tuple(v.shape)) for k, v in
                        scheme.draw_noise_pool(nch).items()}
                inj = {"noise": pool, "u": rng.uniform(size=nch)}
                if kind != "noncentered":
                    inj["gammas"] = [rng.gamma(3.0, size=(nch, len(b) - 1))
                                     for b in bins]
                if kind != "centered":
                    ntot = sum(len(b) - 1 for b in bins)
                    inj["u_prop"] = rng.uniform(size=(nch, 1, ntot))
                    inj["u_acc"] = rng.uniform(size=(nch, 1, sum(
                        map(len, scheme.blocks_list))))
            kw = {k: ({kk: t(vv) for kk, vv in v.items()} if k == "noise"
                      else tuple(t(x) for x in v) if k == "gammas"
                      else t(v)) for k, v in inj.items()}
            state = GibbsState(s=t(s0), dl=tuple(t(d) for d in dl0))
            new, info = scheme.step(state, **kw)
            out = [new.s, *new.dl, info["cr_accept"], *info.get(
                "mh_accept", ())]
            outs.append([x.cpu().numpy() for x in out])
        worst = 0.0
        for a, b in zip(*outs):
            if a.size:     # PNCP's EE has no MH block
                err = float(np.abs(a - b).max()
                            / max(np.abs(a).max(), 1e-300))
                worst = max(worst, err)
        check(worst <= 1e-9, f"small {name} step card vs CPU rel err {worst} "
              "> 1e-9")
        for a, b in zip(outs[0][3:], outs[1][3:]):
            check(np.array_equal(a, b), f"small {name} step: CR or MH "
                  "accepts differ between card and CPU")
        print(f"small {name} step ({cr} CR) lmax={lmax} {nch} chains "
              f"float64: card vs CPU max rel err {worst:.2e}, CR accepts "
              f"{outs[0][3].mean():.2f}", flush=True)


def phase_dataset(torch, sht):
    """The main path's dataset (flagship GL band): band-masked polarized
    sky at lmax 512 on the GL grid, cut decomposition over 65 rings,
    float32."""
    from gibbssampler_tpu_torch import flagship
    t0 = time.time()
    model, dls, _ = flagship.dataset("gl", "band", LMAX, sht=sht)
    check(model.cut_sht.nrings == CUT_RINGS,
          f"{model.cut_sht.nrings} cut rings, expected {CUT_RINGS}")
    check(model.cut_w_uniform and model.cut_w_equal_fields,
          "band mask: cut weights not uniform")
    torch.cuda.synchronize()
    print(f"dataset set-up (simulate, cut decomposition over "
          f"{model.cut_sht.nrings} rings): {time.time() - t0:.1f} s",
          flush=True)
    return model, dls


def phase_planckish_dataset(torch, sht):
    """The planckish dataset (flagship GL planckish): the same sky under
    bench.py's planckish mask, float32; checks the floor + sparse-hole
    split's exact sizes."""
    from gibbssampler_tpu_torch import flagship
    t0 = time.time()
    model, dls, mask = flagship.dataset("gl", "planckish", LMAX, sht=sht)
    sp = model.sp_sht
    check(model.has_sparse, "planckish mask: no sparse split")
    got = (model.cut_sht.nrings, sp.nslots, (sp.nrows, sp.p))
    want = (PLANCKISH_FLOOR_RINGS, PLANCKISH_HOLE_PIX, PLANCKISH_POINT_ROWS)
    check(got == want, f"planckish split (floor rings, hole pixels, point "
          f"rows) {got}, expected {want}")
    check(model.cut_w_uniform and model.cut_w_equal_fields,
          "planckish floor: cut weights not uniform")
    torch.cuda.synchronize()
    print(f"planckish dataset: f_sky {mask.mean():.4f}, floor over "
          f"{got[0]} rings, {got[1]} hole pixels in {sp.nrows} x {sp.p} "
          f"point rows; mask and set-up {time.time() - t0:.1f} s",
          flush=True)
    return model, dls


def phase_healpix_dataset(torch, dev):
    """The HEALPix planckish dataset: the same sky on the nside-256 grid
    (padded layout) under bench.py's HEALPix planckish mask, float32.
    Checks the split's exact sizes and the floor transform against the full
    grid's synthesis at the floor pixels."""
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.harmonics import ell_mask_state, nstate
    from gibbssampler_tpu_torch.ops import healpix_cut_weights
    t0 = time.time()
    hsht = flagship.flagship_sht("healpix", LMAX, dev)
    torch.cuda.synchronize()
    t1 = time.time()
    model, dls, mask = flagship.dataset("healpix", "planckish", LMAX,
                                        sht=hsht)
    torch.cuda.synchronize()
    t2 = time.time()
    cut, sp, geo = model.cut_sht, model.sp_sht, hsht.geo
    check(model.has_sparse, "HEALPix planckish mask: no sparse split")
    on_caps = (sp.theta < geo.theta[NSIDE - 1]) | (
        sp.theta > geo.theta[3 * NSIDE - 1])
    cap_pix = int(sp.valid.sum(dim=1).cpu().numpy()[on_caps].sum())
    got = (cut.nrings, cut.nphi, int((cut.grid.phi0 != 0).sum()), sp.nslots,
           cap_pix, (sp.nrows, sp.p))
    want = (HEALPIX_FLOOR_RINGS, 2 * LMAX, HEALPIX_PHASED_ROWS,
            HEALPIX_HOLE_PIX, HEALPIX_CAP_HOLE_PIX, HEALPIX_POINT_ROWS)
    check(got == want, f"HEALPix planckish split (floor rings, nphi, phased "
          f"rows, hole pixels, on caps, point rows) {got}, expected {want}")
    check(model.cut_w_uniform and model.cut_w_equal_fields,
          "HEALPix planckish floor: cut weights not uniform")
    # the floor transform (193 rows) against the full 1023-ring synthesis
    # at the floor pixels, float32
    idx = healpix_cut_weights(hsht.lay, model.noise.tau.cpu().numpy(),
                              model.noise.q_map.cpu().numpy())[1]
    g = torch.Generator(device=dev).manual_seed(3)
    m2 = torch.as_tensor(ell_mask_state(LMAX, 2), dtype=torch.float32,
                         device=dev)
    s = torch.randn((2, 2, nstate(LMAX)), generator=g, dtype=torch.float32,
                    device=dev) * m2
    full = model.synthesis(s)[..., torch.as_tensor(idx, device=dev)]
    err = float((model.synthesis_cut(s) - full).abs().max()
                / full.abs().max())
    check(err <= 5e-5, f"HEALPix floor synthesis vs the full grid's at the "
          f"floor pixels: rel err {err} > 5e-5")
    torch.cuda.synchronize()
    print(f"HEALPix planckish dataset nside {NSIDE} ({HEALPIX_RINGS} rings, "
          f"{geo.npix} pixels, {hsht.npadded} padded slots): f_sky "
          f"{mask.mean():.4f}, floor over {got[0]} belt rings at nphi "
          f"{got[1]} ({got[2]} phased), {got[3]} hole pixels ({got[4]} on "
          f"cap rings) in {sp.nrows} x {sp.p} point rows; floor vs full "
          f"synthesis rel err {err:.2e}; full-grid tables {t1 - t0:.1f} s, "
          f"mask, simulate and cut decomposition {t2 - t1:.1f} s",
          flush=True)
    return model, dls


def run_slice(torch, lk, scheme, dl0, dev, n_timed=N_TIMED, n_warm=N_WARM):
    """Drive one scheme's main path: the launch counts set to 0, the
    initial CR draw and ``n_warm`` warm-up iterations, then ``n_timed`` timed
    ones, the counts read just after.  The chains start as
    ``flagship.start_state`` starts them.  Returns (warm, out, wall,
    launches of the whole path, launches of the timed run)."""
    from gibbssampler_tpu_torch.flagship import start_state
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    lk.reset_launch_counts()
    warm = scheme.run(dl0, n_iter=n_warm, gen=gen,
                      state=start_state(scheme, dl0, NCHAINS, gen))
    torch.cuda.synchronize()
    before = (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches)
    SLICE_HELD["last"] = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    out = scheme.run(dl0, n_iter=n_timed, gen=gen, state=warm["final_state"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches)
    timed = tuple(a - b for a, b in zip(launches, before))
    return warm, out, wall, launches, timed


def check_chains(torch, warm, out, bins_list, n_timed=N_TIMED,
                 n_warm=N_WARM):
    dl_all = [np.concatenate([warm["dl_chains"][f].cpu().numpy(),
                              out["dl_chains"][f].cpu().numpy()], axis=1)
              for f in range(2)]
    for f, dl in enumerate(dl_all):
        check(dl.shape == (NCHAINS, n_warm + n_timed, len(bins_list[f]) - 1),
              f"dl_chains[{f}] shape {dl.shape}")
        check(np.isfinite(dl).all() and (dl > 0).all(),
              f"dl_chains[{f}] has non-finite or non-positive values")
    acc = float(out["cr_accept"].mean())
    check(acc > 0.0, "mean MALA acceptance is 0")
    return acc


def ess_metrics(out, bins_list, wall, n_timed=N_TIMED):
    """Median pooled ESS/s over both fields, BB-tail (bins from
    BB_TAIL_FROM) ESS/s and per-chain ESS per iteration, as bench.py defines them."""
    from gibbssampler_tpu_torch.diagnostics import summarize_chains
    ess = [summarize_chains(out["dl_chains"][f].cpu().numpy(),
                            burn_frac=0.2)["ess"] for f in range(2)]
    tail = np.asarray(bins_list[-1])[:-1] >= BB_TAIL_FROM
    check(tail.any(), f"no BB bin from l = {BB_TAIL_FROM}")
    bb_tail = float(np.median(ess[-1][tail])) / wall
    med = float(np.median(np.concatenate(ess)))
    return med / wall, bb_tail, med / (0.8 * n_timed * NCHAINS)


def phase_centered_slice(torch, lk, model, dls, dev, card):
    """The centered aux_mala slice at full width; returns its launches."""
    from gibbssampler_tpu_torch.flagship import binned_mean, planck_bins
    from gibbssampler_tpu_torch.schemes import CenteredGibbs
    bins = planck_bins(LMAX)
    scheme = CenteredGibbs(model, [bins, bins], cr_method="aux_mala",
                           cr_options={"n_gibbs": 1, "tau": 0.02})
    dl0 = tuple(binned_mean(d, bins) for d in dls)
    warm, out, wall, launches, timed = run_slice(torch, lk, scheme, dl0, dev)
    for name, n in zip(("synth", "adj"), timed):
        check(n == PER_ITER * N_TIMED,
              f"centered {name} launches in the timed run {n}, expected "
              f"{PER_ITER} x {N_TIMED}")
    acc = check_chains(torch, warm, out, [bins, bins])
    ess_s = ess_metrics(out, [bins, bins], wall)[0]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"slice lmax={LMAX} {NCHAINS} chains centered aux_mala: "
          f"{wall / N_TIMED * 1e3:.2f} ms/iter over {N_TIMED} iterations; "
          f"mean MALA acceptance {acc:.4f}; median pooled ESS/s {ess_s:.3f} "
          f"({N_TIMED} iterations, burn 20%); peak device memory "
          f"{peak:.2f} GiB [{card}]", flush=True)
    print(f"launches in the centered path: legendre_synth_tri {launches[0]}, "
          f"legendre_adj_tri {launches[1]} ({PER_ITER} each per iteration)",
          flush=True)
    return launches


def asis_setup(torch, model, dls, grid, mask, cr="aux_mala", mh_fast="auto"):
    """bench.py's flagship ASIS configuration (``flagship.asis_setup``):
    EE unit bins in one block, BB unit bins to 396 then 16 wide bins, a
    277-bin big block and 133 single-bin blocks, the port's tuned record
    of (grid, mask, cr); checks the sizes and that the MH step runs on the
    table engine (with ``mh_fast="phi"``, the phi-domain engine)."""
    from gibbssampler_tpu_torch import flagship
    t0 = time.time()
    scheme, dl0 = flagship.asis_setup(model, dls, grid, mask, cr,
                                      mh_fast=mh_fast)
    check(tuple(len(b) - 1 for b in scheme.bins_list) == ASIS_NBINS
          and scheme.blocks_list[1][0] == (0, ASIS_BIG)
          and len(scheme.blocks_list[1]) == 1 + ASIS_NBINS[1] - ASIS_BIG,
          "flagship bins and blocks")
    want = "phi" if mh_fast == "phi" else "table"
    check(scheme._use_cut_mh and scheme.mh_plan.engine == want,
          f"the ASIS scheme is off the {want} engine")
    torch.cuda.synchronize()
    print(f"ASIS {grid} {mask} {cr} scheme set-up, {want} engine "
          f"({len(scheme.mh_plan.chunks)} singles chunks of <= "
          f"{max(len(c.j_idx) for c in scheme.mh_plan.chunks)} ells, tables "
          f"on the card; the tuned record of ({grid}, {mask}, {cr})): "
          f"{time.time() - t0:.1f} s", flush=True)
    return scheme, dl0


def mh_acceptances(out):
    """(EE block, BB big block, mean of the BB singles) MH acceptances of a
    run."""
    mh = [out["mh_accept"][f].cpu().numpy() for f in range(2)]
    return (float(mh[0].mean()), float(mh[1][..., 0].mean()),
            float(mh[1][..., 1:].mean()))


def run_timed_mh_slice(torch, lk, scheme, dl0, dev, label, per_iter,
                       n_timed=N_TIMED, n_warm=N_WARM):
    """``run_slice`` with CUDA events around every ``scheme.mh_step``;
    checks ``per_iter`` (synthesis, adjoint) launches per timed iteration.
    Returns run_slice's results and the MH step's mean ms over the timed
    iterations."""
    mh_events = []
    mh_step = scheme.mh_step

    def timed_mh_step(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = mh_step(*args, **kwargs)
        ev[1].record()
        mh_events.append(ev)
        return res

    scheme.mh_step = timed_mh_step
    warm, out, wall, launches, timed = run_slice(torch, lk, scheme, dl0, dev,
                                                 n_timed, n_warm)
    del scheme.mh_step
    for name, n, per in zip(("synth", "adj"), timed, per_iter):
        check(n == per * n_timed, f"{label} {name} launches in the timed "
              f"run {n}, expected {per} x {n_timed}")
    mh_ms = float(np.mean([a.elapsed_time(b)
                           for a, b in mh_events[-n_timed:]]))
    return warm, out, wall, launches, timed, mh_ms


def phase_asis_slice(torch, lk, model, dls, dev, card, profile, grid,
                     mask, cr="aux_mala", per_iter=ASIS_PER_ITER,
                     mh_fast="auto", n_timed=N_TIMED):
    """The flagship ASIS slice at full width with the tuned record of
    (grid, mask, cr), ``per_iter`` (synthesis, adjoint) launches per
    iteration, ``n_timed`` timed iterations, on the table engine or (with
    ``mh_fast="phi"``) the phi-domain engine; the MH acceptances of the EE
    block, the BB big block and the BB singles held to ACCEPT_WINDOW.  The
    MH step's ms/iter goes to MH_MS under the slice's label.  Returns
    (launches, scheme, D_ell start, final state)."""
    label = f"ASIS {grid} {mask} {cr}" + (" phi" if mh_fast == "phi" else "")
    scheme, dl0 = asis_setup(torch, model, dls, grid, mask, cr, mh_fast)
    warm, out, wall, launches, timed, mh_ms = run_timed_mh_slice(
        torch, lk, scheme, dl0, dev, label, per_iter, n_timed)
    MH_MS[label] = mh_ms
    SLICE_MS[label] = wall / n_timed * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    held = SLICE_HELD["last"] / 2 ** 30
    bins_list = scheme.bins_list
    acc = check_chains(torch, warm, out, bins_list, n_timed)
    for f in range(2):
        shape = tuple(out["mh_accept"][f].shape)
        check(shape == (NCHAINS, n_timed, len(scheme.blocks_list[f])),
              f"mh_accept[{f}] shape {shape}")
    ee, bb_big, singles = mh_acceptances(out)
    lo, hi = ACCEPT_WINDOW
    for what, a in (("EE block", ee), ("BB big block", bb_big),
                    ("BB singles", singles)):
        check(lo <= a <= hi, f"{label} MH acceptance of the {what} {a:.4f} "
              f"outside [{lo}, {hi}]")
    ess_s, bb_tail, per_chain = ess_metrics(out, bins_list, wall, n_timed)
    print(f"slice lmax={LMAX} {NCHAINS} chains {label} ({cr} CR + "
          f"{scheme.mh_plan.engine}-engine blocked MH): "
          f"{wall / n_timed * 1e3:.2f} ms/iter over {n_timed} iterations; "
          f"MH step {mh_ms:.2f} ms/iter (CUDA events) [{card}]", flush=True)
    print(f"{label} acceptance: CR {acc:.4f}; MH EE block {ee:.4f}, BB big "
          f"block {bb_big:.4f}, BB singles {singles:.4f} (each in "
          f"[{lo}, {hi}]) [{card}]", flush=True)
    print(f"{label} ESS ({n_timed} iterations, burn 20%): median pooled "
          f"ESS/s {ess_s:.3f}; bb_tail_ess_per_s {bb_tail:.3f}; "
          f"per_chain_ess_per_iter {per_chain:.5f}; peak device memory "
          f"{peak:.2f} GiB ({held:.2f} GiB allocated when the timed run "
          f"started) [{card}]", flush=True)
    print(f"launches in the {label} path: legendre_synth_tri {launches[0]}, "
          f"legendre_adj_tri {launches[1]} ({per_iter[0]} and "
          f"{per_iter[1]} per iteration)", flush=True)
    if profile:
        profile_asis(torch, scheme, out["final_state"], dl0, dev, card, label)
    return launches, scheme, dl0, out["final_state"]


def plan_pointers(plan):
    """data_ptr() of the plan's sigma and of every table it holds."""
    ptrs = [plan.sigma.data_ptr(), plan.bmask.data_ptr()]
    for c in plan.chunks:
        ptrs += [x.data_ptr() for x in (c.j_idx, c.segj, c.gbins, c.rows,
                                        c.lamA, c.lamB, c.W, c.omega,
                                        c.sp_tab) if x is not None]
    return ptrs


def phase_adapt(torch, lk, scheme, dl0, dev, card):
    """adapt_segments on the band's ASIS scheme from the analytic seeds
    (ADAPT segments x iterations x chains): each block's scale moves the
    way its segment's acceptance asks, the scales are swapped in place
    (the same plan, the same table pointers, the plan's sigma equal to the
    scales); returns the launches."""
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.parallel import adapt_segments
    n_seg, seg_iters, nch = ADAPT
    plan = scheme.mh_plan
    ptrs = plan_pointers(plan)
    seeds = flagship.analytic_sigmas(scheme.model, scheme.bins_list)
    used, outs, made = [], [], []
    run = scheme.run

    def recording_run(*args, **kwargs):
        used.append([s.copy() for s in scheme.prop_sigma_list])
        outs.append(run(*args, **kwargs))
        return outs[-1]

    def make_scheme(sig):
        made.append(1)
        scheme.set_proposal_sigmas(sig)
        return scheme

    scheme.run = recording_run
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    lk.reset_launch_counts()
    t0 = time.time()
    sig, _, _ = adapt_segments(make_scheme, gen, dl0, seeds,
                               n_segments=n_seg, seg_iters=seg_iters,
                               nchains=nch)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches)
    del scheme.run
    check(len(made) == 1 and len(outs) == n_seg,
          f"adapt_segments built the scheme {len(made)} times and ran "
          f"{len(outs)} segments")
    check(all(np.array_equal(a, b) for a, b in zip(used[0], seeds)),
          "adaptation did not start from the analytic seeds")
    lo, hi = 0.2, 0.5
    for k, out in enumerate(outs):
        after = used[k + 1] if k + 1 < n_seg else sig
        for f, blocks in enumerate(scheme.blocks_list):
            acc = out["mh_accept"][f].cpu().numpy().reshape(
                -1, len(blocks)).mean(axis=0)
            for (b0, _), a in zip(blocks, acc):
                r = after[f][b0] / used[k][f][b0]
                want = r < 1.0 if a < lo else r > 1.0 if a > hi else r == 1.0
                check(want, f"adaptation segment {k}, field {f}, block "
                      f"at bin {b0}: acceptance {a:.3f} but scale x{r:.3f}")
        ee, bb_big, singles = mh_acceptances(out)
        print(f"adaptation segment {k} ({seg_iters} iterations x {nch} "
              f"chains): MH EE block {ee:.4f}, BB big block {bb_big:.4f}, "
              f"BB singles {singles:.4f}; scales "
              f"x{after[0][0] / used[k][0][0]:.3f} (EE), "
              f"x{after[1][0] / used[k][1][0]:.3f} (BB big)", flush=True)
    # the last segment's scales were swapped in by adapt_segments, the
    # adapted ones are swapped in here
    for want in (used[-1], sig):
        check(np.array_equal(plan.sigma.cpu().numpy(),
                             np.concatenate(want).astype(np.float32)),
              "the plan's sigma is not the scales swapped in")
        scheme.set_proposal_sigmas(sig)
    check(scheme.mh_plan is plan and plan_pointers(plan) == ptrs,
          "adaptation rebuilt the MH plan or moved its tables")
    print(f"adaptation: {n_seg} segments in {wall:.1f} s; plan and "
          f"{len(ptrs)} table pointers unchanged, plan sigma = the scales "
          f"swapped in; launches legendre_synth_tri {launches[0]}, "
          f"legendre_adj_tri {launches[1]} [{card}]", flush=True)
    return launches


def profile_asis(torch, scheme, state, dl0, dev, card, label, n_iter=5):
    """torch.profiler over n_iter iterations of a blocked-MH scheme."""
    gen = torch.Generator(device=dev).manual_seed(5)
    scheme.run(dl0, n_iter=2, gen=gen, state=state)
    profile_rows(torch, lambda: scheme.run(dl0, n_iter=n_iter, gen=gen,
                                           state=state), n_iter, card, label)


def profile_rows(torch, fn, n_iter, card, label):
    """torch.profiler over ``fn`` (``n_iter`` iterations of something): the
    top kernels by device time per iteration and the device's busy share
    of the wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_time = lambda e: (getattr(e, "self_device_time_total", 0)
                          or getattr(e, "self_cuda_time_total", 0))
    # device-side rows only (kernels and copies; the aten:: rows repeat
    # their kernels' time)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_time(e) > 0]
    rows.sort(key=lambda e: -dev_time(e))
    dev_us = sum(dev_time(e) for e in rows)
    print(f"profile {label} {n_iter} iterations: {wall / n_iter * 1e3:.2f} "
          f"ms/iter under the profiler; device self time "
          f"{dev_us / n_iter / 1e3:.2f} ms/iter = "
          f"{dev_us * 1e-6 / wall:.1%} of the wall clock [{card}]",
          flush=True)
    for e in rows[:30]:
        print(f"  {dev_time(e) / n_iter / 1e3:8.3f} ms/iter "
              f"{dev_time(e) / dev_us:6.1%} "
              f"{e.count // n_iter:6d} calls/iter  {e.key[:90]}", flush=True)


def cast_cut_model(torch, model, dtype):
    """The cut operators and data terms of ``model`` in ``dtype`` (the cut
    rings' and the point set's transforms rebuilt in that precision; the
    full grid's transform, which the MH step does not use, is kept)."""
    import dataclasses
    from gibbssampler_tpu_torch.sht import SHT, PointSHT
    c = lambda x: None if x is None else x.to(dtype)
    dev = model.cut_sht.device
    cut = SHT(model.cut_sht.grid, LMAX, dtype=dtype, spin2=True, device=dev,
              allow_aliasing=model.cut_sht.allow_aliasing)
    sp = model.sp_sht
    if sp is not None:
        sp = PointSHT(sp.theta, sp.phi, sp.valid.cpu().numpy(), LMAX,
                      dtype=dtype, spin0=False, spin2=True, device=dev)
    noise = dataclasses.replace(model.noise, tau=c(model.noise.tau),
                                q_map=c(model.noise.q_map))
    return dataclasses.replace(
        model, noise=noise, bl=c(model.bl), d=c(model.d), cut_sht=cut,
        d_cut=c(model.d_cut), w_cut=c(model.w_cut), cut_c0=c(model.cut_c0),
        cut_c1=c(model.cut_c1), sp_sht=sp, d_sp=c(model.d_sp),
        w_sp=c(model.w_sp))


def log_ratio_errors(torch, scheme, state, m64, plan64, gen):
    """|D32 - D64| over all chains, in nats, of the log-ratios the accept
    tests compare with a uniform, at the slice's final state: the first big
    block's candidate (the EE block; D = log L(candidate) - log L(current)
    of the whitened map), one MALA move and one pCN move (beta PCN_BETA;
    their MH log-ratios), each in float32 in the form the sampler uses
    (``CutMHPlan.big_dll``, ``mala_log_ratio``, ``pcn_log_ratio``) and in
    the old form (differences of the two states' totals), against float64 (``m64`` and ``plan64``: the same
    model and MH plan in float64) on the same candidate.  Returns {name:
    (new errors, old errors)}."""
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    from gibbssampler_tpu_torch.samplers import cr as cr_mod
    f64 = torch.float64
    model, plan = scheme.model, scheme.mh_plan
    bins = scheme.bins_list
    s_nc = cs.whiten(state.s, state.dl, bins, LMAX)
    dl = torch.cat(state.dl, dim=-1)
    up = torch.rand(dl.shape, generator=gen, dtype=dl.dtype, device=dl.device)
    cand = torch.where(plan.bmask[plan.big_rows[0]] > 0,
                       cs.propose_truncnorm(dl, plan.sigma, up), dl)

    def big(p, mdl, s, d, c):
        _, tv = p.components(s)
        u = p.u_of(d, tv)
        au, au_sp = mdl.synthesis_cut_sp(u)
        new = p.big_dll(tv, d, c, u, au, au_sp, p.big_fields[0])[0]
        old = mdl.data_loglike_cut(p.u_of(c, tv)) - mdl.data_loglike_cut(
            u, au, au_sp)
        return new, old

    new32, old32 = big(plan, model, s_nc, dl, cand)
    ref = big(plan64, m64, s_nc.to(f64), dl.to(f64), cand.to(f64))[0]
    out = {"big block": ((new32.to(f64) - ref).abs(),
                         (old32.to(f64) - ref).abs())}
    del s_nc
    var = scheme.var_cls(state.dl)
    s = state.s * (var > 0)
    xi = torch.randn(s.shape, generator=gen, dtype=s.dtype, device=s.device)
    tau = scheme.cr_options["tau"]
    bt = scheme.bt_ninv_d
    s_prop = cr_mod.mala_cr(model, var, bt, s, tau=tau, accept=False,
                            noise={"state": xi[:, None]})[0]
    new32, old32 = (cr_mod.mala_log_ratio(model, var, bt, s, s_prop, tau,
                                          exact=e) for e in (True, False))
    ref = cr_mod.mala_log_ratio(m64, var.to(f64), bt.to(f64), s.to(f64),
                                s_prop.to(f64), tau)
    out["MALA"] = ((new32.to(f64) - ref).abs(), (old32.to(f64) - ref).abs())
    # one pCN move: the exact form and the JAX package's difference of the
    # two states' totals
    xi = torch.randn(s.shape, generator=gen, dtype=s.dtype, device=s.device)
    s_prop = cr_mod.pcn_cr(model, var, bt, s, beta=PCN_BETA, noise={
        "state": xi[:, None]}, u=torch.zeros(s.shape[0], device=s.device))[0]
    new32, old32 = (cr_mod.pcn_log_ratio(model, s, s_prop, exact=e)
                    for e in (True, False))
    ref = cr_mod.pcn_log_ratio(m64, s.to(f64), s_prop.to(f64))
    out["pCN"] = ((new32.to(f64) - ref).abs(), (old32.to(f64) - ref).abs(),
                  ref.abs())
    return {k: tuple(e.cpu().numpy() for e in v) for k, v in out.items()}


def phase_mh_sweep(torch, scheme, state, dev, card, label="", nch=4,
                   engines=(), no_singles=False, tally=None, lk=None):
    """One MH sweep at full width in float64 (the main path's bins, blocks
    and sigmas; the slice's final whitened maps of ``nch`` chains): the
    table engine against the direct nc_cls_sample on the same injected
    uniforms, then each of ``engines`` ((mdomain, the engine it must take)
    pairs; ``engine_sweeps``) against the same direct sweep and, with
    ``no_singles``, the blocking with EE and BB one block each (the phi
    engine) against its own direct sweep; their launches go to ``tally``.
    Also the float32 rounding of the log-likelihood, and of the two accept
    tests' log-ratios (``log_ratio_errors``), over all chains of the
    slice's final state; returns the latter."""
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    f64 = torch.float64
    t0 = time.time()
    m64 = cast_cut_model(torch, scheme.model, f64)
    bins, blocks, sig = (scheme.bins_list, scheme.blocks_list,
                         scheme.prop_sigma_list)
    s_nc32 = cs.whiten(state.s, state.dl, bins, LMAX)
    ll32 = cs.make_nc_log_likelihood(scheme.model, bins)(state.dl, s_nc32)
    ll64 = cs.make_nc_log_likelihood(m64, bins)(
        tuple(d.to(f64) for d in state.dl), s_nc32.to(f64))
    dll = (ll32.to(f64) - ll64).abs().cpu().numpy()
    plan = cs.CutMHPlan(m64, bins, blocks, sig, dtype=f64)
    gen = torch.Generator(device=dev).manual_seed(9)
    lr_err = log_ratio_errors(torch, scheme, state, m64, plan, gen)
    dl = tuple(d[:nch].to(f64) for d in state.dl)
    s_nc = s_nc32[:nch].to(f64)
    del s_nc32
    ntot, nblocks = sum(len(b) - 1 for b in bins), sum(map(len, blocks))
    up = torch.rand((nch, 1, ntot), generator=gen, dtype=f64, device=dev)
    ua = torch.rand((nch, 1, nblocks), generator=gen, dtype=f64, device=dev)
    check(len(plan.chunks) == ASIS_CHUNKS
          and any(c.segj is not None for c in plan.chunks),
          f"full-width chunking: expected {ASIS_CHUNKS} chunks with wide "
          "bins")
    # on HEALPix the floor rows sit at nphi 2 lmax, some of them phased:
    # the sweep takes the ring-phase and Nyquist-column paths
    nyq = m64.cut_sht.nphi == 2 * LMAX
    check((plan.ph_c is not None) == m64.cut_sht.has_phase
          and all((c.lnyq is not None) == nyq for c in plan.chunks),
          "full-width MH plan: ring-phase / Nyquist paths not as the cut "
          "rows need")
    torch.cuda.synchronize()
    t1 = time.time()
    fast = cs.nc_cls_sample_cut(dl, s_nc, m64, bins, blocks, sig, u_prop=up,
                                u_acc=ua, plan=plan)
    torch.cuda.synchronize()
    t2 = time.time()
    direct = cs.nc_cls_sample(dl, s_nc, cs.make_nc_log_likelihood(m64, bins),
                              bins, blocks, sig, u_prop=up, u_acc=ua)
    torch.cuda.synchronize()
    t3 = time.time()
    err = max(float(((a - b).abs() / b.abs()).max())
              for a, b in zip(fast[0], direct[0]))
    check(err <= 1e-9, f"full-width MH sweep: table engine vs direct D_ell "
          f"rel err {err} > 1e-9")
    for f in range(2):
        check(torch.equal(fast[1].accept[f], direct[1].accept[f]),
              f"full-width MH sweep: accepts of field {f} differ")
    dll_end = float((fast[1].log_like - direct[1].log_like).abs().max())
    acc = np.concatenate([a.cpu().numpy().ravel() for a in fast[1].accept])
    print(f"MH sweep{label} lmax={LMAX} {nch} chains float64 "
          f"({len(plan.chunks)} chunks, {nblocks} blocks): table engine vs "
          f"direct D_ell max rel err {err:.2e}, accepts equal (mean "
          f"{acc.mean():.4f}), final "
          f"log-likelihood |diff| {dll_end:.2e}; table engine "
          f"{(t2 - t1) * 1e3:.1f} ms, direct {(t3 - t2) * 1e3:.1f} ms "
          f"(set-up {t1 - t0:.1f} s) [{card}]", flush=True)
    engine_sweeps(torch, lk, tally, m64, bins, blocks, sig, dl, s_nc, up, ua,
                  direct, engines, f"MH sweep{label}", card)
    if no_singles:
        # one block per field, its scales those of the singles over the
        # square root of the block's width
        blocks1 = [[(0, len(b) - 1)] for b in bins]
        sig1 = [np.asarray(s) / np.sqrt(len(b) - 1) for s, b in zip(sig, bins)]
        ua1 = torch.rand((nch, 1, 2), generator=gen, dtype=f64, device=dev)
        direct1 = cs.nc_cls_sample(dl, s_nc, cs.make_nc_log_likelihood(
            m64, bins), bins, blocks1, sig1, u_prop=up, u_acc=ua1)
        engine_sweeps(torch, lk, tally, m64, bins, blocks1, sig1, dl, s_nc,
                      up, ua1, direct1, [("auto", "phi")],
                      f"MH sweep{label}, EE and BB one block each", card)
    print(f"float32 log-likelihood rounding{label} at the slice's final "
          f"state ({len(dll)} chains): |ll32 - ll64| median "
          f"{np.median(dll):.3f}, "
          f"max {dll.max():.3f} nats (|ll| ~ {float(ll64.abs().mean()):.4g}) "
          f"[{card}]", flush=True)
    for what, (new, old, *size) in lr_err.items():
        scale = (f"; |D64| median {np.median(size[0]):.4g} nats" if size
                 else "")
        print(f"float32 log-ratio rounding{label}, {what} ({len(new)} "
              f"chains): |D32 - D64| median {np.median(new):.3g}, max "
              f"{new.max():.3g} nats (exact form); median {np.median(old):.3g}"
              f", max {old.max():.3g} nats (old form: differences of totals)"
              f"; median ratio {np.median(new) / np.median(old):.3g}{scale} "
              f"[{card}]", flush=True)
    return lr_err


def counted(torch, lk, tally, fn):
    """fn() with the launch counts set to 0 just before it and read just
    after, its launches and shape counts added to ``tally`` ({"launches":
    4 counts, "shapes": {...}}).  Returns (fn(), wall seconds)."""
    out, n, sh, wall = run_counted(torch, lk, fn)
    tally["launches"] = [a + b for a, b in zip(tally["launches"], n)]
    for k, v in sh.items():
        tally["shapes"][k] = tally["shapes"].get(k, 0) + v
    return out, wall


def engine_sweeps(torch, lk, tally, m64, bins, blocks, sig, dl, s_nc, up, ua,
                  direct, engines, label, card):
    """nc_cls_sample_cut on each (mdomain, engine) of ``engines`` (the
    engine ``CutMHPlan`` must take for that mdomain) against the direct
    sweep ``direct`` on the same uniforms: D_ell <= 1e-9 relative,
    accepts equal, the final log-likelihood beside it; each run counted
    into ``tally`` and timed with CUDA events."""
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    for mdomain, want in engines:
        plan = cs.CutMHPlan(m64, bins, blocks, sig, mdomain=mdomain,
                            dtype=torch.float64)
        check(plan.engine == want, f"{label}: mdomain={mdomain!r} took the "
              f"{plan.engine} engine, the JAX package takes {want}")
        (res, ms), _ = counted(torch, lk, tally, lambda: cuda_ms(
            torch, lambda: cs.nc_cls_sample_cut(
                dl, s_nc, m64, bins, blocks, sig, u_prop=up, u_acc=ua,
                plan=plan)))
        err = max(float(((a - b).abs() / b.abs()).max())
                  for a, b in zip(res[0], direct[0]))
        check(err <= 1e-9, f"{label}: {want} engine vs direct D_ell rel "
              f"err {err} > 1e-9")
        for f in range(len(bins)):
            check(torch.equal(res[1].accept[f], direct[1].accept[f]),
                  f"{label}: {want} engine accepts of field {f} differ from "
                  "the direct path's")
        a = np.concatenate([x.cpu().numpy().ravel() for x in res[1].accept])
        dll = float((res[1].log_like - direct[1].log_like).abs().max())
        print(f"{label}: {want} engine (mdomain={mdomain!r}, "
              f"{len(plan.chunks)} chunks) vs direct: D_ell max rel err "
              f"{err:.2e}, accepts equal (mean {a.mean():.4f}), final "
              f"log-likelihood |diff| {dll:.2e}; {ms:.1f} ms [{card}]",
              flush=True)


def sweep_inputs(torch, scheme, state, nch, gen):
    """The float64 sweep inputs at a slice's final state: the D_ell and
    whitened maps of ``nch`` chains and one sweep's uniforms."""
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    f64 = torch.float64
    bins, blocks = scheme.bins_list, scheme.blocks_list
    s_nc = cs.whiten(state.s[:nch], tuple(d[:nch] for d in state.dl), bins,
                     LMAX).to(f64)
    dl = tuple(d[:nch].to(f64) for d in state.dl)
    ntot, nblocks = sum(len(b) - 1 for b in bins), sum(map(len, blocks))
    dev = s_nc.device
    up = torch.rand((nch, 1, ntot), generator=gen, dtype=f64, device=dev)
    ua = torch.rand((nch, 1, nblocks), generator=gen, dtype=f64, device=dev)
    return dl, s_nc, up, ua


def phase_nosplit_sweep(torch, lk, tally, scheme, state, dev, card, nch=4):
    """bench.py's planckish mask cut without the floor + sparse-hole split:
    every ring a hole touches joins the cut, w_cut is not azimuthally
    uniform, and "auto" takes the phi engine; one float64 sweep at full
    width against the direct path (the slice's final state)."""
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    t0 = time.time()
    model = scheme.model
    base = dataclasses.replace(model, cut_sht=None, d_cut=None, w_cut=None,
                               cut_c0=None, cut_c1=None, sp_sht=None,
                               d_sp=None, w_sp=None)
    m32 = with_cut_decomposition(base, sparse_split=False)
    check(not m32.has_sparse and not m32.cut_w_uniform,
          "planckish without the split: w_cut azimuthally uniform")
    m64 = cast_cut_model(torch, m32, torch.float64)
    del m32, base
    gen = torch.Generator(device=dev).manual_seed(10)
    dl, s_nc, up, ua = sweep_inputs(torch, scheme, state, nch, gen)
    bins, blocks = scheme.bins_list, scheme.blocks_list
    sig = scheme.prop_sigma_list
    torch.cuda.synchronize()
    print(f"planckish without the split: cut over {m64.cut_sht.nrings} "
          f"rings (w_cut not azimuthally uniform; the split's floor: "
          f"{PLANCKISH_FLOOR_RINGS}), float64 set-up {time.time() - t0:.1f} s",
          flush=True)
    direct, ms = cuda_ms(torch, lambda: cs.nc_cls_sample(
        dl, s_nc, cs.make_nc_log_likelihood(m64, bins), bins, blocks, sig,
        u_prop=up, u_acc=ua))
    print(f"planckish without the split: direct sweep {ms:.1f} ms", flush=True)
    engine_sweeps(torch, lk, tally, m64, bins, blocks, sig, dl, s_nc, up, ua,
                  direct, [("auto", "phi")], "MH sweep planckish without the "
                  "split", card)
    del m64
    torch.cuda.empty_cache()


def phase_coef_sweep(torch, lk, tally, scheme, state, dev, card):
    """One float32 sweep of the coefficient m-domain engine (mdomain "m")
    at 128 chains on the band slice's final state, beside the table
    engine's on the same inputs, each timed with CUDA events; finite D_ell
    and accepts in [0, 1]."""
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    model, bins, blocks = scheme.model, scheme.bins_list, scheme.blocks_list
    sig = scheme.prop_sigma_list
    s_nc = cs.whiten(state.s, state.dl, bins, LMAX)
    gen = torch.Generator(device=dev).manual_seed(12)
    ntot, nblocks = sum(len(b) - 1 for b in bins), sum(map(len, blocks))
    up = torch.rand((NCHAINS, 1, ntot), generator=gen, device=dev)
    ua = torch.rand((NCHAINS, 1, nblocks), generator=gen, device=dev)
    out = {}
    for mdomain, want in (("m", "coef"), ("auto", "table")):
        plan = cs.CutMHPlan(model, bins, blocks, sig, mdomain=mdomain)
        check(plan.engine == want, f"float32 sweep: {plan.engine} engine, "
              f"expected {want}")
        torch.cuda.reset_peak_memory_stats(dev)
        (res, ms), _ = counted(torch, lk, tally, lambda: cuda_ms(
            torch, lambda: cs.nc_cls_sample_cut(
                state.dl, s_nc, model, bins, blocks, sig, u_prop=up,
                u_acc=ua, plan=plan)))
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        dl = torch.cat(res[0], dim=-1)
        check(bool(torch.isfinite(dl).all() and (dl > 0).all()),
              f"float32 {want} sweep: non-finite or non-positive D_ell")
        a = np.concatenate([x.cpu().numpy().ravel() for x in res[1].accept])
        out[want] = (ms, a.mean(), peak)
        del plan, res
    print(f"MH sweep float32 lmax={LMAX} {NCHAINS} chains (the band slice's "
          f"final state): coefficient engine {out['coef'][0]:.2f} ms (mean "
          f"accept {out['coef'][1]:.4f}, peak {out['coef'][2]:.2f} GiB), "
          f"table engine {out['table'][0]:.2f} ms (mean accept "
          f"{out['table'][1]:.4f}, peak {out['table'][2]:.2f} GiB) [{card}]",
          flush=True)


def phase_pncp_slice(torch, lk, model, dls, dev, card, profile):
    """bench.py's PNCP configuration (``flagship.pncp_setup``, the port's
    tuned record of (pncp, gl, band, aux_mala, l_cut)) at full width: the
    initial draw, N_WARM warm-up and N_TIMED timed iterations of NCHAINS
    chains; exact launch counts per iteration, the BB singles' MH
    acceptance held to ACCEPT_WINDOW.  Returns (launches, scheme, final
    state)."""
    from gibbssampler_tpu_torch import flagship
    label = "PNCP GL band aux_mala"
    t0 = time.time()
    scheme, dl0 = flagship.pncp_setup(model, dls, "gl", "band", "aux_mala")
    check(tuple(len(b) - 1 for b in scheme.bins_list) == ASIS_NBINS
          and scheme.l_cut == PNCP_LCUT and scheme.blocks_list[0] == ()
          and len(scheme.blocks_list[1]) == PNCP_SINGLES
          and all(hi - lo == 1 for lo, hi in scheme.blocks_list[1]),
          f"PNCP bins, l_cut and blocks: l_cut {scheme.l_cut}, "
          f"{len(scheme.blocks_list[1])} BB blocks")
    plan = scheme.mh_plan
    check(scheme._use_cut_mh and plan.lowm is not None
          and plan.big_rows == [], "PNCP off the table engine's identity "
          "re-centering, or with a big block")
    torch.cuda.synchronize()
    print(f"{label} scheme set-up (l_cut {scheme.l_cut}, "
          f"{len(plan.chunks)} singles chunks, the tuned record): "
          f"{time.time() - t0:.1f} s", flush=True)
    warm, out, wall, launches, _, mh_ms = run_timed_mh_slice(
        torch, lk, scheme, dl0, dev, label, PNCP_PER_ITER)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    held = SLICE_HELD["last"] / 2 ** 30
    acc = check_chains(torch, warm, out, scheme.bins_list)
    mh = [out["mh_accept"][f].cpu().numpy() for f in range(2)]
    check(mh[0].shape == (NCHAINS, N_TIMED, 0)
          and mh[1].shape == (NCHAINS, N_TIMED, PNCP_SINGLES),
          f"PNCP mh_accept shapes {mh[0].shape}, {mh[1].shape}")
    singles = float(mh[1].mean())
    lo, hi = ACCEPT_WINDOW
    check(lo <= singles <= hi, f"{label} MH acceptance of the BB singles "
          f"{singles:.4f} outside [{lo}, {hi}]")
    ess_s, bb_tail, per_chain = ess_metrics(out, scheme.bins_list, wall)
    print(f"slice lmax={LMAX} {NCHAINS} chains {label} (EE centered, BB "
          f"non-centered from l = {scheme.l_cut[1]}): "
          f"{wall / N_TIMED * 1e3:.2f} ms/iter over {N_TIMED} iterations; "
          f"MH step {mh_ms:.2f} ms/iter (CUDA events) [{card}]", flush=True)
    print(f"{label} acceptance: CR {acc:.4f}; MH BB singles {singles:.4f} "
          f"(in [{lo}, {hi}]) [{card}]", flush=True)
    print(f"{label} ESS ({N_TIMED} iterations, burn 20%): median pooled "
          f"ESS/s {ess_s:.3f}; bb_tail_ess_per_s {bb_tail:.3f}; "
          f"per_chain_ess_per_iter {per_chain:.5f}; peak device memory "
          f"{peak:.2f} GiB ({held:.2f} GiB allocated when the timed run "
          f"started) [{card}]", flush=True)
    print(f"launches in the {label} path: legendre_synth_tri {launches[0]}, "
          f"legendre_adj_tri {launches[1]} ({PNCP_PER_ITER[0]} and "
          f"{PNCP_PER_ITER[1]} per iteration)", flush=True)
    if profile:
        profile_asis(torch, scheme, out["final_state"], dl0, dev, card, label)
    return launches, scheme, out["final_state"]


def phase_pncp_sweep(torch, scheme, state, dev, card, nch=4):
    """One PNCP MH sweep at full width in float64 (the slice's bins, blocks
    and sigmas; its final state's high-l whitened maps of ``nch`` chains):
    the table engine with the identity re-centering below l_cut against
    the direct nc_cls_sample on the PNCP likelihood (prior variance 1
    below l_cut), on the same injected uniforms."""
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    f64 = torch.float64
    t0 = time.time()
    m64 = cast_cut_model(torch, scheme.model, f64)
    bins, blocks, sig = (scheme.bins_list, scheme.blocks_list,
                         scheme.prop_sigma_list)
    dl = tuple(d[:nch].to(f64) for d in state.dl)
    var_h = scheme._var_high(dl, f64)
    s_pnc = state.s[:nch].to(f64) * torch.where(
        var_h > 0, 1.0 / torch.sqrt(torch.where(var_h > 0, var_h, 1.0)), 0.0)
    plan = cs.CutMHPlan(m64, bins, blocks, sig, l_cut_identity=scheme.l_cut,
                        dtype=f64)
    like = cs.NCLogLike(m64, bins, "cut", var_fn=scheme._var_high)
    gen = torch.Generator(device=dev).manual_seed(11)
    ntot, nblocks = sum(len(b) - 1 for b in bins), sum(map(len, blocks))
    up = torch.rand((nch, 1, ntot), generator=gen, dtype=f64, device=dev)
    ua = torch.rand((nch, 1, nblocks), generator=gen, dtype=f64, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    fast = cs.nc_cls_sample_cut(dl, s_pnc, m64, bins, blocks, sig, u_prop=up,
                                u_acc=ua, plan=plan)
    torch.cuda.synchronize()
    t2 = time.time()
    direct = cs.nc_cls_sample(dl, s_pnc, like, bins, blocks, sig, u_prop=up,
                              u_acc=ua)
    torch.cuda.synchronize()
    t3 = time.time()
    err = max(float(((a - b).abs() / b.abs()).max())
              for a, b in zip(fast[0], direct[0]))
    check(err <= 1e-9, f"full-width PNCP MH sweep: table engine vs direct "
          f"D_ell rel err {err} > 1e-9")
    for f in range(2):
        check(torch.equal(fast[1].accept[f], direct[1].accept[f]),
              f"full-width PNCP MH sweep: accepts of field {f} differ")
    dll_end = float((fast[1].log_like - direct[1].log_like).abs().max())
    acc = fast[1].accept[1].cpu().numpy()
    print(f"PNCP MH sweep lmax={LMAX} {nch} chains float64 "
          f"({len(plan.chunks)} chunks, {nblocks} blocks, l_cut_identity "
          f"{scheme.l_cut}): table engine vs direct D_ell max rel err "
          f"{err:.2e}, accepts equal (mean {acc.mean():.4f}), final "
          f"log-likelihood |diff| {dll_end:.2e}; table engine "
          f"{(t2 - t1) * 1e3:.1f} ms, direct {(t3 - t2) * 1e3:.1f} ms "
          f"(set-up {t1 - t0:.1f} s) [{card}]", flush=True)


def counts(lk):
    """(float32 synthesis, float32 adjoint, float64 synthesis, float64
    adjoint) launches since the counts were last set to 0."""
    s, a = lk.legendre_synth_tri, lk.legendre_adj_tri
    return (s.launches - s.launches_f64 - s.launches_bf16
            - s.launches_narrow - s.launches_f16 - s.launches_wide,
            a.launches - a.launches_f64 - a.launches_bf16
            - a.launches_narrow - a.launches_f16 - a.launches_wide,
            s.launches_f64, a.launches_f64)


def cuda_ms(torch, fn):
    """(fn(), its ms between two CUDA events)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1])


def phase_cg(torch, lk, dev, card, profile):
    """The CG family at full width: the band dataset in float64 (GL 513 x
    1026, cut over 65 rings), CG_CHAINS chains, the prior of the true
    spectrum in unit bins (tools/cg_scale.py's set-up).  cg_cr at each of
    CG_TOLS (per-chain iterations, all converged, ms per solve and per
    iteration, launches = 2 + 2 per iteration, the true residual
    recomputed); rjpo_cr at 1e-5 from the 1e-6 draw (its acceptance); the
    mixed ladder (cg_solve with a float32 apply on the 3xTF32 kernels,
    float64 vectors, the float64 apply for the true residuals, replacement
    every CG_REPLACE_EVERY) at each tolerance; and a CenteredGibbs slice
    with cr_method "cg": the initial draw and CG_SLICE_ITERS iterations.
    The launch counts are set to 0 before and read after; returns them
    (``counts``)."""
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.ops import cg_solve
    from gibbssampler_tpu_torch.samplers import cr as cr_mod
    from gibbssampler_tpu_torch.schemes import CenteredGibbs
    f64 = torch.float64
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the mixed ladder's float32 apply must run in true float32")
    t0 = time.time()
    m64, dls, _ = flagship.dataset("gl", "band", LMAX, dev, f64)
    check(m64.cut_sht.nrings == CUT_RINGS and m64.cut_sht.dtype == f64,
          "CG phase: the float64 cut decomposition")
    ubins = np.arange(2, LMAX + 2)
    scheme = CenteredGibbs(m64, [ubins, ubins], cr_method="cg",
                           cr_options={"cg_maxiter": CG_MAXITER})
    dl0 = tuple(d[2:] for d in dls)
    var = scheme.var_cls(tuple(torch.as_tensor(d, dtype=f64, device=dev)
                               .expand(CG_CHAINS, -1) for d in dl0))
    bt = scheme.bt_ninv_d
    inv = torch.where(var > 0, 1.0 / torch.where(var > 0, var, 1.0), 0.0)
    pre = cr_mod.cr_precond(m64, var)
    gen = torch.Generator(device=dev).manual_seed(7)
    pool = scheme.draw_noise_pool(CG_CHAINS, gen)
    m32 = cast_cut_model(torch, m64, torch.float32)
    inv32 = inv.float()
    n_hi, hist = [0], []

    def op64(v):
        """The mixed ladder's float64 apply; records ||b - Q v|| / ||b||
        of every chain at each call (the replacements' true residuals)."""
        n_hi[0] += 1
        q = m64.q_apply_cut(v, inv)
        hist.append((b - q).norm(dim=(-2, -1)) / b.norm(dim=(-2, -1)))
        return q

    def op32(v):
        return m32.q_apply_cut(v, inv32)

    def true_resid(b, x):
        r = b - m64.q_apply_cut(x, inv)
        return (r.norm(dim=(-2, -1)) / b.norm(dim=(-2, -1))).cpu().numpy()

    torch.cuda.synchronize()
    print(f"CG phase set-up (float64 band dataset, cut over "
          f"{m64.cut_sht.nrings} rings, {CG_CHAINS} chains; float32 cut "
          f"operator): {time.time() - t0:.1f} s", flush=True)
    lk.reset_launch_counts()
    b = cr_mod.fluctuated_rhs(m64, var, bt, noise=pool)
    draws, n_at = {}, {}
    for tol in CG_TOLS:
        before = counts(lk)
        (x, info), ms = cuda_ms(torch, lambda: cr_mod.cg_cr(
            m64, var, bt, tol=tol, maxiter=CG_MAXITER, noise=pool))
        d = tuple(a - c for a, c in zip(counts(lk), before))
        its = info.extra.cpu().numpy().astype(np.int64)
        n = int(its.max())
        check(d == (0, 0, 2 * n, 2 + 2 * n), f"cg_cr tol {tol}: launches "
              f"{d}, expected (0, 0, 2 x {n}, 2 + 2 x {n})")
        check((its < CG_MAXITER).all(), f"cg_cr tol {tol}: chains at the "
              f"cap of {CG_MAXITER} iterations: {its}")
        res = true_resid(b, x)
        check(res.max() <= 2 * tol, f"cg_cr tol {tol}: true residual "
              f"{res.max():.3g} > 2 x tol")
        draws[tol], n_at[tol] = x, n
        print(f"CG float64 tol {tol:g}: iterations max {n}, median "
              f"{float(np.median(its)):.1f} (the JAX package's record, "
              f"lockstep max over 8 chains: {CG_JAX_ITERS[tol]}), every "
              f"chain converged; {ms:.1f} ms per solve of {CG_CHAINS} chains, "
              f"{ms / n:.3f} ms per iteration; true ||b - Qx||/||b|| max "
              f"{res.max():.3g}; launches synthesis {d[2]}, adjoint {d[3]} "
              f"(float64 kernels) [{card}]", flush=True)
    if profile:
        profile_rows(torch, lambda: cr_mod.cg_cr(
            m64, var, bt, tol=CG_TOLS[0], maxiter=CG_MAXITER, noise=pool),
            n_at[CG_TOLS[0]], card,
            f"cg_cr float64 tol {CG_TOLS[0]:g} (per CG iteration)")
    # the float32 apply against the float64 one, on the right-hand side and
    # on the solution (relative 2-norm of the difference, per chain)
    op_err = [float(((op32(v.float()).double() - m64.q_apply_cut(v, inv))
                     .norm(dim=(-2, -1)) / m64.q_apply_cut(v, inv)
                     .norm(dim=(-2, -1))).max())
              for v in (b, draws[CG_TOLS[-1]])]
    print(f"float32 cut Q apply against float64: relative error max "
          f"{op_err[0]:.3g} on b, {op_err[1]:.3g} on the solution [{card}]",
          flush=True)
    before = counts(lk)
    (_, rinfo), ms = cuda_ms(torch, lambda: cr_mod.rjpo_cr(
        m64, var, bt, draws[CG_TOLS[-1]], tol=1e-5, maxiter=CG_MAXITER,
        noise=scheme.draw_noise_pool(CG_CHAINS, gen), gen=gen))
    d = tuple(a - c for a, c in zip(counts(lk), before))
    # fluctuated_rhs's full-grid adjoint, then the start's residual, the
    # iterations and the final residual: one cut synthesis and adjoint each
    n_rj = d[2] // 2 - 2
    check(d[:2] == (0, 0) and d[2] % 2 == 0 and d[3] == d[2] + 2,
          f"rjpo_cr launches {d}")
    racc = rinfo.accept.cpu().numpy()
    print(f"RJPO float64 tol 1e-5 from the tol-1e-6 CG draw: acceptance "
          f"{racc.mean():.4f} ({int(racc.sum())} of {CG_CHAINS}); "
          f"log-ratio median {float(rinfo.extra.median()):.3g}; {ms:.1f} ms, "
          f"{n_rj} iterations by the launch count [{card}]", flush=True)
    for tol in CG_TOLS:
        before, n_hi[0] = counts(lk), 0
        hist.clear()
        (x, info), ms = cuda_ms(torch, lambda: cg_solve(
            op32, b, precond_diag=pre, tol=tol, maxiter=CG_MIXED_MAXITER,
            ndim_sys=2, apply_dtype=torch.float32, operator_hi=op64,
            replace_every=CG_REPLACE_EVERY))
        d = tuple(a - c for a, c in zip(counts(lk), before))
        its = info.iterations.cpu().numpy()
        n = int(its.max())
        check(d == (2 * n, 2 * n, 2 * n_hi[0], 2 * n_hi[0]),
              f"mixed ladder tol {tol}: launches {d}, expected 2 x {n} "
              f"float32 and 2 x {n_hi[0]} float64")
        res = true_resid(b, x)
        conv = info.converged.cpu().numpy()
        # the replacements' true residuals (the last apply is the final
        # choice's): where each chain's best was first reached, and how
        # many distinct values its last 100 replacements took
        h = torch.stack(hist[:-1]).cpu().numpy()
        worst = int(np.argmax(h.min(axis=0)))
        first = int(np.argmin(h[:, worst]))
        tail = len(np.unique(np.round(h[-100:, worst], 12)))
        print(f"CG mixed ladder (float32 apply, float64 vectors, "
              f"replacement every {CG_REPLACE_EVERY}) tol {tol:g}: "
              f"iterations max {n}, median {float(np.median(its)):.1f}; "
              f"converged {int(conv.sum())} of {CG_CHAINS}; {ms:.1f} ms per "
              f"solve, {ms / n:.3f} ms per iteration; {n_hi[0]} float64 "
              f"applies; true ||b - Qx||/||b|| max {res.max():.3g}; the "
              f"worst chain's best true residual {h[first, worst]:.3g} first "
              f"at apply {first + 1} of {len(h)}, its last "
              f"{min(100, len(h))} replacements at {tail} distinct "
              f"values [{card}]", flush=True)
    before = counts(lk)
    out, ms = cuda_ms(torch, lambda: scheme.run(
        dl0, n_iter=CG_SLICE_ITERS, nchains=CG_CHAINS, gen=gen))
    d = tuple(a - c for a, c in zip(counts(lk), before))
    for f in range(2):
        dl = out["dl_chains"][f].cpu().numpy()
        check(dl.shape == (CG_CHAINS, CG_SLICE_ITERS, len(ubins) - 1)
              and np.isfinite(dl).all() and (dl > 0).all(),
              f"CG slice dl_chains[{f}]: shape {dl.shape} or non-finite")
    launches = counts(lk)
    print(f"CenteredGibbs cg slice float64 ({CG_CHAINS} chains, the initial "
          f"draw and {CG_SLICE_ITERS} iterations, cg_tol 1e-6): {ms:.1f} ms, "
          f"{ms / (CG_SLICE_ITERS + 1):.1f} ms per CG draw; launches "
          f"synthesis {d[2]}, adjoint {d[3]}; the CG path's launches "
          f"float32 {launches[:2]}, float64 {launches[2:]} [{card}]",
          flush=True)
    return launches


class Crash(Exception):
    """The runner phase's deliberate crash."""


def crash_after_first_segment(msg):
    """A ``verbose`` callback that raises at the first segment's line,
    which the runner prints after that segment's checkpoint is written."""
    if str(msg).startswith("segment done"):
        raise Crash(msg)


def shape_counts(lk):
    """{(kernel, L, nr, C, dtype): launches} since the counts were last
    set to 0."""
    out = {}
    for fn in (lk.legendre_synth_tri, lk.legendre_adj_tri):
        for k, v in fn.shapes.items():
            out[(fn.__name__,) + k] = v
    return out


def print_shapes(label, shapes):
    print(f"{label} launches by shape: " + "; ".join(
        f"{k[0][9:]} nr {k[2]} C {k[3]} {str(k[4])[6:]}: {v}"
        for k, v in sorted(shapes.items(), key=lambda kv: str(kv[0]))),
        flush=True)


def run_counted(torch, lk, fn):
    """fn() with the launch counts set to 0 just before it and read just
    after: (result, counts, shape counts, wall seconds)."""
    torch.cuda.synchronize()
    lk.reset_launch_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, counts(lk), shape_counts(lk), time.time() - t0


def phase_runner(torch, lk, dev, card, tmp):
    """The README's polarization run at full width through
    ``run_experiment`` (RUNNER_CFG): once uninterrupted, then crashed by
    its verbose callback after the first segment's checkpoint and
    resumed.  Checks the resumed results against the uninterrupted ones
    bit for bit (every key but the configuration's path and the
    timings), the results' keys, finite positive D_ell and the checkpoint
    gone.  Returns (launches, shape counts) of the three runs."""
    from gibbssampler_tpu_torch.inference import RunConfig, run_experiment
    ref_cfg = RunConfig(**RUNNER_CFG, out=os.path.join(tmp, "ref.npz"))
    logs = []
    torch.cuda.reset_peak_memory_stats(dev)
    ref, n_ref, sh, wall = run_counted(torch, lk, lambda: run_experiment(
        ref_cfg, verbose=logs.append, device=dev))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(sorted(ref) == RUNNER_KEYS, f"runner results keys {sorted(ref)}")
    check(not os.path.exists(ref_cfg.out + ".ckpt.npz"),
          "runner: the checkpoint is left after the run")
    for f in range(2):
        dl = ref[f"dl_chain_{f}"]
        check(dl.shape == (RUNNER_CFG["nchains"], RUNNER_CFG["n_iter"],
                           RUNNER_CFG["lmax"] - 1) and np.isfinite(dl).all()
              and (dl > 0).all(), f"runner dl_chain_{f}: shape {dl.shape} "
              f"or non-finite or non-positive values")
    cfg = RunConfig(**RUNNER_CFG, out=os.path.join(tmp, "crash.npz"))
    logs2 = []

    def crash_then_resume():
        try:
            run_experiment(cfg, verbose=crash_after_first_segment, device=dev)
        except Crash:
            pass
        else:
            raise RuntimeError("check failed: the runner did not crash")
        check(os.path.exists(cfg.out + ".ckpt.npz")
              and not os.path.exists(cfg.out),
              "runner: no checkpoint after the crash")
        return run_experiment(cfg, resume=True, verbose=logs2.append,
                              device=dev)

    res, n_res, sh2, wall2 = run_counted(torch, lk, crash_then_resume)
    seg = RUNNER_CFG["segment"]
    check(logs2[0] == f"resumed at iteration {seg}",
          f"runner resume: {logs2[0]!r}")
    timed = {"config", "durations"}
    check(sorted(res) == sorted(ref), "runner resume: results keys differ")
    for k in sorted(set(ref) - timed):
        if not np.array_equal(res[k], ref[k]):
            diff = np.argwhere(res[k] != ref[k])
            raise RuntimeError(
                f"check failed: the resumed run's {k} differs from the "
                f"uninterrupted run's at {len(diff)} entries, first at "
                f"{diff[0].tolist()}")
    check(not os.path.exists(cfg.out + ".ckpt.npz"),
          "runner: the checkpoint is left after the resumed run")
    ms = ref["durations"] / seg * 1e3
    acc = ", ".join(f"{'EB'[f]} {ref[f'mh_accept_{f}'].mean():.4f}"
                    for f in range(2))
    print(f"runner lmax {LMAX} GL band {RUNNER_CFG['mask_band_deg']} deg, "
          f"{RUNNER_CFG['nchains']} chains asis + aux_gibbs (n_gibbs "
          f"{RUNNER_CFG['cr_options']['n_gibbs']}) + direct MH on "
          f"8-bin blocks, float32: ms/iter per segment "
          f"{', '.join(f'{t:.2f}' for t in ms)} (wall {wall:.1f} s with the "
          f"set-up); acceptance CR {ref['cr_accepts'].mean():.4f}, MH "
          f"{acc}; peak memory {peak:.2f} GiB; the crashed and resumed run "
          f"{wall2:.1f} s, bit-equal to the uninterrupted one in "
          f"{', '.join(sorted(set(ref) - timed))} [{card}]", flush=True)
    launches = tuple(a + b for a, b in zip(n_ref, n_res))
    shapes = {k: sh.get(k, 0) + sh2.get(k, 0) for k in {**sh, **sh2}}
    print_shapes("runner", shapes)
    return launches, shapes


def phase_runner_fits(torch, lk, dev, card, tmp):
    """A HEALPix FITS mask through the runner: bench.py's-style galactic
    band at nside 512 written NESTED by the port, read back, ud_graded to
    nside 256 by ``run_experiment`` (RUNNER_FITS_CFG, ``time_steps``).
    The model kind the runner builds is read off the host-side cut
    weights and confirmed by the transforms' row counts in the launches.
    Returns (launches, shape counts)."""
    from gibbssampler_tpu_torch.inference import (RunConfig, read_healpix_map,
                                                  run_experiment,
                                                  write_healpix_map)
    from gibbssampler_tpu_torch.ops import healpix_cut_weights
    from gibbssampler_tpu_torch.sht import (galactic_band_mask,
                                            healpix_layout, ud_grade)
    nside = RUNNER_FITS_CFG["nside"]
    path = os.path.join(tmp, "mask.fits")
    mask = galactic_band_mask(2 * nside, FITS_BAND_DEG)
    write_healpix_map(path, mask, ordering="NESTED")
    back, hdr = read_healpix_map(path)
    check(hdr["ORDERING"] == "NESTED" and np.array_equal(back, mask),
          "FITS mask: the map read back differs from the one written")
    m = ud_grade(back, nside)
    f_sky = float((m > 0).mean())
    check(0.5 < f_sky < 0.95, f"FITS mask f_sky {f_sky}")
    lay = healpix_layout(nside, "ring")
    try:
        rows, _, _, sparse = healpix_cut_weights(lay, m[None], np.ones_like(m))
        kind = (f"cut decomposition over {rows.size} belt rows"
                + (f" + {sparse[1].size} hole pixels" if sparse else ""))
        nr_expect = rows.size
    except ValueError:
        kind, nr_expect = "full-transform fallback", 4 * nside - 1
    cfg = RunConfig(**RUNNER_FITS_CFG, mask_fits=path,
                    out=os.path.join(tmp, "fits.npz"))
    res, n, sh, wall = run_counted(torch, lk, lambda: run_experiment(
        cfg, verbose=lambda *a: None, device=dev))
    check(any(k[2] == nr_expect for k in sh),
          f"FITS run: no launch at the {kind}'s {nr_expect} rows")
    for f in range(2):
        check(np.isfinite(res[f"dl_chain_{f}"]).all(),
              f"FITS run dl_chain_{f} non-finite")
    nseg = -(-cfg.n_iter // cfg.segment)
    for name in ("cr", "cls", "full"):
        t = res[f"step_time_{name}"]
        check(t.shape == (nseg,) and (t > 0).all(),
              f"FITS run step_time_{name} {t}")
    print(f"runner HEALPix nside {nside} lmax {cfg.lmax}, FITS mask "
          f"(galactic band {FITS_BAND_DEG} deg at nside {2 * nside}, "
          f"NESTED, read back equal, ud_graded): f_sky {f_sky:.4f}; model: "
          f"{kind}; {cfg.nchains} chains centered aux_gibbs, ms/iter per "
          f"segment {', '.join(f'{t:.2f}' for t in res['durations'] / cfg.segment * 1e3)}; "
          f"step times per segment (ms) CR "
          f"{', '.join(f'{t * 1e3:.2f}' for t in res['step_time_cr'])}, "
          f"C_ell {', '.join(f'{t * 1e3:.2f}' for t in res['step_time_cls'])},"
          f" full {', '.join(f'{t * 1e3:.2f}' for t in res['step_time_full'])}"
          f"; wall {wall:.1f} s with the set-up [{card}]", flush=True)
    print_shapes("FITS runner", sh)
    return n, sh


def te_tolerance(ell):
    """The joint TE check's bound per degree: 0.45, the bound
    tests/test_joint.py::test_joint_gibbs_recovers_te_correlation sets at
    its lowest degree, l = 4 (2l + 1 = 9), shrunk with the
    inverse-Wishart scatter of a correlation, 1 / sqrt(2l + 1)."""
    return 0.45 * np.sqrt(9.0 / (2.0 * ell + 1.0))


def phase_joint(torch, lk, dev, card, tmp):
    """(a) The joint TQU scheme through the runner on the full sky
    (JOINT_CFG: exact joint CR and inverse-Wishart draw): the posterior
    TE correlation against the realization's over JOINT_TE_ELLS after
    JOINT_BURN iterations, every block finite and positive definite.
    (b) One float64 cg_joint_cr solve on a spin-3 band-cut model
    (JOINT_CG_*: the joint data of (a) under a band mask, the reference's
    noise levels): every chain converged, the true residual recomputed
    with the full-grid operator.  Returns (launches, shape counts)."""
    from gibbssampler_tpu_torch.harmonics import alm2cl_state
    from gibbssampler_tpu_torch.inference import (RunConfig, run_experiment,
                                                  simulate_dataset)
    from gibbssampler_tpu_torch.inference.runner import _fields, _mask
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    from gibbssampler_tpu_torch.samplers import (cg_joint_cr, joint_block_ops,
                                                 synfast_joint)
    cfg = RunConfig(**JOINT_CFG, out=os.path.join(tmp, "joint.npz"))
    torch.cuda.reset_peak_memory_stats(dev)
    res, n_a, sh_a, wall = run_counted(torch, lk, lambda: run_experiment(
        cfg, verbose=lambda *a: None, device=dev))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    chain = res["dl_chain_0"]
    L = cfg.lmax + 1
    check(chain.shape == (cfg.nchains, cfg.n_iter, L, 3, 3),
          f"joint chain shape {chain.shape}")
    check(np.isfinite(chain).all(), "joint chain has NaN or inf")
    ev = np.linalg.eigvalsh(chain[:, :, 2:].astype(np.float64))
    check((ev > 0).all(), f"joint blocks not positive definite: min "
          f"eigenvalue {ev.min():.3g}")
    # the realization: simulate_dataset draws the fields from the dataset
    # generator first, through synfast_joint of the C_ell blocks
    fields, blocks = _fields(cfg)
    ell = np.arange(L, dtype=np.float64)
    fac = np.where(ell >= 2, 2 * np.pi / np.maximum(ell * (ell + 1), 1), 0)
    s = synfast_joint(blocks * fac[:, None, None], cfg.lmax,
                      dtype=torch.float32, device=dev,
                      gen=torch.Generator(device=dev).manual_seed(cfg.seed))
    tt, ee, te = (alm2cl_state(a, cfg.lmax, b).double().cpu().numpy()
                  for a, b in ((s[0], s[0]), (s[1], s[1]), (s[0], s[1])))
    lo, hi = JOINT_TE_ELLS
    ls = np.arange(lo, hi + 1)
    r_hat = te[ls] / np.sqrt(tt[ls] * ee[ls])
    post = chain[:, JOINT_BURN:].astype(np.float64).mean(axis=(0, 1))
    r_post = post[ls, 0, 1] / np.sqrt(post[ls, 0, 0] * post[ls, 1, 1])
    dev_r = np.abs(r_post - r_hat)
    ratio = dev_r / te_tolerance(ls)
    worst = int(np.argmax(ratio))
    check(ratio.max() <= 1.0, f"joint TE recovery at l = {ls[worst]}: "
          f"|r_post - r_hat| = {dev_r[worst]:.4f} > "
          f"{te_tolerance(ls[worst]):.4f}")
    ms = res["durations"] / cfg.segment * 1e3
    print(f"joint TQU lmax {cfg.lmax} GL full sky, {cfg.nchains} chains, "
          f"exact joint CR + inverse-Wishart, float32, r_te {cfg.r_te}: ms/iter "
          f"per segment {', '.join(f'{t:.2f}' for t in ms)}; step times "
          f"(ms) CR {', '.join(f'{t * 1e3:.2f}' for t in res['step_time_cr'])}"
          f", inverse-Wishart "
          f"{', '.join(f'{t * 1e3:.2f}' for t in res['step_time_cls'])}; "
          f"TE over l {lo}-{hi} after {JOINT_BURN} iterations: mean r_post "
          f"{r_post.mean():.4f}, mean r_hat {r_hat.mean():.4f}, max "
          f"|r_post - r_hat| / bound {ratio.max():.3f} (l = {ls[worst]}), "
          f"median {np.median(ratio):.3f}; blocks SPD, min eigenvalue "
          f"{ev.min():.3g}; peak memory {peak:.2f} GiB; wall {wall:.1f} s "
          f"with the set-up [{card}]", flush=True)
    print_shapes("joint exact", sh_a)

    f64 = torch.float64
    t0 = time.time()
    model, _ = simulate_dataset(
        cfg.lmax, 3, fields, JOINT_CG_NOISE,
        fwhm_radians=np.radians(cfg.fwhm_deg),
        mask=_mask(RunConfig(lmax=cfg.lmax, mask_band_deg=JOINT_CG_BAND_DEG)),
        dtype=f64, device=dev, dl_blocks=blocks,
        gen=torch.Generator(device=dev).manual_seed(cfg.seed))
    model = with_cut_decomposition(model)
    bt = model.bt_ninv_d()
    check(model.has_cut and model.cut_sht.dtype == f64,
          "joint CG: the float64 spin-3 cut decomposition")
    nch = JOINT_CG_CHAINS
    cl = torch.as_tensor(blocks * fac[:, None, None], dtype=f64,
                         device=dev).expand(nch, -1, -1, -1)
    gen = torch.Generator(device=dev).manual_seed(11)
    om0 = torch.randn((nch,) + tuple(bt.shape), generator=gen, dtype=f64,
                      device=dev)
    om1 = torch.randn((nch,) + tuple(model.noise.tau.shape), generator=gen,
                      dtype=f64, device=dev)
    torch.cuda.synchronize()
    setup = time.time() - t0
    (out, n_b, sh_b, _) = run_counted(torch, lk, lambda: cuda_ms(
        torch, lambda: cg_joint_cr(model, cl, bt, tol=JOINT_CG_TOL,
                                   maxiter=CG_MAXITER, om0=om0, om1=om1)))
    (x, info), ms = out
    its = info.extra.cpu().numpy().astype(np.int64)
    check((its < CG_MAXITER).all(), f"joint CG: chains at the cap: {its}")
    # the true residual, with the full-grid operator in place of the
    # cut-ring complement form the solver used
    cinv, sqrt_cinv, _, active = joint_block_ops(model, cl)
    full = dataclasses.replace(model, cut_sht=None)
    b = (bt + sqrt_cinv(om0) + full.project_data(
        torch.sqrt(model.noise.inv_noise) * om1)) * active
    r = b - (cinv(x * active) + full.qn_apply(x * active)) * active
    res_true = (r.norm(dim=(-2, -1)) / b.norm(dim=(-2, -1))).cpu().numpy()
    check(res_true.max() <= JOINT_CG_TOL, f"joint CG true residual "
          f"{res_true.max():.3g} > {JOINT_CG_TOL}")
    n_it = int(its.max())
    print(f"joint CG float64 lmax {cfg.lmax} spin 3, band "
          f"{JOINT_CG_BAND_DEG} deg (cut over {model.cut_sht.nrings} rings), "
          f"noise {', '.join(f'{v:g}' for v in JOINT_CG_NOISE)} muK^2 per "
          f"pixel in T, Q, U, {nch} chains, "
          f"tol {JOINT_CG_TOL:g}: iterations max {n_it}, median "
          f"{float(np.median(its)):.1f}, every chain converged; {ms:.1f} ms "
          f"per solve, {ms / n_it:.3f} ms per iteration; true ||b - Qx||/||b||"
          f" (full-grid operator) max {res_true.max():.3g}; set-up "
          f"{setup:.1f} s [{card}]", flush=True)
    print_shapes("joint CG", sh_b)
    del bt, cl, om0, om1, x, b, r, full
    tally = {"launches": [0] * 4, "shapes": {}}
    spin3_engines(torch, lk, tally, model, fields, blocks, cfg, dev, card)
    del model
    torch.cuda.empty_cache()
    launches = tuple(a + c + e for a, c, e in zip(n_a, n_b,
                                                  tally["launches"]))
    shapes = {}
    for sh in (sh_a, sh_b, tally["shapes"]):
        for k, v in sh.items():
            shapes[k] = shapes.get(k, 0) + v
    return launches, shapes


def spin3_engines(torch, lk, tally, model, fields, blocks, cfg, dev, card,
                  nch=JOINT_CG_CHAINS):
    """The blocked-MH fast path on spin-3 (T, E, B) band-cut models at full
    width in float64, ``nch`` chains, TT and EE unit bins in one block
    each, BB bench.py's bins with its big block and 133 singles: (a) the
    joint CG's model (T noise 40^2, Q and U 0.2^2 muK^2: w_cut unequal
    across map components), where "auto" takes the coefficient engine;
    (b) the same sky at 0.2^2 in T, Q and U, where it takes the table
    engine (its spin-3 path).  Each one sweep against the direct path on
    the same uniforms (``engine_sweeps``)."""
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.harmonics import ell_mask_state
    from gibbssampler_tpu_torch.inference import simulate_dataset
    from gibbssampler_tpu_torch.inference.runner import RunConfig, _mask
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    from gibbssampler_tpu_torch.samplers import cls_samplers as cs
    f64 = torch.float64
    t0 = time.time()
    (bins_e, bins_b), (blk_e, blk_b) = flagship.asis_bins_blocks(LMAX)
    bins, blks = [bins_e, bins_e, bins_b], [blk_e, blk_e, blk_b]
    dl0 = [flagship.binned_mean(fields[f], b) for f, b in enumerate(bins)]
    sig = [0.05 * d for d in dl0]
    gen = torch.Generator(device=dev).manual_seed(13)
    dl = tuple(torch.as_tensor(np.tile(d, (nch, 1)), dtype=f64, device=dev)
               for d in dl0)
    s_nc = torch.randn((nch, 3, model.nstate), generator=gen, dtype=f64,
                       device=dev) * torch.as_tensor(
                           ell_mask_state(LMAX, 2), dtype=f64, device=dev)
    ntot, nblocks = sum(len(b) - 1 for b in bins), sum(map(len, blks))
    up = torch.rand((nch, 1, ntot), generator=gen, dtype=f64, device=dev)
    ua = torch.rand((nch, 1, nblocks), generator=gen, dtype=f64, device=dev)
    equal, _ = simulate_dataset(
        cfg.lmax, 3, fields, (JOINT_CG_NOISE[1],) * 3,
        fwhm_radians=np.radians(cfg.fwhm_deg),
        mask=_mask(RunConfig(lmax=cfg.lmax, mask_band_deg=JOINT_CG_BAND_DEG)),
        dtype=f64, sht=model.sht, dl_blocks=blocks,
        gen=torch.Generator(device=dev).manual_seed(cfg.seed))
    equal = with_cut_decomposition(equal)
    torch.cuda.synchronize()
    print(f"spin-3 MH sweeps: equal-noise model set-up "
          f"{time.time() - t0:.1f} s", flush=True)
    for name, m, want in (("T 40^2, Q and U 0.2^2", model, "coef"),
                          ("0.2^2 in T, Q and U", equal, "table")):
        check(m.cut_w_uniform and m.cut_w_equal_fields == (want == "table"),
              f"spin-3 model ({name}): cut weights not as expected")
        direct = cs.nc_cls_sample(dl, s_nc, cs.make_nc_log_likelihood(
            m, bins), bins, blks, sig, u_prop=up, u_acc=ua)
        engine_sweeps(torch, lk, tally, m, bins, blks, sig, dl, s_nc, up, ua,
                      direct, [("auto", want)],
                      f"MH sweep spin 3 float64, {nch} chains, {name}", card)
    del equal


def phase_flat(torch, lk, dev, card, sht, hsht):
    """The flat (real and healpy-order) alm interface at lmax 512 in
    float32: a synfast draw of spin 2 on the GL grid (``sht``) and of spin
    0 on HEALPix nside NSIDE (``hsht``); alm2cl of each draw against its
    input C_l within FLAT_CV_SIGMAS cosmic-variance deviations per l and
    on the mean over l; state_to_flat(flat_to_state(a)) == a exactly and
    healpy_to_flat(flat_to_healpy(a)) == a within the roundings of the
    sqrt(2) scale (3 float32 eps); the GL flat round trips analysis(synthesis(a))
    (spin 0 and 2; <= 5e-5 max|a|, phase 4's float32 bound) and the flat
    methods' adjointness on both grids (<= 1e-5, as phase 4's).  Returns
    (launches, shape counts)."""
    from gibbssampler_tpu_torch.harmonics import (
        alm2cl, dl_to_cl, flat_to_healpy, flat_to_state, healpy_to_flat,
        state_to_flat)
    from gibbssampler_tpu_torch.inference import example_dl, synfast
    tally = {"launches": [0] * 4, "shapes": {}}
    gen = torch.Generator(device=dev).manual_seed(14)
    ell = np.arange(2, LMAX + 1)
    sd = np.sqrt(2.0 / (2.0 * ell + 1.0))
    eps = float(torch.finfo(torch.float32).eps)

    def dot(a, b):
        return sum(float((x.double() * y.double()).sum()) for x, y in zip(a, b))

    for name, tr, spin, kinds in (("GL", sht, 2, ("ee", "bb")),
                                  (f"HEALPix nside {NSIDE}", hsht, 0,
                                   ("tt",))):
        dl = np.stack([example_dl(LMAX, k) for k in kinds])
        (alm, maps), wall = counted(torch, lk, tally, lambda: synfast(
            dl, tr, spin, gen=gen))
        check(alm.device == maps.device == tr.device
              and maps.shape[0] == len(kinds)
              and bool(torch.isfinite(maps).all()),
              f"synfast {name}: maps not finite on the card")
        flat = state_to_flat(alm, LMAX)                     # (nf, nflat)
        cl_hat = alm2cl(flat.double(), LMAX).cpu().numpy()[:, 2:]
        cl = dl_to_cl(torch.as_tensor(dl)).numpy()[:, 2:]
        dev_l = np.abs(cl_hat / cl - 1.0) / sd
        mean_dev = np.abs((cl_hat / cl - 1.0).mean(axis=1)) / (
            np.sqrt((sd ** 2).sum()) / ell.size)
        check(dev_l.max() <= FLAT_CV_SIGMAS
              and mean_dev.max() <= FLAT_CV_SIGMAS,
              f"synfast {name}: alm2cl off its input C_l by "
              f"{dev_l.max():.2f} cosmic-variance deviations at one l, "
              f"{mean_dev.max():.2f} on the mean")
        check(torch.equal(state_to_flat(flat_to_state(flat, LMAX), LMAX),
                          flat), f"{name}: flat -> state -> flat not exact")
        back = healpy_to_flat(flat_to_healpy(flat, LMAX), LMAX)
        hp_err = float(((back - flat).abs()
                        / flat.abs().clamp_min(1e-30)).max())
        # four roundings of at most eps / 2 each: the two scales' and
        # the two products'
        check(hp_err <= 3 * eps, f"{name}: flat -> healpy -> flat rel err "
              f"{hp_err:.3g} > 3 eps")
        # adjointness on the flat methods: y = A x + noise
        (rt, adj), _ = counted(torch, lk, tally, lambda: flat_checks(
            torch, tr, flat, spin, gen, name == "GL", dot))
        check(adj <= 1e-5, f"{name}: flat adjointness {adj:.3g} > 1e-5")
        if rt is not None:
            check(max(rt) <= 5e-5, f"GL flat round trip rel err {rt} > 5e-5")
        print(f"flat interface {name} lmax {LMAX} float32: synfast spin "
              f"{spin} ({wall * 1e3:.1f} ms with its draw); alm2cl vs the "
              f"input C_l max {dev_l.max():.2f} cosmic-variance deviations "
              f"at one l, {mean_dev.max():.2f} on the mean over l (bound "
              f"{FLAT_CV_SIGMAS:g}); state round trip exact; healpy round "
              f"trip max rel err {hp_err:.2e}; "
              + ("" if rt is None else f"round trip analysis(synthesis(a)) "
                 f"max rel err spin 0 {rt[0]:.2e}, spin 2 {rt[1]:.2e}; ")
              + f"flat adjointness {adj:.2e} [{card}]", flush=True)
        del alm, maps, flat, back
    torch.cuda.empty_cache()
    print_shapes("flat interface", tally["shapes"])
    return tuple(tally["launches"]), tally["shapes"]


def flat_checks(torch, tr, flat, spin, gen, round_trip, dot):
    """(round-trip errors or None, adjointness gap) of the flat methods on
    the draw ``flat``: the spin-0 and spin-2 analysis(synthesis(a)) round
    trips (``round_trip``, GL only) and |<A x, y> - <x, A^T y>| / |<A x,
    y>| with y = A x + noise, accumulated in float64."""
    noisy = lambda m: m + torch.randn(m.shape, generator=gen, dtype=m.dtype,
                                      device=m.device)
    if spin == 0:
        x = (flat[0],)
        ax = (tr.synthesis(x[0]),)
        y = tuple(noisy(m) for m in ax)
        aty = (tr.adjoint_synthesis(y[0]),)
    else:
        x = (flat[0], flat[1])
        ax = tr.synthesis_spin2(*x)
        y = tuple(noisy(m) for m in ax)
        aty = tr.adjoint_synthesis_spin2(*y)
    lhs = dot(ax, y)
    adj = abs(lhs - dot(x, aty)) / abs(lhs)
    rt = None
    if round_trip:
        scale = float(flat.abs().max())
        r0 = float((tr.analysis(tr.synthesis(flat[0])) - flat[0]).abs().max())
        r2 = max(float((a - b).abs().max()) for a, b in zip(
            tr.analysis_spin2(*tr.synthesis_spin2(flat[0], flat[1])), flat))
        rt = (r0 / scale, r2 / scale)
    return rt, adj


# ---------------------------------------------------------------------------
# the parallel layer (gibbssampler_tpu_torch.parallel, launch_pod)
# ---------------------------------------------------------------------------

def work_slab(name, L, nr, C, rows, itemsize):
    """``work`` of one call on the slab of the degree orders ``rows``: the
    slab's triangle rows and batch rows read once, its output written
    once."""
    tri, M = sum(L - m for m in rows), len(rows)
    if name == "legendre_synth_tri":
        nbytes = C * tri + nr * tri + M * nr * C
    else:
        nbytes = nr * tri + M * nr * C + C * M * L
    return 2 * nr * C * tri, nbytes * itemsize


def slab_counts(torch, lk):
    """(float32 synthesis, float32 adjoint, float64 synthesis, float64
    adjoint) launches in the m-slab form since the counts were set to 0."""
    return tuple(sum(v for k, v in fn.slabs.items() if k[-1] == dt)
                 for dt in (torch.float32, torch.float64)
                 for fn in (lk.legendre_synth_tri, lk.legendre_adj_tri))


def phase_slab_kernels(torch, lk, dev, card, rec, rec64):
    """Phase 3 in the m-slab form: both kernels, float32 at C 256 and
    float64 at C 16, on each of the two slabs (m_rows(513, 2): 257 and 256
    rows) of the band's 65 cut rings and the 513-ring full grid, in the
    layouts the m-sharded transform passes (x the contiguous (M, C, L) rows,
    g the (M, nr, C) view of (M, C, nr) memory), against the plain slab
    version and the slab's bound, beside phase 3's unsharded time.  The
    records go into ``rec`` / ``rec64`` under "<nr> slab <k> of 2"."""
    from gibbssampler_tpu_torch.parallel import m_rows
    gen = torch.Generator(device=dev).manual_seed(12)
    L = LMAX + 1
    for dtype, C, into in ((torch.float32, 2 * NCHAINS, rec),
                           (torch.float64, 2 * CG_CHAINS, rec64)):
        f32 = dtype == torch.float32
        tol = TOLS[str(dtype)[6:]]
        for nr in (CUT_RINGS, LMAX + 1):
            lam = tri_table(torch, L, nr, dtype, dev, gen)
            x = torch.randn((L, C, L), generator=gen, dtype=dtype, device=dev)
            g = torch.randn((L, nr, C), generator=gen, dtype=dtype,
                            device=dev)
            for k, rows in enumerate(m_rows(L, 2)):
                ms = torch.as_tensor(rows, dtype=torch.int32, device=dev)
                idx = ms.long()
                ls = lam.index_select(0, idx).contiguous()
                for name, kern, plain, b, shape in (
                        ("legendre_synth_tri", lk.legendre_synth_tri,
                         lk.legendre_synth_tri_plain, x.index_select(0, idx),
                         (len(rows), nr, C)),
                        ("legendre_adj_tri", lk.legendre_adj_tri,
                         lk.legendre_adj_tri_plain,
                         g_view(g.index_select(0, idx)), (C, len(rows), L))):
                    torch.full(shape, float("nan"), dtype=dtype, device=dev)
                    out = kern(ls, b, ms)
                    ref = plain(ls, b, ms)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    scale = float(ref.abs().max())
                    check(err <= tol * scale, f"{name} slab {k} nr={nr} C={C} "
                          f"{dtype}: max|err| {err} > {tol} * {scale}")
                    reps = 5 if nr > LMAX and f32 else 20
                    p1 = time_ms(torch, lambda: plain(ls, b, ms), reps)
                    k1 = time_ms(torch, lambda: kern(ls, b, ms), reps)
                    k2 = time_ms(torch, lambda: kern(ls, b, ms), reps)
                    p2 = time_ms(torch, lambda: plain(ls, b, ms), reps)
                    ms_k, ms_p = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
                    bound_ms, bound_by = bound(
                        *work_slab(name, L, nr, C, rows, lam.element_size()),
                        TF32X3_FLOPS_PER_S if f32 else FP64_FLOPS_PER_S)
                    full = into[name][nr]["ms"]
                    print(f"time {name} slab {k} of 2 (M {len(rows)}) L={L} "
                          f"nr={nr} C={C} {str(dtype)[6:]}: kernel "
                          f"{ms_k:.4f} ms (unsharded {full:.4f}, ratio "
                          f"{ms_k / full:.3f}), plain einsum {ms_p:.4f} ms; "
                          f"bound {bound_ms:.4f} ms ({bound_by}), "
                          f"{bound_ms / ms_k:.1%} of it reached; max|err|/"
                          f"max|ref| {err / scale:.2e} [{card}]", flush=True)
                    into[name][f"{nr} slab {k} of 2"] = {
                        "max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": ms_p, "rows": len(rows)}
            del lam, x, g
    torch.cuda.empty_cache()


def par_stats(torch, out, group):
    """Pooled EE mean and variance, split R-hat (float64) and the BB blocks'
    acceptance of a run's chains over ``group``, on the host."""
    from gibbssampler_tpu_torch.parallel import (acceptance_mean,
                                                 pooled_moments,
                                                 split_rhat_device)
    ee = out["dl_chains"][0].double()
    m, v = pooled_moments(ee, group=group)
    return {"mean": m.cpu().numpy(), "var": v.cpu().numpy(),
            "rhat": split_rhat_device(ee, group=group).cpu().numpy(),
            "acc": acceptance_mean(out["mh_accept"][1],
                                   group=group).cpu().numpy()}


def numpy_stats(ee, mh1):
    """``par_stats`` of all chains in numpy: ee (nchains, n_iter, nbins),
    mh1 (nchains, n_iter, nblocks)."""
    from gibbssampler_tpu_torch.diagnostics import split_rhat
    ee = ee.astype(np.float64)
    return {"mean": ee.mean(axis=(0, 1)), "var": ee.var(axis=(0, 1)),
            "rhat": np.array([split_rhat(ee[:, :, j])
                              for j in range(ee.shape[-1])]),
            "acc": mh1.astype(np.float64).mean(axis=0)}


def stats_err(got, want):
    """Largest |got - want| / max|want| over the statistics."""
    return max(float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-300)) for k in want)


def run_arrays(out):
    """A scheme.run output's chains and accepts, on the host."""
    return {"dl0": out["dl_chains"][0].cpu().numpy(),
            "dl1": out["dl_chains"][1].cpu().numpy(),
            "cr": out["cr_accept"].cpu().numpy(),
            "mh0": out["mh_accept"][0].cpu().numpy(),
            "mh1": out["mh_accept"][1].cpu().numpy()}


def phase_parallel_nccl(torch, lk, scheme, dl0, dev, card, tmp):
    """(a) NCCL at world size 1, in this process: the ASIS band slice (the
    scheme flagship.build makes) by ``sharded_run`` on a
    (1, 1) CUDA mesh, 128 chains, PAR_ITERS iterations, equal bit for bit
    to ``scheme.run`` with the generator seeded with PAR_SEED; the
    collectives over its chains against numpy (<= 1e-10).  Returns the
    launch counts of the sharded run."""
    import torch.distributed as dist
    from gibbssampler_tpu_torch.parallel import make_mesh, sharded_run
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "nccl_store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        check(mesh.device_type == "cuda" and dist.get_backend() == "nccl",
              "parallel (a): not a CUDA mesh over NCCL")
        torch.cuda.synchronize()
        lk.reset_launch_counts()
        t0 = time.time()
        out = sharded_run(scheme, dl0, n_iter=PAR_ITERS, nchains=NCHAINS,
                          mesh=mesh, seed=PAR_SEED)
        torch.cuda.synchronize()
        wall, n = time.time() - t0, counts(lk)
        ref = scheme.run(dl0, n_iter=PAR_ITERS, nchains=NCHAINS,
                         gen=torch.Generator(device=dev).manual_seed(PAR_SEED))
        got, want = run_arrays(out), run_arrays(ref)
        for k in want:
            check(np.array_equal(got[k], want[k]), f"parallel (a): "
                  f"sharded_run's {k} differs from scheme.run's")
        stats = par_stats(torch, out, mesh.get_group("chains"))
        err = stats_err(stats, numpy_stats(got["dl0"], got["mh1"]))
        check(err <= 1e-10, f"parallel (a): collectives vs numpy {err}")
    finally:
        dist.destroy_process_group()
    print(f"parallel (a) NCCL world 1, mesh (1, 1) cuda: sharded_run of the "
          f"ASIS band slice ({NCHAINS} chains, {PAR_ITERS} iterations, "
          f"{wall:.2f} s) equals scheme.run with the generator of seed "
          f"{PAR_SEED} bit for bit; pooled EE mean / var, split R-hat and BB "
          f"acceptance vs numpy max rel err {err:.2e} (<= 1e-10); launches "
          f"{n} [{card}]", flush=True)
    return n


def par_worker(rank, tmp):
    """(b) one of two gloo processes sharing cuda:0.  Builds the flagship
    band slice (flagship.build), runs its rank's 64 chains on a (2, 1)
    mesh with the pooled statistics; on a (1, 2) mesh checks the m-sharded
    full-grid and cut spin-2 transforms (float32, 128 chains) against the
    unsharded ones and solves one float64 cg_cr (tol 1e-5, CG_CHAINS
    chains) m-sharded and unsharded.  Saves its results as par<rank>.pt."""
    import datetime
    import torch
    import torch.distributed as dist
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.harmonics import ell_mask_state
    from gibbssampler_tpu_torch.parallel import (make_mesh, shard_sht,
                                                 sharded_run)
    from gibbssampler_tpu_torch.samplers import centered_cls_sample
    from gibbssampler_tpu_torch.samplers import cr as cr_mod
    from gibbssampler_tpu_torch.schemes import CenteredGibbs
    from gibbssampler_tpu_torch.sht import legendre_kernels as lk
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "gloo_store"), 2), rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=600))
    res = {}
    try:
        lk.build()
        t0 = time.time()
        scheme, dl0 = flagship.build("gl", "band", device=dev, lmax=LMAX)
        torch.cuda.synchronize()
        res["setup_s"] = time.time() - t0
        # (b1) the chains over a (2, 1) mesh
        mesh = make_mesh(2, 1, device_type="cpu")
        lk.reset_launch_counts()
        t0 = time.time()
        out = sharded_run(scheme, dl0, n_iter=PAR_ITERS, nchains=NCHAINS,
                          mesh=mesh, seed=PAR_SEED)
        torch.cuda.synchronize()
        res["chains_s"], res["chains_n"] = time.time() - t0, counts(lk)
        res["run"] = run_arrays(out)
        res["stats"] = par_stats(torch, out, mesh.get_group("chains"))
        # (b2) the m-sharded float32 transforms over a (1, 2) mesh
        mesh_m = make_mesh(1, 2, device_type="cpu")
        model = scheme.model
        gen = torch.Generator(device=dev).manual_seed(31)
        m2 = torch.as_tensor(ell_mask_state(LMAX, 2), device=dev)
        e, b = (torch.randn((NCHAINS, model.nstate), generator=gen,
                            device=dev) * m2 for _ in range(2))
        res["sht"] = {}
        for label, sht in (("full", model.sht), ("cut", model.cut_sht)):
            q, u = (torch.randn((NCHAINS, sht.nrings, sht.nphi),
                                generator=gen, device=dev) for _ in range(2))
            msh = shard_sht(sht, mesh_m)
            ref_s = sht.synthesis_spin2_state(e, b)
            ref_a = sht.adjoint_synthesis_spin2_state(q, u)
            torch.cuda.synchronize()
            lk.reset_launch_counts()
            syn = msh.synthesis_spin2_state(e, b)
            adj = msh.adjoint_synthesis_spin2_state(q, u)
            torch.cuda.synchronize()
            n = slab_counts(torch, lk)
            ms_s = time_ms(torch, lambda: msh.synthesis_spin2_state(e, b), 3)
            ms_u = time_ms(torch, lambda: sht.synthesis_spin2_state(e, b), 3)
            tabs = lambda t: sum(x.numel() * x.element_size() for x in
                                 (t.lam0, t.lam_p2, t.lam_m2))
            res["sht"][label] = {
                "rows": msh.lam0.shape[0], "nrings": sht.nrings,
                "bytes": tabs(msh), "bytes_full": tabs(sht), "slabs": n,
                "syn_err": max(float((s - r).abs().max() / r.abs().max())
                               for s, r in zip(syn, ref_s)),
                "adj_err": max(float((s - r).abs().max() / r.abs().max())
                               for s, r in zip(adj, ref_a)),
                "ms": ms_s, "ms_full": ms_u}
            del msh, syn, adj, ref_s, ref_a, q, u
        del scheme, model, out
        torch.cuda.empty_cache()
        # (b3) one float64 cg_cr m-sharded and unsharded, the same pool
        f64 = torch.float64
        m64, dls, _ = flagship.dataset("gl", "band", LMAX, dev, f64)
        mm = dataclasses.replace(m64, sht=shard_sht(m64.sht, mesh_m),
                                 cut_sht=shard_sht(m64.cut_sht, mesh_m))
        ubins = np.arange(2, LMAX + 2)
        su, ss = (CenteredGibbs(m, [ubins, ubins], cr_method="cg",
                                cr_options={"cg_maxiter": CG_MAXITER})
                  for m in (m64, mm))
        var = su.var_cls(tuple(torch.as_tensor(d[2:], dtype=f64, device=dev)
                               .expand(CG_CHAINS, -1) for d in dls))
        pool = su.draw_noise_pool(CG_CHAINS,
                                  torch.Generator(device=dev).manual_seed(7))
        cg = {}
        for label, m, sch in (("sharded", mm, ss), ("unsharded", m64, su)):
            lk.reset_launch_counts()
            (x, info), ms = cuda_ms(torch, lambda: cr_mod.cg_cr(
                m, var, sch.bt_ninv_d, tol=1e-5, maxiter=CG_MAXITER,
                noise=pool))
            dl = centered_cls_sample(
                x, sch.bins_list, LMAX,
                gen=torch.Generator(device=dev).manual_seed(9))
            cg[label] = {"its": info.extra.cpu().numpy(), "ms": ms,
                         "n": counts(lk), "slabs": slab_counts(torch, lk),
                         "dl": [d.cpu().numpy() for d in dl]}
        res["cg"] = cg
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(tmp, f"par{rank}.pt"))


def phase_parallel_gloo(torch, scheme, dl0, dev, card, tmp):
    """(b) the two gloo processes of ``par_worker`` on this card; their
    chains against this process's unsharded run of each rank's chains,
    their pooled statistics against numpy over all 128 chains, the
    m-sharded transforms and CG solve against the unsharded ones.  Returns
    the two processes' launch counts, summed."""
    import torch.multiprocessing as mp
    from gibbssampler_tpu_torch.parallel import chain_seed
    t0 = time.time()
    mp.start_processes(par_worker, args=(tmp,), nprocs=2,
                       start_method="spawn", join=True)
    wall = time.time() - t0
    res = [torch.load(os.path.join(tmp, f"par{r}.pt"), weights_only=False)
           for r in range(2)]
    k = NCHAINS // 2
    bitwise, dl_rel = True, 0.0
    for r, out in enumerate(res):
        ref = run_arrays(scheme.run(dl0, n_iter=PAR_ITERS, nchains=k,
                                    gen=torch.Generator(device=dev)
                                    .manual_seed(chain_seed(PAR_SEED, r))))
        for key, want in ref.items():
            got = out["run"][key]
            check(got.shape == want.shape, f"parallel (b) rank {r}: {key} "
                  f"shape {got.shape}, expected {want.shape}")
            bitwise &= bool(np.array_equal(got, want))
            if key.startswith("dl"):
                # another process may round a float32 sum another way (the
                # GEMM a library picks can depend on the buffers' addresses)
                rel = float(np.abs(got - want).max() / np.abs(want).max())
                check(rel <= 1e-5, f"parallel (b) rank {r}: its chains' "
                      f"{key} differ from the unsharded run of its chains "
                      f"by {rel:.3g} of max|ref|")
                dl_rel = max(dl_rel, rel)
            else:
                check(np.array_equal(got, want), f"parallel (b) rank {r}: "
                      f"its {key} differ from the unsharded run's")
    want = numpy_stats(np.concatenate([o["run"]["dl0"] for o in res]),
                       np.concatenate([o["run"]["mh1"] for o in res]))
    err = max(stats_err(out["stats"], want) for out in res)
    check(err <= 1e-10, f"parallel (b): pooled statistics vs numpy {err}")
    same = ("bit for bit" if bitwise else
            f"with equal accepts, D_ell to {dl_rel:.2e} of max|ref|")
    print(f"parallel (b) two gloo processes on cuda:0 ({wall:.1f} s; "
          f"flagship.build {res[0]['setup_s']:.1f} s each): mesh (2, 1), "
          f"{k} chains a process, {PAR_ITERS} iterations "
          f"({res[0]['chains_s']:.2f} s): each equals this process's "
          f"unsharded run of its chains {same}; pooled EE mean / var, split "
          f"R-hat and BB acceptance over the two vs numpy over all "
          f"{NCHAINS} chains max rel err {err:.2e} (<= 1e-10) [{card}]",
          flush=True)
    for label in ("full", "cut"):
        s = [out["sht"][label] for out in res]
        L = LMAX + 1
        check(sorted(x["rows"] for x in s) == [256, 257],
              f"parallel (b) {label}: rows {[x['rows'] for x in s]}, "
              f"expected 257 and 256 of {L}")
        worst = max(max(x["syn_err"], x["adj_err"]) for x in s)
        check(worst <= 1e-5, f"parallel (b) {label} m-sharded transform "
              f"vs unsharded: {worst}")
        for x in s:
            check(x["slabs"][0] > 0 and x["slabs"][1] > 0,
                  f"parallel (b) {label}: float32 slab launches {x['slabs']}")
        print(f"parallel (b) mesh (1, 2), {label} GL SHT ({s[0]['nrings']} "
              f"rings, spin 2, float32, {NCHAINS} chains): rows "
              f"{s[0]['rows']} / {s[1]['rows']} of {L}, table bytes "
              f"{s[0]['bytes']} / {s[1]['bytes']} against {s[0]['bytes_full']}"
              f" unsharded; synthesis max|err|/max|ref| "
              f"{max(x['syn_err'] for x in s):.2e}, adjoint "
              f"{max(x['adj_err'] for x in s):.2e}; synthesis "
              f"{s[0]['ms']:.3f} ms sharded (with its gloo all-gather, both "
              f"processes on one card) vs {s[0]['ms_full']:.3f} unsharded; "
              f"slab launches (synth, adj) {s[0]['slabs'][:2]} a process "
              f"[{card}]", flush=True)
    dl_err = 0.0
    for r, out in enumerate(res):
        cs, cu = out["cg"]["sharded"], out["cg"]["unsharded"]
        check(np.array_equal(cs["its"], cu["its"]),
              f"parallel (b) rank {r}: m-sharded cg_cr iterations "
              f"{cs['its']} vs unsharded {cu['its']}")
        check(cs["slabs"][2] > 0 and cs["slabs"][3] > 0,
              f"parallel (b): float64 slab launches {cs['slabs']}")
        err = max(float(np.abs(a - c).max() / np.abs(c).max())
                  for a, c in zip(cs["dl"], cu["dl"]))
        check(err <= 1e-9, f"parallel (b) rank {r}: m-sharded cg D_ell "
              f"vs unsharded {err}")
        dl_err = max(dl_err, err)
    cs, cu = res[0]["cg"]["sharded"], res[0]["cg"]["unsharded"]
    print(f"parallel (b) mesh (1, 2), float64 cg_cr tol 1e-5, {CG_CHAINS} "
          f"chains of the band: per-chain iterations {cs['its'].tolist()} "
          f"equal the unsharded solve's on both processes; D_ell max rel "
          f"err {dl_err:.2e} (<= 1e-9); {cs['ms']:.1f} ms per solve sharded "
          f"vs {cu['ms']:.1f} unsharded (both processes on one card); "
          f"float64 slab launches (synth, adj) {cs['slabs'][2:]} a process "
          f"[{card}]", flush=True)
    n = [0] * 4
    for out in res:
        parts = [out["chains_n"]] + [out["cg"][c]["n"] for c in out["cg"]] \
            + [out["sht"][c]["slabs"] for c in out["sht"]]
        n = [sum(v) for v in zip(n, *parts)]
    return n


def phase_launch_pod(torch, card, tmp):
    """(c) ``torchrun --standalone --nproc_per_node 1 -m
    gibbssampler_tpu_torch.launch_pod`` on NCCL (PAR_LAUNCH): process 0's
    npz holds the JAX launcher's keys, finite."""
    npz = os.path.join(tmp, "pod.npz")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "gibbssampler_tpu_torch.launch_pod",
           "--lmax", str(PAR_LAUNCH["lmax"]),
           "--nchains", str(PAR_LAUNCH["nchains"]),
           "--n-iter", str(PAR_LAUNCH["n_iter"]), "--out", npz]
    t0 = time.time()
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.time() - t0
    check(run.returncode == 0, f"parallel (c): launch_pod exited "
          f"{run.returncode}:\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    with np.load(npz) as z:
        keys = sorted(z.files)
        check(keys == ["config", "dl_chain_0", "ess", "rhat", "wall"],
              f"parallel (c): npz keys {keys}")
        shape = z["dl_chain_0"].shape
        check(shape == (PAR_LAUNCH["nchains"], PAR_LAUNCH["n_iter"],
                        PAR_LAUNCH["lmax"] - 1), f"parallel (c): chains {shape}")
        for k in ("dl_chain_0", "ess", "rhat", "wall"):
            check(np.isfinite(z[k]).all(), f"parallel (c): {k} not finite")
    lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
    print(f"parallel (c) torchrun launch_pod, NCCL, lmax "
          f"{PAR_LAUNCH['lmax']}, {PAR_LAUNCH['nchains']} chains, "
          f"{PAR_LAUNCH['n_iter']} iterations ({wall:.1f} s with start-up): "
          f"{' | '.join(lines[-2:])} [{card}]", flush=True)


def phase_parallel(torch, lk, model, dls, dev, card):
    """The parallel phase, (a)-(c), on the band dataset's flagship ASIS
    scheme with its tuned record (what flagship.build makes, and what
    par_worker builds); returns (a)'s and (b)'s launches."""
    from gibbssampler_tpu_torch import flagship
    t0 = time.time()
    scheme, dl0 = flagship.asis_setup(model, dls, "gl", "band")
    with tempfile.TemporaryDirectory() as tmp:
        na = phase_parallel_nccl(torch, lk, scheme, dl0, dev, card, tmp)
        nb = phase_parallel_gloo(torch, scheme, dl0, dev, card, tmp)
        phase_launch_pod(torch, card, tmp)
    print(f"parallel phase: {time.time() - t0:.1f} s [{card}]", flush=True)
    return [a + b for a, b in zip(na, nb)]


# ---------------------------------------------------------------------------
# the options phase: the ring-parity split, fft_mode, the table engine
# ---------------------------------------------------------------------------

def work_par(name, L, nr, C, itemsize, rows=None):
    """``work`` of one parity-mode call at nr output rings: the half-ring
    table (nh = ceil(nr / 2) rings, its triangle rows of the degree orders
    ``rows``, all L by default) and the batch read once, the output written
    once; each table entry serves C products."""
    rows = range(L) if rows is None else rows
    nh, tri, M = (nr + 1) // 2, sum(L - m for m in rows), len(rows)
    if name.startswith("legendre_synth"):
        nbytes = C * tri + nh * tri + M * nr * C
    else:
        nbytes = nh * tri + M * nr * C + C * M * L
    return 2 * nh * C * tri, nbytes * itemsize


def mirrored_table(torch, half, nr, flip=False, rows=None):
    """The full (M, L, nr) table whose north rings are ``half`` and whose
    ring nr-1-r is f (-1)^(l+m) times ring r: the dense kernels' operand
    of the same function as the parity kernels' on ``half``; ``rows`` the
    degree orders m of a slab's rows (all L by default)."""
    L, nh = half.shape[1], half.shape[2]
    lm = torch.arange(L, device=half.device)
    m = lm if rows is None else torch.as_tensor(rows, device=half.device)
    sign = (1.0 - 2.0 * ((lm[None, :] + m[:, None]) % 2)).to(half.dtype)
    if flip:
        sign = -sign
    south = (half[:, :, : nr - nh] * sign[:, :, None]).flip(2)
    return torch.cat([half, south], dim=2).contiguous()


def par_launch_config(lk, name, f32, nr, C):
    """The launch of a parity kernel at (nr, C): {"kind", "threads",
    "smem" (dynamic shared memory, bytes), "blocks_per_sm" (resident on
    this card)}: the float32 synthesis at its ring tile, the float32
    adjoint with g's unit stride on r (as timed), the float64 kernels'
    plans (the adjoint's with g's unit stride on r)."""
    if f32:
        kind = (f"synth par tile {lk.f32_par_synth_tile((nr + 1) // 2)}"
                if name == "legendre_synth_par" else "adj par unit-r g")
        return {"kind": kind, "threads": 256,
                "smem": lk.f32_dynamic_smem()[kind],
                "blocks_per_sm": lk.f32_blocks_per_sm()[kind]}
    kind = "synth par" if name == "legendre_synth_par" else "adj par"
    return {"kind": kind, **lk.f64_plan(nr, C)[kind]}


# the parity kernels' shapes in the options phase (nr, C): float32 on the
# 513-ring GL grid (nh 257, the equator row) and the 1023-ring HEALPix grid
# (nh 512) at the dense and the split spin-2 columns of 128 chains, float64
# at the CG family's 8 and 16 chains on the GL grid
PAR_SHAPES = {"float32": ((LMAX + 1, 2 * NCHAINS), (LMAX + 1, 4 * NCHAINS),
                          (HEALPIX_RINGS, 2 * NCHAINS),
                          (HEALPIX_RINGS, 4 * NCHAINS)),
              "float64": ((LMAX + 1, 2 * CG_CHAINS),
                          (LMAX + 1, 4 * CG_CHAINS))}


def phase_parity_kernels(torch, lk, dev, card, lmax=LMAX, shapes=None):
    """(a) Both parity kernels against their plain versions on the card, at
    PAR_SHAPES in the main path's layouts (x the (m, C, l) view of the
    state's grids, g the (m, r, C) view of an (m, C, r) copy), the outputs
    given NaN-filled memory, with and without ``flip``; against the dense
    kernel on the mirrored full table (the same function); then a slab of
    each (m_rows(L, 2)'s first).  Times kernel, plain version (its
    einsums) and the dense kernel on the full table (plain, kernel, kernel,
    plain), with the bound of work_par, and the one library call of the same
    function, torch.einsum on the mirrored full table.  Returns the float32
    and float64 records keyed "<nr> C<C>" (and "<nr> C<C> slab 0 of 2")."""
    from gibbssampler_tpu_torch.parallel import m_rows
    gen = torch.Generator(device=dev).manual_seed(13)
    L = lmax + 1
    rec, rec64 = {}, {}
    for dname, sh in (shapes or PAR_SHAPES).items():
        dtype = getattr(torch, dname)
        f32 = dtype == torch.float32
        tol = TOLS[dname]
        into = rec if f32 else rec64
        for nr, C in sh:
            nh = (nr + 1) // 2
            half = tri_table(torch, L, nh, dtype, dev, gen)
            x = x_view(torch.randn((L, C, L), generator=gen, dtype=dtype,
                                   device=dev))
            g = g_view(torch.randn((L, nr, C), generator=gen, dtype=dtype,
                                   device=dev))
            rows = m_rows(L, 2)[0]
            ms = torch.as_tensor(rows, dtype=torch.int32, device=dev)
            idx = ms.long()
            for name, kern, plain, dense, b, shape in (
                    ("legendre_synth_par", lk.legendre_synth_par,
                     lk.legendre_synth_par_plain, lk.legendre_synth_tri, x,
                     (L, nr, C)),
                    ("legendre_adj_par", lk.legendre_adj_par,
                     lk.legendre_adj_par_plain, lk.legendre_adj_tri, g,
                     (C, L, L))):
                synth = name == "legendre_synth_par"
                args = (nr,) if synth else ()
                errs = {}
                for flip in (False, True):
                    torch.full(shape, float("nan"), dtype=dtype, device=dev)
                    out = kern(half, b, *args, flip)
                    ref = plain(half, b, *args, flip)
                    full = dense(mirrored_table(torch, half, nr, flip), b)
                    torch.cuda.synchronize()
                    scale = float(ref.abs().max())
                    err = float((out - ref).abs().max())
                    derr = float((out - full).abs().max())
                    check(bool(torch.isfinite(out).all()) and err <= tol
                          * scale and derr <= 2 * tol * scale,
                          f"{name} L={L} nr={nr} C={C} {dname} flip={flip}:"
                          f" max|err| {err} (vs dense on the mirrored "
                          f"table {derr}) > {tol} * {scale}")
                    errs[flip] = (err, err / scale, derr / scale)
                full = mirrored_table(torch, half, nr)
                reps = 5 if f32 and nr > lmax else 20
                p1 = time_ms(torch, lambda: plain(half, b, *args), reps)
                k1 = time_ms(torch, lambda: kern(half, b, *args), reps)
                d1 = time_ms(torch, lambda: dense(full, b), reps)
                d2 = time_ms(torch, lambda: dense(full, b), reps)
                k2 = time_ms(torch, lambda: kern(half, b, *args), reps)
                p2 = time_ms(torch, lambda: plain(half, b, *args), reps)
                spec = "mlr,mcl->mrc" if synth else "mlr,mrc->mcl"
                lib = time_ms(torch, lambda: torch.einsum(spec, full, b),
                              reps)
                del full
                ms_k, ms_p, ms_d = 0.5 * (k1 + k2), 0.5 * (p1 + p2), \
                    0.5 * (d1 + d2)
                flops, nbytes = work_par(name, L, nr, C, half.element_size())
                bound_ms, bound_by = bound(
                    flops, nbytes,
                    TF32X3_FLOPS_PER_S if f32 else FP64_FLOPS_PER_S)
                dense_bound = bound(*work(name.replace("_par", "_tri"), L, nr,
                                          C, half.element_size()),
                                    TF32X3_FLOPS_PER_S if f32
                                    else FP64_FLOPS_PER_S)[0]
                print(f"time {name} L={L} nr={nr} (nh {nh}) C={C} {dname} "
                      f"state views: kernel {ms_k:.4f} ms, plain (einsums) "
                      f"{ms_p:.4f} ms, dense kernel on the full table "
                      f"{ms_d:.4f} ms, library (torch.einsum on the full "
                      f"table) {lib:.4f} ms; bound {bound_ms:.4f} ms "
                      f"({bound_by}; "
                      f"dense {dense_bound:.4f}), {bound_ms / ms_k:.1%} of "
                      f"it reached; max|err|/max|ref| {errs[False][1]:.2e}, "
                      f"flip {errs[True][1]:.2e}, vs dense "
                      f"{errs[False][2]:.2e} [{card}]", flush=True)
                cfg = par_launch_config(lk, name, f32, nr, C)
                into.setdefault(name, {})[f"{nr} C{C}"] = {
                    "max_abs_err": max(e[0] for e in errs.values()),
                    "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib,
                    "dense_ms": ms_d, "dense_bound_ms": dense_bound, **cfg}
                print(f"{name} L={L} nr={nr} C={C} {dname}: launch {cfg} "
                      f"[{card}]", flush=True)
                # the slab form: the first slab of the two-way split
                ls = half.index_select(0, idx).contiguous()
                bs = (b.index_select(0, idx) if synth
                      else g_view(g.index_select(0, idx)))
                out = kern(ls, bs, *args, False, ms)
                ref = plain(ls, bs, *args, False, ms)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                scale = float(ref.abs().max())
                check(err <= tol * scale, f"{name} slab 0 L={L} nr={nr} C={C}"
                      f" {dname}: max|err| {err} > {tol} * {scale}")
                s1 = time_ms(torch, lambda: kern(ls, bs, *args, False, ms),
                             reps)
                sp = time_ms(torch, lambda: plain(ls, bs, *args, False, ms),
                             reps)
                sb, sby = bound(*work_par(name, L, nr, C, half.element_size(),
                                          rows),
                                TF32X3_FLOPS_PER_S if f32
                                else FP64_FLOPS_PER_S)
                print(f"time {name} slab 0 of 2 (M {len(rows)}) L={L} nr={nr}"
                      f" C={C} {dname}: kernel {s1:.4f} ms, plain {sp:.4f} "
                      f"ms; bound {sb:.4f} ms ({sby}); max|err|/max|ref| "
                      f"{err / scale:.2e} [{card}]", flush=True)
                into[name][f"{nr} C{C} slab 0 of 2"] = {
                    "max_abs_err": err, "ms": s1, "plain_ms": sp,
                    "bound_ms": sb, "bound_by": sby, "library_ms": None,
                    "rows": len(rows)}
                del ls, bs, out, ref
            del half, x, g
    torch.cuda.empty_cache()
    return rec, rec64


def table_bytes(sht):
    """Bytes of the transform's Legendre tables on the device."""
    return sum(t.numel() * t.element_size()
               for t in (sht.lam0, sht.lam_p2, sht.lam_m2, sht.lam_w,
                         sht.lam_x) if t is not None)


def par_counts(lk):
    """(float32 synthesis, float32 adjoint, float64 synthesis, float64
    adjoint) parity-mode launches since the counts were set to 0."""
    s, a = lk.legendre_synth_par, lk.legendre_adj_par
    return (s.launches - s.launches_f64 - s.launches_bf16
            - s.launches_narrow - s.launches_f16 - s.launches_wide,
            a.launches - a.launches_f64 - a.launches_bf16
            - a.launches_narrow - a.launches_f16 - a.launches_wide,
            s.launches_f64, a.launches_f64)


def split_vs_dense(torch, lk, label, dense, split, nchains, tol, card, gen):
    """Spin-0 and spin-2 synthesis, adjoint and analysis of ``split``
    against ``dense`` on ``nchains`` random states and maps (<= tol
    max|dense|), each timed (3 calls, CUDA events) on both.  Returns the
    parity launches of the split calls (par_counts)."""
    from gibbssampler_tpu_torch.harmonics import ell_mask_state, nstate
    dev, dt, lmax = dense.device, dense.dtype, dense.lmax
    kw = dict(dtype=dt, device=dev)
    shp = (dense.npix_layout,) if hasattr(dense, "geo") else (
        dense.nrings, dense.nphi)
    m0 = torch.as_tensor(ell_mask_state(lmax, 0), **kw)
    m2 = torch.as_tensor(ell_mask_state(lmax, 2), **kw)
    x = torch.randn((nchains, nstate(lmax)), generator=gen, **kw) * m0
    e = torch.randn((nchains, nstate(lmax)), generator=gen, **kw) * m2
    b = torch.randn((nchains, nstate(lmax)), generator=gen, **kw) * m2
    f = torch.randn((nchains,) + shp, generator=gen, **kw)
    q = torch.randn((nchains,) + shp, generator=gen, **kw)
    u = torch.randn((nchains,) + shp, generator=gen, **kw)
    ops = [("synthesis", "synthesis_state", (x,)),
           ("adjoint", "adjoint_synthesis_state", (f,)),
           ("analysis", "analysis_state", (f,)),
           ("synthesis spin 2", "synthesis_spin2_state", (e, b)),
           ("adjoint spin 2", "adjoint_synthesis_spin2_state", (q, u)),
           ("analysis spin 2", "analysis_spin2_state", (q, u))]
    lk.reset_launch_counts()
    for what, meth, args in ops:
        ref = getattr(dense, meth)(*args)
        got = getattr(split, meth)(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        err = max(float((a - r).abs().max() / r.abs().max())
                  for a, r in zip(got, ref))
        check(err <= tol, f"{label} {what}: split against dense max|err| / "
              f"max|ref| {err:.3g} > {tol}")
        ms_d = time_ms(torch, lambda: getattr(dense, meth)(*args), 3)
        ms_s = time_ms(torch, lambda: getattr(split, meth)(*args), 3)
        print(f"split vs dense {label} {what}: max|err|/max|ref| {err:.2e} "
              f"(<= {tol}); dense {ms_d:.3f} ms, split {ms_s:.3f} ms per "
              f"transform [{card}]", flush=True)
    counts = par_counts(lk)
    dense_n = (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches)
    print(f"split vs dense {label}: table bytes dense "
          f"{table_bytes(dense) / 1e9:.3f} GB, split "
          f"{table_bytes(split) / 1e9:.3f} GB; launches (both paths, timing"
          f" included) dense {dense_n}, parity {counts}", flush=True)
    return counts


def phase_split_transforms(torch, lk, dev, card, sht, hsht, lmax=LMAX,
                           nside=NSIDE):
    """(b) The full-grid transforms ring-split against dense on the GL
    grid at lmax and on HEALPix nside (padded layout), spin 0 and 2:
    float32 at NCHAINS chains (<= 1e-5; the dense transforms are phase 4's
    ``sht`` and the HEALPix phase's ``hsht``) and float64 at CG_CHAINS
    chains (<= 1e-12).  Returns the float64 split calls' parity launches
    (the float64 parity kernels' path) and the float32 ones."""
    from gibbssampler_tpu_torch.sht import make_healpix_sht, make_sht
    gen = torch.Generator(device=dev).manual_seed(15)
    counts = [0] * 4
    for dtype, nch, tol in ((torch.float32, NCHAINS, 1e-5),
                            (torch.float64, CG_CHAINS, 1e-12)):
        for grid in ("GL", "HEALPix"):
            t0 = time.time()
            mk = (lambda rs: make_sht(lmax, dtype=dtype, spin2=True,
                                      device=dev, ring_split=rs)) \
                if grid == "GL" else \
                (lambda rs: make_healpix_sht(nside, lmax, dtype=dtype,
                                             spin2=True, layout="padded",
                                             device=dev, ring_split=rs))
            split = mk(True)
            dense = ((sht if grid == "GL" else hsht)
                     if dtype == torch.float32 else mk(False))
            check(split.ring_split and not dense.ring_split,
                  f"{grid} transforms: the split is off")
            print(f"split vs dense {grid} {str(dtype)[6:]}: transforms "
                  f"built in {time.time() - t0:.1f} s", flush=True)
            c = split_vs_dense(torch, lk, f"{grid} lmax {lmax} "
                               f"{str(dtype)[6:]} {nch} chains", dense,
                               split, nch, tol, card, gen)
            counts = [a + b for a, b in zip(counts, c)]
            del split, dense
            torch.cuda.empty_cache()
    return counts


def split_slice(torch, lk, scheme, dl0, dev, card, label, n_warm, n_timed):
    """``n_warm`` + ``n_timed`` iterations of a scheme at NCHAINS chains
    from flagship.start_state, the launch counts set to 0 before and read
    after: (ms/iter, (EE, BB big, BB singles) acceptances, dense launches,
    parity launches)."""
    from gibbssampler_tpu_torch.flagship import start_state
    gen = torch.Generator(device=dev).manual_seed(16)
    torch.cuda.synchronize()
    lk.reset_launch_counts()
    warm = scheme.run(dl0, n_iter=n_warm, gen=gen,
                      state=start_state(scheme, dl0, NCHAINS, gen))
    torch.cuda.synchronize()
    t0 = time.time()
    out = scheme.run(dl0, n_iter=n_timed, gen=gen, state=warm["final_state"])
    torch.cuda.synchronize()
    ms_iter = (time.time() - t0) / n_timed * 1e3
    dense_n = (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches,
               0, 0)
    par_n = par_counts(lk)
    check(float(out["cr_accept"].mean()) > 0.0, f"{label}: CR acceptance 0")
    for f in range(2):
        dl = out["dl_chains"][f]
        check(bool(torch.isfinite(dl).all() and (dl > 0).all()),
              f"{label}: non-finite or non-positive D_ell")
    acc = mh_acceptances(out)
    n = n_warm + n_timed
    par_shapes = {(fn.__name__,) + k: v for fn in (lk.legendre_synth_par,
                                                  lk.legendre_adj_par)
                  for k, v in fn.shapes.items()}
    if par_shapes:
        print_shapes(f"{label} parity", par_shapes)
    print(f"{label}: {ms_iter:.2f} ms/iter over {n_timed} iterations after "
          f"{n_warm} warm-up; MH acceptance EE block {acc[0]:.4f}, BB big "
          f"block {acc[1]:.4f}, BB singles {acc[2]:.4f}; launches per "
          f"iteration dense synth {dense_n[0] / n:.1f} adj "
          f"{dense_n[1] / n:.1f}, parity synth {par_n[0] / n:.1f} adj "
          f"{par_n[1] / n:.1f} (the initial CR draw included) [{card}]",
          flush=True)
    return ms_iter, acc, dense_n, par_n


# the options phase's scheme slices, cut in depth: warm-up and timed
# iterations of (c), the flagship ASIS band scheme without the cut
# decomposition (its MH synthesizes the full grid ~139 times an iteration:
# ~3 s/iter at 128 chains, so 2 + 5), and of (d), the cut ASIS band slice
# under fft_mode "fft" and "ct"
SPLIT_ITERS = (2, 5)
FFT_ITERS = (3, 10)


def phase_split_scheme(torch, lk, dev, card, lmax=LMAX, seed=False,
                       iters=SPLIT_ITERS):
    """(c) and (e): flagship.build of the ASIS band scheme with cut=False
    and ring_split=True, cold (an empty table cache, which it fills) and
    warm (the cache), with the engine that built the tables; the native
    engine against numpy at lmax 64; then the slice on that scheme and on
    the same scheme with ring_split=False, in one call: ms/iter,
    acceptances (each in ACCEPT_WINDOW at full width) and launches per
    iteration.  The split slice launches no dense kernel, the dense one
    no parity kernel.  Returns (dense launches, parity launches) of the
    two slices."""
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.sht import legendre as tl
    lib = tl.native_engine()
    check(lib is not None, "the native table engine did not load")
    x = np.cos(np.linspace(0.05, np.pi - 0.05, 65))
    nat = np.empty((65, 65, x.size))
    lib.gs_legendre_table(64, x.size, x, nat)
    err = float(np.abs(nat - tl._legendre_table_np(64, x)).max())
    check(err <= 1e-12, f"native Legendre table vs numpy at lmax 64: {err}")
    print(f"native table engine loaded; its Legendre table at lmax 64 "
          f"against numpy max|err| {err:.2e} (<= 1e-12)", flush=True)
    opts = dict(cut=False, seed=seed, lmax=lmax, device=dev)
    old = os.environ.get("XDG_CACHE_HOME")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["XDG_CACHE_HOME"] = tmp
        tl.CACHE = True
        try:
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.time()
                scheme, dl0 = flagship.build("gl", "band", ring_split=True,
                                             **opts)
                torch.cuda.synchronize()
                times.append(time.time() - t0)
                if len(times) == 1:
                    del scheme, dl0
                    torch.cuda.empty_cache()
            cached = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(tmp) for f in fs)
        finally:
            tl.CACHE = False
            if old is None:
                del os.environ["XDG_CACHE_HOME"]
            else:
                os.environ["XDG_CACHE_HOME"] = old
    print(f"flagship.build GL band cut=False ring_split=True lmax {lmax}: "
          f"cold {times[0]:.2f} s (the native engine's tables, written to "
          f"the cache: {cached / 1e9:.2f} GB), warm {times[1]:.2f} s (read "
          f"from the cache) [{card}]", flush=True)
    check(not scheme.model.has_cut and scheme.model.sht.ring_split,
          "the split scheme has a cut or dense tables")
    res = {}
    for rs in (True, False):
        if not rs:
            del scheme
            torch.cuda.empty_cache()
            scheme, dl0 = flagship.build("gl", "band", ring_split=False,
                                         **opts)
        label = (f"ASIS GL band cut=False ring_split={rs} lmax {lmax} "
                 f"{NCHAINS} chains")
        res[rs] = split_slice(torch, lk, scheme, dl0, dev, card, label,
                              *iters)
        ms_iter, acc, dense_n, par_n = res[rs]
        if rs:
            check(sum(dense_n) == 0 and par_n[0] > 0 and par_n[1] > 0,
                  f"{label}: dense launches {dense_n}, parity {par_n}: the "
                  f"split path must run the parity kernels only")
        else:
            check(sum(par_n) == 0, f"{label}: parity launches {par_n}")
        if lmax == LMAX:
            lo, hi = ACCEPT_WINDOW
            check(all(lo <= a <= hi for a in acc), f"{label}: MH "
                  f"acceptances {acc} outside [{lo}, {hi}]")
    del scheme
    torch.cuda.empty_cache()
    print(f"split against dense, the ASIS band scheme without the cut: "
          f"{res[True][0]:.2f} against {res[False][0]:.2f} ms/iter [{card}]",
          flush=True)
    return res[False][2], res[True][3]


def phase_fft_modes(torch, lk, dev, card, sht, lmax=LMAX, seed=False,
                    iters=FFT_ITERS):
    """(d) The cut ASIS band slice under fft_mode "fft" and "ct" (the cut
    transforms inherit the mode), beside phase 5's "matmul": ms/iter, and
    one spin-2 synthesis of the full grid's transform and of the cut one
    against "matmul" (``sht``, phase 4's; the cut transform's "matmul"
    twin built here).  Returns the dense launches."""
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.harmonics import ell_mask_state, nstate
    from gibbssampler_tpu_torch.sht import SHT
    gen = torch.Generator(device=dev).manual_seed(17)
    kw = dict(dtype=sht.dtype, device=dev)
    m2 = torch.as_tensor(ell_mask_state(lmax, 2), **kw)
    e = torch.randn((2, nstate(lmax)), generator=gen, **kw) * m2
    b = torch.randn((2, nstate(lmax)), generator=gen, **kw) * m2
    q0 = sht.synthesis_spin2_state(e, b) + (sht.synthesis_state(e),)
    dense = [0] * 4
    for mode in ("fft", "ct"):
        scheme, dl0 = flagship.build("gl", "band", fft_mode=mode, seed=seed,
                                     lmax=lmax, device=dev)
        model = scheme.model
        check(model.sht.fft_mode == model.cut_sht.fft_mode == mode,
              f"fft_mode {mode}: full {model.sht.fft_mode}, cut "
              f"{model.cut_sht.fft_mode}")
        # spin 2 and spin 0 ("fft" changes the spin-0 ring transforms only,
        # as in the JAX package)
        q1 = (model.sht.synthesis_spin2_state(e, b)
              + (model.sht.synthesis_state(e),))
        err = max(float((a - r).abs().max() / r.abs().max())
                  for a, r in zip(q1, q0))
        cut = model.cut_sht
        twin = SHT(cut.grid, lmax, spin2=True, **kw)
        err_cut = max(float((a - r).abs().max() / r.abs().max()) for a, r in
                      zip(cut.synthesis_spin2_state(e, b),
                          twin.synthesis_spin2_state(e, b)))
        check(err <= 1e-5 and err_cut <= 1e-5, f"fft_mode {mode}: spin-2 "
              f"synthesis against matmul {err:.3g} (cut {err_cut:.3g})")
        del twin
        label = f"ASIS GL band fft_mode={mode} lmax {lmax} {NCHAINS} chains"
        ms_iter, acc, dn, _ = split_slice(torch, lk, scheme, dl0, dev, card,
                                          label, *iters)
        dense = [a + b for a, b in zip(dense, dn)]
        base = SLICE_MS.get("ASIS gl band aux_mala")
        print(f"fft_mode {mode}: spin-0 and spin-2 synthesis against matmul "
              f"max|err|/"
              f"max|ref| full grid {err:.2e}, cut rings {err_cut:.2e}; "
              f"{ms_iter:.2f} ms/iter against matmul "
              + (f"{base:.2f}" if base is not None else "not measured")
              + f" ms/iter (phase 5, this call) [{card}]", flush=True)
        del scheme, model, cut
        torch.cuda.empty_cache()
    return dense


def phase_options(torch, lk, dev, card, sht, hsht):
    """The options phase: (a) the parity kernels, (b) the full-grid
    transforms split against dense, (c) + (e) the scheme on the split path
    with the table engine's set-up, (d) fft_mode.  Returns (the parity
    kernels' float32 and float64 records, their launches on the paths
    (b) float64 and (c), dense launches of (c) and (d))."""
    t0 = time.time()
    rec, rec64 = phase_parity_kernels(torch, lk, dev, card)
    f64_counts = phase_split_transforms(torch, lk, dev, card, sht, hsht)
    dense_c, par_c = phase_split_scheme(torch, lk, dev, card)
    dense_d = phase_fft_modes(torch, lk, dev, card, sht)
    par = [a + b for a, b in zip(par_c, [0, 0, *f64_counts[2:]])]
    dense = [a + b for a, b in zip(dense_c, dense_d)]
    print(f"options phase: {time.time() - t0:.1f} s; parity launches on its"
          f" paths (float32 synth, adj, float64 synth, adj) {par} [{card}]",
          flush=True)
    return rec, rec64, par, dense


# ---------------------------------------------------------------------------
# the bfloat16 table mode (phase 16)
# ---------------------------------------------------------------------------

BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
# against the plain version: the same exact products, float32 sums
BF16_TOL = 1e-5
# against the float64 operator on the unrounded table and batch: the
# bfloat16 rounding of both
BF16_OP_TOL = 1e-2
# the transforms with bfloat16 tables against float32 ones (max|err| /
# max|ref|): the bfloat16 operator error, some 4e-3 in the JAX package's
# note on it
BF16_TRANSFORM_TOL = 2e-2
# phase 3's dense shapes (the Pallas tests', a ragged one, the main path's
# row counts at 128 chains) and the parity mode at the GL grid's 257 and
# HEALPix's 512 north rings
BF16_DENSE_SHAPES = ([(16, 12, 8), (37, 19, 10)]
                     + [(LMAX + 1, nr, 2 * NCHAINS) for nr in TIMED_NR])
BF16_PAR_SHAPES = ((LMAX + 1, 2 * NCHAINS), (HEALPIX_RINGS, 2 * NCHAINS))
# the bf16 ASIS band slice, cut in depth: warm-up and timed iterations
BF16_ITERS = (5, 20)


def work_bf16(name, L, nr, C, rows=None):
    """(FLOPs, bytes) of one call on a bfloat16 table: the table's
    triangle read once in 2 bytes, the float32 batch read once and the
    float32 output written once in 4; a parity kernel (``name`` ending in
    "_par") on the half table of ceil(nr / 2) rings; ``rows`` the degree
    orders of a slab (all L by default)."""
    rows = range(L) if rows is None else rows
    tri, M = sum(L - m for m in rows), len(rows)
    nt = (nr + 1) // 2 if name.endswith("_par") else nr
    if name.startswith("legendre_synth"):
        batch, out = C * tri, M * nr * C
    else:
        batch, out = M * nr * C, C * M * L
    return 2 * nt * C * tri, 2 * nt * tri + 4 * (batch + out)


def bf16_counts(lk):
    """(dense synthesis, dense adjoint, parity synthesis, parity adjoint)
    launches of the bfloat16-table kernels since the counts were set to
    0."""
    return tuple(f.launches_bf16 for f in (
        lk.legendre_synth_tri, lk.legendre_adj_tri, lk.legendre_synth_par,
        lk.legendre_adj_par))


def bf16_one(torch, lk, name, lam, b, args, shape, ref64, label, card,
             time_it, library=None, rows=None):
    """One bfloat16-table kernel call against its plain version (<=
    BF16_TOL max|ref|) and the float64 operator ``ref64`` (<= BF16_OP_TOL),
    its output given NaN-filled memory; with ``time_it`` timed beside the
    plain version and ``library`` (one torch call on bfloat16 tensors),
    plain, kernel, kernel, plain.  Returns the record."""
    kern, plain = getattr(lk, name), getattr(lk, name + "_plain")
    dev = lam.device
    torch.full(shape, float("nan"), dtype=torch.float32, device=dev)
    out = kern(lam, b, *args)
    ref = plain(lam, b, *args)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    op = float((out.double() - ref64).abs().max() / ref64.abs().max())
    check(bool(torch.isfinite(out).all()) and err <= BF16_TOL * scale
          and op <= BF16_OP_TOL,
          f"{name} bf16 {label}: max|err| {err} > {BF16_TOL} * {scale} or "
          f"against the float64 operator {op:.3g} > {BF16_OP_TOL}")
    rec = {"max_abs_err": err}
    msg = (f"bf16 {name} {label}: max|err|/max|ref| {err / scale:.2e} (<= "
           f"{BF16_TOL}), against the float64 operator {op:.2e} (<= "
           f"{BF16_OP_TOL})")
    if time_it:
        L, nr = lam.shape[1], shape[1] if name.startswith(
            "legendre_synth") else b.shape[1]
        C = shape[2] if name.startswith("legendre_synth") else shape[0]
        reps = 5 if nr > LMAX else 20
        p1 = time_ms(torch, lambda: plain(lam, b, *args), reps)
        k1 = time_ms(torch, lambda: kern(lam, b, *args), reps)
        k2 = time_ms(torch, lambda: kern(lam, b, *args), reps)
        p2 = time_ms(torch, lambda: plain(lam, b, *args), reps)
        lib = time_ms(torch, library, reps) if library else None
        ms, pms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
        flops, nbytes = work_bf16(name, L, nr, C, rows)
        bound_ms, bound_by = bound(flops, nbytes, BF16_FLOPS_PER_S)
        rec.update(ms=ms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=lib, tflops=flops / ms * 1e-9)
        msg += (f"; kernel {ms:.4f} ms, plain {pms:.4f} ms, library (torch."
                f"einsum on bf16 tensors) "
                + (f"{lib:.4f} ms" if lib is not None else "none")
                + f"; bound {bound_ms:.4f} ms ({bound_by}), "
                f"{bound_ms / ms:.1%} of it reached; "
                f"{nbytes / ms * 1e-6:.0f} GB/s")
    print(msg + f" [{card}]", flush=True)
    return rec


def phase_bf16_kernels(torch, lk, dev, card):
    """(a) The four bfloat16-table kernels against their plain versions on
    the card (float32 batch, the outputs in NaN-filled memory) and against
    the float64 operator: the dense pair at BF16_DENSE_SHAPES, contiguous
    and in the main path's views (x the (m, C, l) view of the state's
    grids, g the (m, r, C) view of an (m, C, r) copy), with the
    adjointness of the pair; the parity pair at BF16_PAR_SHAPES, flip and
    not, its synthesis also against the dense kernel on the mirrored
    table; a slab (m_rows(513, 2)'s first) of each pair.  At L 513 each
    kernel is timed in the main path's views beside its plain version and
    torch.einsum on the bfloat16 tensors (cuBLAS), with the bound of
    work_bf16, the kernel's dynamic shared memory and its resident blocks
    an SM; the parity synthesis also beside the dense synthesis on the
    mirrored table ("dense_ms").  Returns {kernel: {shape key: record}}."""
    from gibbssampler_tpu_torch.parallel import m_rows
    gen = torch.Generator(device=dev).manual_seed(19)
    f32, f64, bf = torch.float32, torch.float64, torch.bfloat16
    rec = {}
    for L, nr, C in BF16_DENSE_SHAPES:
        lam64 = tri_table(torch, L, nr, f64, dev, gen)
        lam = lam64.to(bf)
        x0 = torch.randn((L, C, L), generator=gen, dtype=f32, device=dev)
        g0 = torch.randn((L, nr, C), generator=gen, dtype=f32, device=dev)
        for lay, x, g in (("contiguous", x0, g0),
                          ("state views", x_view(x0), g_view(g0))):
            timed = lay == "state views" and L == LMAX + 1
            xb, gb = x.to(bf), g.to(bf)
            for name, b, b16, spec, shape in (
                    ("legendre_synth_tri", x, xb, "mlr,mcl->mrc", (L, nr, C)),
                    ("legendre_adj_tri", g, gb, "mlr,mrc->mcl", (C, L, L))):
                r = bf16_one(
                    torch, lk, name, lam, b, (), shape,
                    torch.einsum(spec, lam64, b.double()),
                    f"L={L} nr={nr} C={C} {lay}", card, timed,
                    library=lambda spec=spec, b16=b16: torch.einsum(
                        spec, lam, b16))
                if timed:
                    rec.setdefault(name + "_bf16", {})[nr] = r
            # each kernel rounds its batch to bfloat16, so the pair is
            # adjoint on the rounded batches: <K R(x), R(y)> = <R(x), K^T
            # R(y)>, y = K x + noise so that the product is large
            y = lk.legendre_synth_tri_plain(lam, x) + g0
            y = g_view(y) if lay == "state views" else y
            rnd = lambda t: t.to(bf).double()
            lhs = float((lk.legendre_synth_tri(lam, x).double()
                         * rnd(y)).sum())
            rhs = float((rnd(x) * lk.legendre_adj_tri(lam, y).double()).sum())
            rel = abs(lhs - rhs) / abs(lhs)
            check(rel <= BF16_TOL, f"bf16 adjointness L={L} nr={nr} {lay}: "
                  f"{rel}")
            print(f"bf16 adjointness L={L} nr={nr} C={C} {lay}: {rel:.2e} (<= "
                  f"{BF16_TOL}) [{card}]", flush=True)
            del y
            del xb, gb
        # a slab of the two-way split at the band's rings
        if L == LMAX + 1 and nr == CUT_RINGS:
            rows = m_rows(L, 2)[0]
            ms = torch.as_tensor(rows, dtype=torch.int32, device=dev)
            idx = ms.long()
            ls, ls64 = lam.index_select(0, idx).contiguous(), \
                lam64.index_select(0, idx)
            xs, gs = x0.index_select(0, idx), g_view(g0.index_select(0, idx))
            M = len(rows)
            for name, b, spec, shape in (
                    ("legendre_synth_tri", xs, "mlr,mcl->mrc", (M, nr, C)),
                    ("legendre_adj_tri", gs, "mlr,mrc->mcl", (C, M, L))):
                ref64 = getattr(lk, name + "_plain")(ls64, b.double(), ms)
                rec[name + "_bf16"][f"{nr} slab 0 of 2"] = bf16_one(
                    torch, lk, name, ls, b, (ms,), shape, ref64,
                    f"slab 0 of 2 (M {M}) L={L} nr={nr} C={C}", card, True,
                    rows=rows)
            del ls, ls64, xs, gs
        del lam64, lam, x0, g0
    for nr, C in BF16_PAR_SHAPES:
        L, nh = LMAX + 1, (nr + 1) // 2
        half64 = tri_table(torch, L, nh, f64, dev, gen)
        half = half64.to(bf)
        x = x_view(torch.randn((L, C, L), generator=gen, dtype=f32,
                               device=dev))
        g = g_view(torch.randn((L, nr, C), generator=gen, dtype=f32,
                               device=dev))
        full = mirrored_table(torch, half, nr)
        for name, b, shape in (("legendre_synth_par", x, (L, nr, C)),
                               ("legendre_adj_par", g, (C, L, L))):
            synth = name == "legendre_synth_par"
            args = (nr,) if synth else ()
            for flip in (False, True):
                ref64 = getattr(lk, name + "_plain")(half64, b.double(),
                                                     *args, flip)
                spec = "mlr,mcl->mrc" if synth else "mlr,mrc->mcl"
                b16 = b.to(bf)
                mirrored = full if not flip else mirrored_table(
                    torch, half, nr, True)
                r = bf16_one(
                    torch, lk, name, half, b, (*args, flip), shape, ref64,
                    f"L={L} nr={nr} (nh {nh}) C={C} flip={flip} state views",
                    card, not flip,
                    library=lambda spec=spec, b16=b16, t=mirrored:
                    torch.einsum(spec, t, b16))
                if synth:
                    # the same products as the dense kernel on the mirrored
                    # table (the adjoint rounds its fold, the dense one each
                    # row: another function)
                    out = lk.legendre_synth_par(half, b, nr, flip)
                    dense = lk.legendre_synth_tri(mirrored, b)
                    torch.cuda.synchronize()
                    derr = float((out - dense).abs().max()
                                 / dense.abs().max())
                    check(derr <= 2 * BF16_TOL, f"bf16 {name} nr={nr} flip="
                          f"{flip} against the dense kernel on the mirrored "
                          f"table {derr:.3g}")
                    del out, dense
                    if not flip:
                        # the dense kernel on the mirrored table, timed
                        # beside the parity kernel's record
                        reps = 5 if nr > LMAX else 20
                        r["dense_ms"] = 0.5 * sum(time_ms(
                            torch, lambda t=mirrored: lk.legendre_synth_tri(
                                t, b), reps) for _ in range(2))
                        print(f"bf16 {name} nr={nr} C={C}: the dense "
                              f"synthesis on the mirrored table "
                              f"{r['dense_ms']:.4f} ms, the parity kernel "
                              f"{r['ms']:.4f} ms [{card}]", flush=True)
                if not flip:
                    rec.setdefault(name + "_bf16", {})[f"{nr} C{C}"] = r
                del ref64, b16, mirrored
            # a slab of the two-way split
            rows = m_rows(L, 2)[0]
            ms = torch.as_tensor(rows, dtype=torch.int32, device=dev)
            idx = ms.long()
            ls = half.index_select(0, idx).contiguous()
            bs = b.index_select(0, idx) if synth else g_view(
                g.index_select(0, idx))
            M = len(rows)
            ref64 = getattr(lk, name + "_plain")(
                half64.index_select(0, idx), bs.double(), *args, False, ms)
            rec[name + "_bf16"][f"{nr} C{C} slab 0 of 2"] = bf16_one(
                torch, lk, name, ls, bs, (*args, False, ms),
                (M, nr, C) if synth else (C, M, L), ref64,
                f"slab 0 of 2 (M {M}) L={L} nr={nr} C={C}", card, True,
                rows=rows)
            del ls, bs, ref64
        del half64, half, x, g, full
    torch.cuda.empty_cache()
    # each record's launch configuration: the kernel (the dense synthesis
    # at its ring tile; g with unit stride on r, as timed), its dynamic
    # shared memory and its resident blocks an SM
    smem, blocks = lk.bf16_dynamic_smem(), lk.bf16_blocks_per_sm()
    for name, by in rec.items():
        for key, r in by.items():
            nr = int(str(key).split()[0])
            kind = {"legendre_synth_tri_bf16": "synth tile "
                    f"{lk.bf16_synth_tile(nr)}",
                    "legendre_adj_tri_bf16": "adj unit-r g",
                    "legendre_synth_par_bf16": "synth par tile "
                    f"{lk.bf16_par_synth_tile((nr + 1) // 2)}",
                    "legendre_adj_par_bf16": "adj par unit-r g"}[name]
            r.update(kind=kind, smem=smem[kind], blocks_per_sm=blocks[kind])
            print(f"bf16 {name} {key}: {kind}, {smem[kind]} bytes of "
                  f"dynamic shared memory, {blocks[kind]} blocks an SM "
                  f"[{card}]", flush=True)
    return rec


def phase_bf16_transforms(torch, lk, dev, card, sht, hsht):
    """(b) The spin-2 transforms at full width with bfloat16 tables against
    float32 ones (phase 4's GL ``sht`` and the HEALPix phase's ``hsht``) at
    NCHAINS chains: GL lmax 512 with dense and with ring-split tables,
    HEALPix nside 256 (padded layout) dense; synthesis, adjoint and
    analysis, max|err|/max|ref| (<= BF16_TRANSFORM_TOL), ms per transform
    (3 calls, CUDA events, each beside the float32 one) and table bytes.
    Returns the bfloat16 launches of these calls (bf16_counts)."""
    from gibbssampler_tpu_torch.harmonics import ell_mask_state, nstate
    from gibbssampler_tpu_torch.sht import make_healpix_sht, make_sht
    gen = torch.Generator(device=dev).manual_seed(20)
    lk.reset_launch_counts()
    for label, ref, mk in (
            ("GL dense", sht, lambda: make_sht(
                LMAX, dtype=torch.float32, spin2=True, device=dev,
                table_dtype="bfloat16")),
            ("GL ring-split", sht, lambda: make_sht(
                LMAX, dtype=torch.float32, spin2=True, device=dev,
                table_dtype="bfloat16", ring_split=True)),
            ("HEALPix dense", hsht, lambda: make_healpix_sht(
                NSIDE, LMAX, dtype=torch.float32, spin2=True,
                layout="padded", device=dev, table_dtype="bfloat16"))):
        t0 = time.time()
        tr = mk()
        torch.cuda.synchronize()
        check(tr.table_dtype == torch.bfloat16 and all(
            t is None or t.dtype == torch.bfloat16
            for t in (tr.lam0, tr.lam_p2, tr.lam_m2, tr.lam_w, tr.lam_x)),
            f"bf16 {label}: tables not in bfloat16")
        kw = dict(dtype=torch.float32, device=dev)
        shp = (tr.npix_layout,) if hasattr(tr, "geo") else (tr.nrings,
                                                           tr.nphi)
        m2 = torch.as_tensor(ell_mask_state(LMAX, 2), **kw)
        e, b = (torch.randn((NCHAINS, nstate(LMAX)), generator=gen, **kw)
                * m2 for _ in range(2))
        q, u = (torch.randn((NCHAINS,) + shp, generator=gen, **kw)
                for _ in range(2))
        for what, meth, args in (
                ("synthesis", "synthesis_spin2_state", (e, b)),
                ("adjoint", "adjoint_synthesis_spin2_state", (q, u)),
                ("analysis", "analysis_spin2_state", (q, u))):
            want = getattr(ref, meth)(*args)
            got = getattr(tr, meth)(*args)
            torch.cuda.synchronize()
            err = max(float((a - r).abs().max() / r.abs().max())
                      for a, r in zip(got, want))
            check(err <= BF16_TRANSFORM_TOL, f"bf16 {label} spin-2 {what}: "
                  f"against float32 tables {err:.3g} > {BF16_TRANSFORM_TOL}")
            ms_f = time_ms(torch, lambda: getattr(ref, meth)(*args), 3)
            ms_b = time_ms(torch, lambda: getattr(tr, meth)(*args), 3)
            print(f"bf16 {label} lmax {LMAX} spin-2 {what} at {NCHAINS} "
                  f"chains: max|err|/max|ref| against float32 tables "
                  f"{err:.2e} (<= {BF16_TRANSFORM_TOL}); {ms_b:.3f} ms per "
                  f"transform, float32 tables {ms_f:.3f} ms [{card}]",
                  flush=True)
            del want, got
        print(f"bf16 {label}: table bytes {table_bytes(tr) / 1e9:.3f} GB "
              f"(float32 dense {table_bytes(ref) / 1e9:.3f} GB), built in "
              f"{time.time() - t0:.1f} s", flush=True)
        del tr, e, b, q, u
        torch.cuda.empty_cache()
    n = bf16_counts(lk)
    check(all(n), f"bf16 transforms: bf16 launches {n}; every kernel must run")
    return n


def phase_bf16_slice(torch, lk, dev, card, iters=BF16_ITERS, lmax=LMAX,
                     seed=False, td="bfloat16", sfx="bf16",
                     counter=bf16_counts):
    """(c) bench.py's BENCH_TABLE_DTYPE=bfloat16 (``td``): the flagship
    ASIS band slice from flagship.build(table_dtype=td) at full width (GL
    513 x 1026, the cut over 65 rings, NCHAINS chains, float32 compute,
    the tuned record), cut in depth to ``iters`` (warm-up, timed):
    ms/iter, the MH step's ms/iter, the MH acceptances in ACCEPT_WINDOW,
    exactly ASIS_PER_ITER launches of the table dtype's kernels (``sfx``,
    counted by ``counter``) per timed iteration and no other Legendre
    launch, finite chains, peak memory.  Returns the launches of the path
    (``counter``)."""
    from gibbssampler_tpu_torch import flagship
    t0 = time.time()
    scheme, dl0 = flagship.build("gl", "band", table_dtype=td,
                                 device=dev, lmax=lmax, seed=seed)
    model = scheme.model
    tdt = getattr(torch, td)
    check(model.sht.table_dtype == model.cut_sht.table_dtype == tdt
          and model.cut_sht.lam_p2.dtype == tdt,
          f"flagship.build(table_dtype={td!r}): tables not in {td}")
    torch.cuda.synchronize()
    print(f"{sfx} ASIS band scheme set-up (dataset, cut, table engine): "
          f"{time.time() - t0:.1f} s", flush=True)
    label = f"ASIS gl band aux_mala {sfx}"
    n_warm, n_timed = iters
    warm, out, wall, launches, timed, mh_ms = run_timed_mh_slice(
        torch, lk, scheme, dl0, dev, label, ASIS_PER_ITER, n_timed, n_warm)
    n = counter(lk)
    every = sum(f.launches for f in (
        lk.legendre_synth_tri, lk.legendre_adj_tri, lk.legendre_synth_par,
        lk.legendre_adj_par))
    print_shapes(f"{label} (warm-up and timed)", shape_counts(lk))
    check(n[:2] == tuple(launches) and sum(n[2:]) == 0 and every == sum(n),
          f"{label}: {sfx} launches {n}, dense launches {launches}, every "
          f"Legendre launch {every}: the path must run the {sfx} dense "
          f"kernels only")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    held = SLICE_HELD["last"] / 2 ** 30
    acc = check_chains(torch, warm, out, scheme.bins_list, n_timed, n_warm)
    ee, bb_big, singles = mh_acceptances(out)
    if lmax == LMAX:
        lo, hi = ACCEPT_WINDOW
        for what, a in (("EE block", ee), ("BB big block", bb_big),
                        ("BB singles", singles)):
            check(lo <= a <= hi, f"{label} MH acceptance of the {what} "
                  f"{a:.4f} outside [{lo}, {hi}]")
    base = SLICE_MS.get("ASIS gl band aux_mala")
    print(f"slice lmax={lmax} {NCHAINS} chains {label}: "
          f"{wall / n_timed * 1e3:.2f} ms/iter over {n_timed} iterations "
          f"after {n_warm} warm-up (float32 tables: "
          + (f"{base:.2f}" if base is not None else "not measured")
          + f" ms/iter, phase 5, this call); MH step {mh_ms:.2f} ms/iter "
          f"(float32 tables: "
          + (f"{MH_MS['ASIS gl band aux_mala']:.2f}"
             if "ASIS gl band aux_mala" in MH_MS else "not measured")
          + f"); acceptance CR {acc:.4f}, MH EE block {ee:.4f}, BB big "
          f"block {bb_big:.4f}, BB singles {singles:.4f}; {sfx} launches per "
          f"timed iteration {timed[0] / n_timed:.1f} + "
          f"{timed[1] / n_timed:.1f}; peak device memory {peak:.2f} GiB "
          f"({held:.2f} GiB allocated when the timed run started) "
          f"[{card}]", flush=True)
    del scheme, model, warm, out
    torch.cuda.empty_cache()
    return n


# ---------------------------------------------------------------------------
# float64 compute on narrow tables: bfloat16, float32 and float16 Legendre
# tables under a float64 batch (csrc/legendre_tri_narrow_f64.cu)
# ---------------------------------------------------------------------------

# the table dtypes and their kernels' entry-point suffixes
NARROW_SFX = {"bfloat16": "bf16f64", "float32": "f32f64",
              "float16": "f16f64"}
# against the plain version: the same exact products, float64 sums
NARROW_TOL = 1e-12
# the narrow source's table bytes an element by entry-point suffix
NARROW_TABLE_BYTES = {"bf16f64": 2, "f32f64": 4, "f16f64": 2, "f64f32": 8}
# the transforms against float64-table ones (max|err| / max|ref|): the
# table dtype's operator error
NARROW_TRANSFORM_TOL = {"bfloat16": 2e-2, "float32": 1e-5,
                        "float16": 2e-2}
# (nr, C) of the dense pair and of the parity pair (nr the output's rings):
# the band's cut rings and the full GL grid at the CG family's 8 and 16
# chains (x Re/Im)
NARROW_DENSE_SHAPES = ((CUT_RINGS, 2 * CG_CHAINS), (LMAX + 1, 2 * CG_CHAINS),
                       (LMAX + 1, 4 * CG_CHAINS))
NARROW_PAR_SHAPES = ((LMAX + 1, 2 * CG_CHAINS), (LMAX + 1, 4 * CG_CHAINS))
# cg_cr on the narrow tables: the float32 tables must converge at
# NARROW_CG_TOL; the 16-bit tables' operators are not linear (the batch is
# rounded before each product), so their solves are capped, their floor
# printed, and they must stay finite
NARROW_CG_TOL = 1e-5
NARROW_BF16_CAPS = (25, 50, 100, 200, 300)
NARROW_CAPPED = ("bfloat16", "float16")
NARROW_KERNELS = ("legendre_synth_tri", "legendre_adj_tri",
                  "legendre_synth_par", "legendre_adj_par")


def work_narrow(name, L, nr, C, itemsize, rows=None, batch_itemsize=8):
    """(FLOPs, bytes) of one call on a table of ``itemsize`` bytes with a
    float64 batch: the table's triangle read once, the batch read once and
    the output written once in 8 bytes (``batch_itemsize``); a parity
    kernel (``name`` ending in "_par") on the half table of ceil(nr / 2)
    rings; ``rows`` the degree orders of a slab (all L by default)."""
    rows = range(L) if rows is None else rows
    tri, M = sum(L - m for m in rows), len(rows)
    nt = (nr + 1) // 2 if name.endswith("_par") else nr
    if name.startswith("legendre_synth"):
        batch, out = C * tri, M * nr * C
    else:
        batch, out = M * nr * C, C * M * L
    return (2 * nt * C * tri,
            itemsize * nt * tri + batch_itemsize * (batch + out))


def narrow_counts(torch, lk, td):
    """Launches of the four narrow-table float64 kernels on table dtype
    ``td`` (dense synthesis, dense adjoint, parity synthesis, parity
    adjoint) since the counts were set to 0: the shape counts of kernel
    dtype (td, float64), full table and slabs."""
    key = (td, torch.float64)
    return tuple(sum(v for k, v in (*fn.shapes.items(), *fn.slabs.items())
                     if k[-1] == key)
                 for fn in (getattr(lk, name) for name in NARROW_KERNELS))


def narrow_one(torch, lk, name, lam, b, args, out_shape, lam64, label, card,
               library, rows=None):
    """One narrow-table kernel call against its plain version (<=
    NARROW_TOL max|ref|), its output given NaN-filled memory; timed beside
    the plain version (plain, kernel, float64 kernel, kernel, plain), the
    float64 kernel on the float64 table ``lam64`` and ``library`` (one
    torch.einsum on the table upcast to float64, or None).  The kernels and
    the library call are timed on the device (graph_ms: at the CG's 65
    rings a wrapper call takes longer on the host than its kernel on the
    card), the plain version (whose slab form reads ms on the host) and the
    wrapper call back to back with events (time_ms; "call_ms", host time
    included).  Returns the record."""
    kern, plain = getattr(lk, name), getattr(lk, name + "_plain")
    torch.full(out_shape, float("nan"), dtype=torch.float64,
               device=lam.device)
    out = kern(lam, b, *args)
    ref = plain(lam, b, *args)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()) and err <= NARROW_TOL * scale,
          f"{name} {label}: max|err| {err} > {NARROW_TOL} * {scale}")
    synth = name.startswith("legendre_synth")
    L, nr = lam.shape[1], out_shape[1] if synth else b.shape[1]
    C = out_shape[2] if synth else out_shape[0]
    p1 = time_ms(torch, lambda: plain(lam, b, *args), 20)
    k1 = graph_ms(torch, lambda: kern(lam, b, *args), 20)
    f64 = graph_ms(torch, lambda: kern(lam64, b, *args), 20)
    k2 = graph_ms(torch, lambda: kern(lam, b, *args), 20)
    p2 = time_ms(torch, lambda: plain(lam, b, *args), 20)
    lib = graph_ms(torch, library, 20) if library else None
    call = time_ms(torch, lambda: kern(lam, b, *args), 20)
    ms, pms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    flops, nbytes = work_narrow(name, L, nr, C, lam.element_size(), rows)
    bound_ms, bound_by = bound(flops, nbytes, FP64_FLOPS_PER_S)
    b64 = bound(*work_narrow(name, L, nr, C, 8, rows), FP64_FLOPS_PER_S)[0]
    print(f"narrow {name} {str(lam.dtype)[6:]} table, float64 batch, "
          f"{label}: max|err|/max|ref| {err / scale:.2e} (<= {NARROW_TOL}); "
          f"kernel {ms:.4f} ms, plain {pms:.4f} ms, float64 kernel on the "
          f"float64 table {f64:.4f} ms (its bound {b64:.4f} ms), torch.einsum "
          f"on the upcast table "
          + (f"{lib:.4f} ms" if lib is not None else "none")
          + f"; bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} "
          f"of it reached; {flops / ms * 1e-9:.2f} TFLOP/s, "
          f"{nbytes / ms * 1e-6:.0f} GB/s; the wrapper call back to back "
          f"{call:.4f} ms [{card}]", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "f64_kernel_ms": f64, "f64_bound_ms": b64, "call_ms": call}


def phase_narrow_kernels(torch, lk, dev, card):
    """(a) The four narrow-table float64 kernels against their plain
    versions on the card, with bfloat16, float32 and float16 tables, at L
    513:
    the dense pair at NARROW_DENSE_SHAPES, the parity pair at
    NARROW_PAR_SHAPES (flip and not), in the main path's layouts (x the
    (m, C, l) view of the state's grids, g the (m, r, C) view of an (m, C,
    r) copy), and slab 0 of the two-way split (m_rows(513, 2)) of the
    dense pair at the cut rings and of the parity pair at 16 columns; each
    timed beside its plain version, the float64 kernel on the float64
    table and one torch.einsum on the upcast table and the rounded batch
    (the parity pair's: the dense einsum on the mirrored table, on a slab
    the slab's mirrored rows; narrow_one says which are timed on the
    device), with the
    bound of the narrow table (bytes over 3.35 TB/s, FLOPs over 67
    TFLOP/s); then the float16 kernels' one rounding (f16f64_edges).
    Returns {kernel name with its suffix: {shape key: record}}."""
    from gibbssampler_tpu_torch.parallel import m_rows
    gen = torch.Generator(device=dev).manual_seed(31)
    f64, L = torch.float64, LMAX + 1
    recs = {}
    rows = m_rows(L, 2)[0]
    ms0 = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    idx = ms0.long()
    for tdn, sfx in NARROW_SFX.items():
        td = getattr(torch, tdn)
        into = {name: recs.setdefault(f"{name}_{sfx}", {})
                for name in NARROW_KERNELS}

        def one(name, key, lam, b, args, out_shape, lam64, library,
                rows=None):
            into[name][key] = narrow_one(torch, lk, name, lam, b, args,
                                         out_shape, lam64, key, card,
                                         library, rows)

        for nr, C in NARROW_DENSE_SHAPES:
            lam64 = tri_table(torch, L, nr, f64, dev, gen)
            lam = lam64.to(td)
            x = x_view(torch.randn((L, C, L), generator=gen, dtype=f64,
                                   device=dev))
            g = g_view(torch.randn((L, nr, C), generator=gen, dtype=f64,
                                   device=dev))
            up, rx, rg = lam.double(), x.to(td).double(), g.to(td).double()
            key = f"{nr} C{C}"
            one("legendre_synth_tri", key, lam, x, (), (L, nr, C), lam64,
                lambda: torch.einsum("mlr,mcl->mrc", up, rx))
            one("legendre_adj_tri", key, lam, g, (), (C, L, L), lam64,
                lambda: torch.einsum("mlr,mrc->mcl", up, rg))
            if (nr, C) == NARROW_DENSE_SHAPES[0]:
                ls, l64, us = (t.index_select(0, idx).contiguous()
                               for t in (lam, lam64, up))
                xs, gs = x.index_select(0, idx), g_view(g.index_select(0, idx))
                rxs, rgs = xs.to(td).double(), gs.to(td).double()
                key = f"{nr} C{C} slab 0 of 2"
                one("legendre_synth_tri", key, ls, xs, (ms0,),
                    (len(rows), nr, C), l64,
                    lambda: torch.einsum("mlr,mcl->mrc", us, rxs), rows)
                one("legendre_adj_tri", key, ls, gs, (ms0,),
                    (C, len(rows), L), l64,
                    lambda: torch.einsum("mlr,mrc->mcl", us, rgs), rows)
                del ls, l64, us, xs, gs, rxs, rgs
            del lam64, lam, x, g, up, rx, rg
        for nr, C in NARROW_PAR_SHAPES:
            lam64 = tri_table(torch, L, (nr + 1) // 2, f64, dev, gen)
            lam = lam64.to(td)
            x = x_view(torch.randn((L, C, L), generator=gen, dtype=f64,
                                   device=dev))
            g = g_view(torch.randn((L, nr, C), generator=gen, dtype=f64,
                                   device=dev))
            rx, rg = x.to(td).double(), g.to(td).double()
            for flip in (True, False):
                key = f"{nr} C{C}" + (" flip" if flip else "")
                full = mirrored_table(torch, lam.double(), nr, flip)
                one("legendre_synth_par", key, lam, x, (nr, flip),
                    (L, nr, C), lam64,
                    lambda: torch.einsum("mlr,mcl->mrc", full, rx))
                one("legendre_adj_par", key, lam, g, (flip,), (C, L, L),
                    lam64, lambda: torch.einsum("mlr,mrc->mcl", full, rg))
                del full
            if (nr, C) == NARROW_PAR_SHAPES[0]:
                ls, l64 = (t.index_select(0, idx).contiguous()
                           for t in (lam, lam64))
                xs, gs = x.index_select(0, idx), g_view(g.index_select(0, idx))
                rxs, rgs = xs.to(td).double(), gs.to(td).double()
                full = mirrored_table(torch, ls.double(), nr, rows=rows)
                key = f"{nr} C{C} slab 0 of 2"
                one("legendre_synth_par", key, ls, xs, (nr, False, ms0),
                    (len(rows), nr, C), l64,
                    lambda: torch.einsum("mlr,mcl->mrc", full, rxs), rows)
                one("legendre_adj_par", key, ls, gs, (False, ms0),
                    (C, len(rows), L), l64,
                    lambda: torch.einsum("mlr,mrc->mcl", full, rgs), rows)
                del ls, l64, xs, gs, rxs, rgs, full
            del lam64, lam, x, g, rx, rg
        torch.cuda.empty_cache()
    f16f64_edges(torch, lk, dev, card)
    return recs


# float64 values that one rounding to float16 and two (through float32)
# take to different neighbours, ties and their neighbours, subnormals, the
# largest finite float16 and values past it
F16_EDGES = (1.0 + 2.0 ** -11 + 2.0 ** -40, 1.0 + 2.0 ** -11 - 2.0 ** -40,
             -(1.0 + 2.0 ** -11 + 2.0 ** -40), 1.0 + 2.0 ** -11,
             1.0 + 3 * 2.0 ** -11, 2.0 ** -24, 2.0 ** -25 + 2.0 ** -60,
             2.0 ** -25, 3 * 2.0 ** -26, 2.0 ** -14 - 2.0 ** -25 + 2.0 ** -50,
             65504.0, 65519.99, 65520.0, -7e4)


def f16f64_edges(torch, lk, dev, card):
    """The one-rounding rule on the card: F16_EDGES through each of the
    four float16-table float64 kernels on a table of ones at L 1 (each
    output one product, no sum), bit for bit equal to numpy's float16
    rounding of each value (inf past 65519.99) and to the plain version
    (on the CPU) where that is finite; the float32 route would give 1.0
    for 1 + 2^-11 + 2^-40."""
    f64 = torch.float64
    with np.errstate(over="ignore"):
        want = np.asarray(F16_EDGES).astype(np.float16).astype(np.float64)
    C = len(F16_EDGES)
    lam = torch.ones((1, 1, 1), dtype=torch.float16, device=dev)
    e = torch.tensor(F16_EDGES, dtype=f64, device=dev)
    x, g = e.reshape(1, C, 1), e.reshape(1, 1, C)
    fin = np.isfinite(want)
    for name, args, b in (("legendre_synth_tri", (), x),
                          ("legendre_adj_tri", (), g),
                          ("legendre_synth_par", (1,), x),
                          ("legendre_adj_par", (), g)):
        out = getattr(lk, name)(lam, b, *args).reshape(-1).cpu().numpy()
        ref = getattr(lk, name + "_plain")(lam.cpu(), b.cpu(), *args)
        ref = ref.reshape(-1).numpy()
        check(np.array_equal(out.view(np.int64), want.view(np.int64))
              and np.array_equal(ref[fin], want[fin]),
              f"{name}_f16f64 on float16 edge values: {out.tolist()}, "
              f"numpy {want.tolist()}, plain {ref.tolist()}")
    print(f"f16f64 kernels on {C} float16 edge values (ties, subnormals, "
          f"65504 and past it): bit for bit numpy's one rounding, "
          f"1 + 2^-11 + 2^-40 -> {want[0]!r} [{card}]", flush=True)


def narrow_datasets(torch, dev):
    """The CG phase's float64 band dataset (GL 513 x 1026, cut over 65
    rings, flagship.dataset's seed) with float64 tables and with each
    narrow table dtype, each built as a user would:
    flagship.dataset(..., sht=flagship.flagship_sht(..., dtype=float64,
    table_dtype=...)).  Returns ({table dtype name: cut model}, the sky's
    per-ell D_ell (2, lmax + 1))."""
    from gibbssampler_tpu_torch import flagship
    f64 = torch.float64
    models = {}
    for tdn in ("float64",) + tuple(NARROW_SFX):
        t0 = time.time()
        sht = flagship.flagship_sht("gl", LMAX, dev, f64, tdn)
        m, dls, _ = flagship.dataset("gl", "band", LMAX, dev, f64, sht=sht)
        td = getattr(torch, tdn)
        check(m.cut_sht.nrings == CUT_RINGS and m.cut_sht.dtype == f64
              and m.sht.table_dtype == m.cut_sht.table_dtype == td
              and m.cut_sht.lam_p2.dtype == td,
              f"narrow CG dataset {tdn}: the float64 cut decomposition on "
              f"{tdn} tables")
        torch.cuda.synchronize()
        print(f"narrow CG dataset, float64 compute on {tdn} tables: built in "
              f"{time.time() - t0:.1f} s; table bytes full grid "
              f"{table_bytes(m.sht) / 1e9:.3f} GB, cut "
              f"{table_bytes(m.cut_sht) / 1e9:.4f} GB", flush=True)
        models[tdn] = m
    return models, dls


def phase_narrow_transforms(torch, lk, dev, card, models):
    """(b) The spin-2 transforms with narrow tables under float64 compute
    against the float64-table ones at CG_CHAINS chains: the band dataset's
    cut transform (65 rings; synthesis and adjoint), the full GL grid
    ring-split and HEALPix nside 256 (padded layout, dense; synthesis,
    adjoint and analysis): max|err|/max|ref| (<= NARROW_TRANSFORM_TOL), ms
    per transform (3 calls, CUDA events, beside the float64-table one) and
    table bytes.  The counts are set to 0 before and read after; returns
    {table dtype name: narrow_counts}."""
    from gibbssampler_tpu_torch import flagship
    from gibbssampler_tpu_torch.harmonics import ell_mask_state, nstate
    gen = torch.Generator(device=dev).manual_seed(32)
    f64 = torch.float64
    lk.reset_launch_counts()
    for label, mk in (
            ("GL band cut", lambda tdn: models[tdn].cut_sht),
            ("GL full grid ring-split", lambda tdn: flagship.flagship_sht(
                "gl", LMAX, dev, f64, tdn, ring_split=True)),
            ("HEALPix nside 256", lambda tdn: flagship.flagship_sht(
                "healpix", LMAX, dev, f64, tdn))):
        ref = mk("float64")
        shp = (ref.npix_layout,) if hasattr(ref, "geo") else (ref.nrings,
                                                             ref.nphi)
        m2 = torch.as_tensor(ell_mask_state(LMAX, 2), dtype=f64, device=dev)
        e, b = (torch.randn((CG_CHAINS, nstate(LMAX)), generator=gen,
                            dtype=f64, device=dev) * m2 for _ in range(2))
        q, u = (torch.randn((CG_CHAINS,) + shp, generator=gen, dtype=f64,
                            device=dev) for _ in range(2))
        meths = [("synthesis", "synthesis_spin2_state", (e, b)),
                 ("adjoint", "adjoint_synthesis_spin2_state", (q, u))]
        if label != "GL band cut":
            meths.append(("analysis", "analysis_spin2_state", (q, u)))
        for tdn in NARROW_SFX:
            t0 = time.time()
            tr = mk(tdn)
            torch.cuda.synchronize()
            built = time.time() - t0
            td = getattr(torch, tdn)
            check(tr.table_dtype == td and tr.dtype == f64 and all(
                t is None or t.dtype == td
                for t in (tr.lam0, tr.lam_p2, tr.lam_m2, tr.lam_w, tr.lam_x)),
                f"narrow {label}: tables not in {tdn}")
            tol = NARROW_TRANSFORM_TOL[tdn]
            for what, meth, args in meths:
                want = getattr(ref, meth)(*args)
                got = getattr(tr, meth)(*args)
                torch.cuda.synchronize()
                err = max(float((a - r).abs().max() / r.abs().max())
                          for a, r in zip(got, want))
                check(err <= tol, f"narrow {label} {tdn} tables spin-2 "
                      f"{what}: against float64 tables {err:.3g} > {tol}")
                ms_f = time_ms(torch, lambda: getattr(ref, meth)(*args), 3)
                ms_n = time_ms(torch, lambda: getattr(tr, meth)(*args), 3)
                print(f"narrow {label} lmax {LMAX} spin-2 {what}, float64 "
                      f"compute on {tdn} tables, {CG_CHAINS} chains: "
                      f"max|err|/max|ref| against float64 tables {err:.2e} "
                      f"(<= {tol}); {ms_n:.3f} ms per transform, float64 "
                      f"tables {ms_f:.3f} ms [{card}]", flush=True)
                del want, got
            print(f"narrow {label} {tdn} tables: table bytes "
                  f"{table_bytes(tr) / 1e9:.4f} GB (float64 tables "
                  f"{table_bytes(ref) / 1e9:.4f} GB), built in {built:.1f} s",
                  flush=True)
            del tr
        del ref, e, b, q, u
        torch.cuda.empty_cache()
    n = {tdn: narrow_counts(torch, lk, getattr(torch, tdn))
         for tdn in NARROW_SFX}
    check(all(all(v) for v in n.values()), f"narrow transforms: launches "
          f"{n}; every narrow kernel must run")
    return n


def phase_narrow_cg(torch, lk, dev, card, models, dls):
    """(c) The CG phase's cg_cr at full width on the band dataset with
    float64, float32, bfloat16 and float16 tables under float64 compute
    (CG_CHAINS chains, the prior of the true spectrum in unit bins, one
    noise pool seed; each model warmed up by a 2-iteration solve): tol
    NARROW_CG_TOL, the 16-bit tables capped at each of NARROW_BF16_CAPS
    iterations (one solve each: the true residual's path); per chain the
    iterations, whether it stopped below the cap, and the true ||b - Qx||
    / ||b|| recomputed with the solve's own operator and with the
    float64-table one; ms per solve and per iteration; 2 + 2 launches per
    iteration of the table dtype's kernels and none of another.  Every
    float32-table and float64-table chain must converge (true residual <=
    2 tol); each 16-bit table's floor (the least true residual over the
    caps) is printed, its first cap's solve must be finite, and for the
    float16 tables each solve prints the largest |value| at each float16
    rounding site (f16_sites): a diverging solve's batch can leave
    float16's range.  Each solve's counts are set to 0 before and read
    after; returns {table dtype name: narrow_counts} summed over the
    narrow solves."""
    from gibbssampler_tpu_torch.samplers import cr as cr_mod
    from gibbssampler_tpu_torch.schemes import CenteredGibbs
    f64 = torch.float64
    ubins = np.arange(2, LMAX + 2)
    out, base = {}, {}
    m64 = models["float64"]
    for tdn, m in models.items():
        scheme = CenteredGibbs(m, [ubins, ubins], cr_method="cg",
                               cr_options={"cg_maxiter": CG_MAXITER})
        var = scheme.var_cls(tuple(
            torch.as_tensor(d[2:], dtype=f64, device=dev)
            .expand(CG_CHAINS, -1) for d in dls))
        inv = torch.where(var > 0, 1.0 / torch.where(var > 0, var, 1.0), 0.0)
        bt = scheme.bt_ninv_d
        pool = scheme.draw_noise_pool(
            CG_CHAINS, torch.Generator(device=dev).manual_seed(7))
        cr_mod.cg_cr(m, var, bt, tol=NARROW_CG_TOL, maxiter=2, noise=pool)
        b = cr_mod.fluctuated_rhs(m, var, bt, noise=pool)
        floor = []
        for cap in (NARROW_BF16_CAPS if tdn in NARROW_CAPPED
                    else (CG_MAXITER,)):
            lk.reset_launch_counts()
            solve = (lambda: cr_mod.cg_cr(
                m, var, bt, tol=NARROW_CG_TOL, maxiter=cap, noise=pool))
            (x, info), ms = cuda_ms(torch, solve)
            nc = {t: narrow_counts(torch, lk, getattr(torch, t))
                  for t in NARROW_SFX}
            if tdn == "float64":
                d, other = counts(lk)[2:], counts(lk)[:2] + tuple(
                    sum(v) for v in nc.values())
            else:
                out[tdn] = tuple(a + c for a, c in zip(
                    out.get(tdn, (0, 0, 0, 0)), nc[tdn]))
                d, other = nc[tdn][:2], counts(lk) + nc[tdn][2:] + tuple(
                    sum(v) for t, v in nc.items() if t != tdn)
            its = info.extra.cpu().numpy().astype(np.int64)
            n = int(its.max())
            check(tuple(d) == (2 * n, 2 + 2 * n) and sum(other) == 0,
                  f"narrow cg_cr {tdn} tables: launches {d} (expected (2 x "
                  f"{n}, 2 + 2 x {n})), other kernels' {other} (expected "
                  f"none)")
            res = []
            for op in (m, m64):
                r = b - op.q_apply_cut(x, inv)
                res.append((r.norm(dim=(-2, -1)) / b.norm(dim=(-2, -1)))
                           .cpu().numpy())
            conv = its < cap
            finite = bool(torch.isfinite(x).all()) and np.isfinite(
                res[0]).all()
            # a 16-bit table's solve, capped: the floor (its first cap)
            # must be finite; a later one may leave float16's range
            check(finite or (tdn in NARROW_CAPPED and floor),
                  f"narrow cg_cr {tdn} tables, cap {cap}: non-finite state "
                  f"or residual")
            if tdn == "float16":
                # the same solve again, its float16 sites recorded (after
                # the counts are read)
                peaks = f16_sites(torch, solve)[1]
                print(f"narrow cg_cr float16 tables, cap {cap}: finite "
                      f"{finite}; the largest |value| at each float16 "
                      f"rounding site during the solve "
                      f"{ {k: f'{v:.4g}' for k, v in peaks.items()} } "
                      f"(float16's largest finite value {F16_MAX:g}) "
                      f"[{card}]", flush=True)
            if tdn not in NARROW_CAPPED:
                check(conv.all() and res[0].max() <= 2 * NARROW_CG_TOL,
                      f"narrow cg_cr {tdn} tables: converged "
                      f"{conv.tolist()}, true residual max "
                      f"{res[0].max():.3g} > 2 x {NARROW_CG_TOL}")
            floor.append(np.where(np.isfinite(res[0]), res[0], np.inf))
            base.setdefault("ms_iter", ms / n)
            print(f"narrow cg_cr float64 compute on {tdn} tables, tol "
                  f"{NARROW_CG_TOL:g}, cap {cap}: per chain iterations "
                  f"{its.tolist()}, converged {conv.astype(int).tolist()}, "
                  f"true residual {[f'{v:.3g}' for v in res[0]]} "
                  f"(float64-table operator "
                  f"{[f'{v:.3g}' for v in res[1]]}); {ms:.1f} ms per solve, "
                  f"{ms / n:.3f} ms per iteration (float64 tables "
                  f"{base['ms_iter']:.3f}); launches synthesis {d[0]}, "
                  f"adjoint {d[1]} [{card}]", flush=True)
        if tdn in NARROW_CAPPED:
            best = np.min(floor, axis=0)
            print(f"narrow cg_cr {tdn} tables: the floor, each chain's "
                  f"least true ||b - Qx||/||b|| over the caps "
                  f"{NARROW_BF16_CAPS}: {[f'{v:.3g}' for v in best]} (at cap "
                  f"{[NARROW_BF16_CAPS[k] for k in np.argmin(floor, axis=0)]})"
                  f"; none at tol {NARROW_CG_TOL:g} [{card}]", flush=True)
        del scheme, x, b, pool, var, inv
    return out


def phase_narrow(torch, lk, dev, card):
    """The narrow-table phase: (a) the kernels, (b) the transforms and (c)
    the CG solves (phase_narrow_*).  Returns ((a)'s records, {table dtype
    name: the launches of (b) and (c)})."""
    t0 = time.time()
    recs = phase_narrow_kernels(torch, lk, dev, card)
    models, dls = narrow_datasets(torch, dev)
    n_b = phase_narrow_transforms(torch, lk, dev, card, models)
    n_c = phase_narrow_cg(torch, lk, dev, card, models, dls)
    del models
    torch.cuda.empty_cache()
    launches = {tdn: [a + b for a, b in zip(n_b[tdn], n_c[tdn])]
                for tdn in NARROW_SFX}
    print(f"narrow phase: {time.time() - t0:.1f} s; launches on its paths "
          f"(dense synth, adj, parity synth, adj) {launches} [{card}]",
          flush=True)
    return recs, launches


# ---------------------------------------------------------------------------
# the remaining table pairs: float16 tables under float32 compute
# (csrc/legendre_tri_f16.cu: the bfloat16 source in its float16 mode) and
# float64 tables under float32 compute (csrc/legendre_tri_narrow_f64.cu,
# f64f32); float16 tables under float64 compute run in the narrow phase
# ---------------------------------------------------------------------------

# the pairs: entry-point suffix -> (table dtype name, kernel source, the
# launch counter, the pipe of the bound)
PAIR_KERNELS = {"f16": ("float16", "legendre_tri_f16.cu", "launches_f16",
                        BF16_FLOPS_PER_S),
                "f64f32": ("float64", "legendre_tri_narrow_f64.cu",
                           "launches_wide", FP64_FLOPS_PER_S)}
# against the plain version, of max|ref|: float32 sums of the same exact
# products in other orders (f16: BF16_TOL, the same source's; a float16
# product carries 22 significand bits to a bfloat16 one's 16, and its sums
# in another order differ more: 1.57e-6 max|ref| at (65, 256) on the card);
# float64 sums of the same products, each rounded once to float32 (f64f32:
# one float32 ulp)
PAIR_TOL = {"f16": BF16_TOL, "f64f32": 2.0 ** -23}
# (nr, C): the band's cut rings and the GL grid at the flagship's 128
# chains (x Re/Im); the parity pair at the grid's 257 north rings
PAIR_DENSE_SHAPES = ((CUT_RINGS, 2 * NCHAINS), (LMAX + 1, 2 * NCHAINS))
PAIR_PAR_SHAPES = ((LMAX + 1, 2 * NCHAINS),)
# the transforms against float32-table ones (max|err| / max|ref|): the
# table's operator error (float16), the float32 one's (float64 tables)
PAIR_TRANSFORM_TOL = {"float16": 2e-2, "float64": 1e-5}
PAIR_ITERS = (5, 20)
F16_MAX = 65504.0


def work_pair(name, L, nr, C, itemsize, rows=None):
    """(FLOPs, bytes) of one call on a table of ``itemsize`` bytes with a
    float32 batch: the table's triangle read once, the batch read once and
    the output written once in 4 bytes; a parity kernel (``name`` ending in
    "_par") on the half table of ceil(nr / 2) rings; ``rows`` the degree
    orders of a slab (all L by default)."""
    return work_narrow(name, L, nr, C, itemsize, rows, batch_itemsize=4)


def pair_counts(lk, sfx):
    """(dense synthesis, dense adjoint, parity synthesis, parity adjoint)
    launches of the ``sfx`` kernels since the counts were set to 0."""
    attr = PAIR_KERNELS[sfx][2]
    return tuple(getattr(f, attr) for f in (
        lk.legendre_synth_tri, lk.legendre_adj_tri, lk.legendre_synth_par,
        lk.legendre_adj_par))


def pair_one(torch, lk, sfx, name, lam, b, args, out_shape, lam32, label,
             card, library, rows=None):
    """One kernel call of the pair ``sfx`` against its plain version (<=
    PAIR_TOL max|ref|), its output given NaN-filled memory; timed beside
    its plain version (back to back), the float32 kernel on the float32
    table ``lam32`` and ``library`` (one torch.einsum on the upcast or
    widened operands), the kernels and the einsum on the device (graph_ms).
    Returns the record."""
    kern, plain = getattr(lk, name), getattr(lk, name + "_plain")
    torch.full(out_shape, float("nan"), dtype=torch.float32,
               device=lam.device)
    out = kern(lam, b, *args)
    ref = plain(lam, b, *args)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    tol = PAIR_TOL[sfx]
    check(bool(torch.isfinite(out).all()) and err <= tol * scale,
          f"{name}_{sfx} {label}: max|err| {err} > {tol} * {scale}")
    synth = name.startswith("legendre_synth")
    L, nr = lam.shape[1], out_shape[1] if synth else b.shape[1]
    C = out_shape[2] if synth else out_shape[0]
    reps = 5 if nr > CUT_RINGS else 20
    p1 = time_ms(torch, lambda: plain(lam, b, *args), reps)
    k1 = graph_ms(torch, lambda: kern(lam, b, *args), reps)
    f32 = graph_ms(torch, lambda: kern(lam32, b, *args), reps)
    k2 = graph_ms(torch, lambda: kern(lam, b, *args), reps)
    p2 = time_ms(torch, lambda: plain(lam, b, *args), reps)
    lib = graph_ms(torch, library, reps)
    ms, pms = 0.5 * (k1 + k2), 0.5 * (p1 + p2)
    flops, nbytes = work_pair(name, L, nr, C, lam.element_size(), rows)
    bound_ms, bound_by = bound(flops, nbytes, PAIR_KERNELS[sfx][3])
    print(f"pairs {name}_{sfx} {str(lam.dtype)[6:]} table, float32 batch, "
          f"{label}: max|err|/max|ref| {err / scale:.2e} (<= {tol:.3g}); "
          f"kernel {ms:.4f} ms, plain {pms:.4f} ms, float32 kernel on the "
          f"float32 table {f32:.4f} ms, torch.einsum on the "
          f"{'upcast' if sfx == 'f16' else 'widened'} operands {lib:.4f} ms; "
          f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of it "
          f"reached; {flops / ms * 1e-9:.2f} TFLOP/s, "
          f"{nbytes / ms * 1e-6:.0f} GB/s [{card}]", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib,
            "f32_kernel_ms": f32}


def phase_pair_kernels(torch, lk, dev, card):
    """(a) The four kernels of each pair (PAIR_KERNELS) against their plain
    versions on the card at L 513: the dense pair at PAIR_DENSE_SHAPES, the
    parity pair at PAIR_PAR_SHAPES (flip and not), in the main path's
    layouts (the parity adjoint also with g of unit stride on c, flip not),
    and slab 0 of the two-way split of each pair at the first
    shape; each timed beside its plain version, the float32 kernel on the
    float32 table and one torch.einsum on the upcast (float16: the table
    in float32 and the batch rounded to float16, in float32) or widened
    (float64 table: the batch in float64) operands, the parity pair's on
    the mirrored table, with the bound of work_pair (bytes over 3.35 TB/s
    or FLOPs over the pipe the kernel runs on: 989 TFLOP/s for the float16
    tensor cores, 67 for DMMA).  Returns {kernel name with its suffix:
    {shape key: record}}."""
    from gibbssampler_tpu_torch.parallel import m_rows
    gen = torch.Generator(device=dev).manual_seed(41)
    f32, L = torch.float32, LMAX + 1
    recs = {}
    rows = m_rows(L, 2)[0]
    ms0 = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    idx = ms0.long()
    for sfx, (tdn, _src, _cnt, _pipe) in PAIR_KERNELS.items():
        td = getattr(torch, tdn)
        wide = td == torch.float64
        # the library's operands: the einsum's dtype, and the batch as the
        # kernel contracts it (rounded to float16, or widened)
        ed = torch.float64 if wide else f32
        lift = ((lambda t: t.double()) if wide
                else (lambda t: t.to(td).float()))
        into = {name: recs.setdefault(f"{name}_{sfx}", {})
                for name in NARROW_KERNELS}

        def one(name, key, lam, b, args, out_shape, lam32, library,
                rows=None):
            into[name][key] = pair_one(torch, lk, sfx, name, lam, b, args,
                                       out_shape, lam32, key, card, library,
                                       rows)

        for k, (nr, C) in enumerate(PAIR_DENSE_SHAPES):
            if wide:
                plan = lk.narrow_plan(nr, C)["f64f32"]
                print(f"pairs f64f32 dense plans at nr {nr}, C {C}: "
                      f"synthesis {plan['synth']}, adjoint {plan['adj']} "
                      f"[{card}]", flush=True)
            lam = tri_table(torch, L, nr, torch.float64, dev, gen).to(td)
            l32 = lam.float()
            x = x_view(torch.randn((L, C, L), generator=gen, device=dev))
            g = g_view(torch.randn((L, nr, C), generator=gen, device=dev))
            up, rx, rg = lam.to(ed), lift(x), lift(g)
            key = f"{nr} C{C}"
            one("legendre_synth_tri", key, lam, x, (), (L, nr, C), l32,
                lambda: torch.einsum("mlr,mcl->mrc", up, rx))
            one("legendre_adj_tri", key, lam, g, (), (C, L, L), l32,
                lambda: torch.einsum("mlr,mrc->mcl", up, rg))
            if k == 0:
                ls, l32s, us = (t.index_select(0, idx).contiguous()
                                for t in (lam, l32, up))
                xs, gs = x.index_select(0, idx), g_view(g.index_select(0, idx))
                rxs, rgs = lift(xs), lift(gs)
                key = f"{nr} C{C} slab 0 of 2"
                one("legendre_synth_tri", key, ls, xs, (ms0,),
                    (len(rows), nr, C), l32s,
                    lambda: torch.einsum("mlr,mcl->mrc", us, rxs), rows)
                one("legendre_adj_tri", key, ls, gs, (ms0,),
                    (C, len(rows), L), l32s,
                    lambda: torch.einsum("mlr,mrc->mcl", us, rgs), rows)
                del ls, l32s, us, xs, gs, rxs, rgs
            del lam, l32, x, g, up, rx, rg
        for k, (nr, C) in enumerate(PAIR_PAR_SHAPES):
            lam = tri_table(torch, L, (nr + 1) // 2, torch.float64, dev,
                            gen).to(td)
            l32 = lam.float()
            x = x_view(torch.randn((L, C, L), generator=gen, device=dev))
            g = g_view(torch.randn((L, nr, C), generator=gen, device=dev))
            rx, rg = lift(x), lift(g)
            if wide:
                plan = lk.narrow_plan(nr, C)["f64f32"]
                print(f"pairs f64f32 parity plans at nr {nr}, C {C}: "
                      f"synthesis {plan['synth_par']}, adjoint "
                      f"{plan['adj_par']} [{card}]", flush=True)
            for flip in (True, False):
                key = f"{nr} C{C}" + (" flip" if flip else "")
                full = mirrored_table(torch, lam.to(ed), nr, flip)
                one("legendre_synth_par", key, lam, x, (nr, flip),
                    (L, nr, C), l32,
                    lambda: torch.einsum("mlr,mcl->mrc", full, rx))
                one("legendre_adj_par", key, lam, g, (flip,), (C, L, L),
                    l32, lambda: torch.einsum("mlr,mrc->mcl", full, rg))
                if not flip:  # g with unit stride on c (the views': on r)
                    gc = g.contiguous()
                    one("legendre_adj_par", key + " unit-c g", lam, gc,
                        (flip,), (C, L, L), l32,
                        lambda: torch.einsum("mlr,mrc->mcl", full, rg))
                    del gc
                del full
            if k == 0:
                ls, l32s = (t.index_select(0, idx).contiguous()
                            for t in (lam, l32))
                xs, gs = x.index_select(0, idx), g_view(g.index_select(0, idx))
                rxs, rgs = lift(xs), lift(gs)
                full = mirrored_table(torch, ls.to(ed), nr, rows=rows)
                key = f"{nr} C{C} slab 0 of 2"
                one("legendre_synth_par", key, ls, xs, (nr, False, ms0),
                    (len(rows), nr, C), l32s,
                    lambda: torch.einsum("mlr,mcl->mrc", full, rxs), rows)
                one("legendre_adj_par", key, ls, gs, (False, ms0),
                    (C, len(rows), L), l32s,
                    lambda: torch.einsum("mlr,mrc->mcl", full, rgs), rows)
                del ls, l32s, xs, gs, rxs, rgs, full
            del lam, l32, x, g, rx, rg
        torch.cuda.empty_cache()
    return recs


def phase_pair_transforms(torch, lk, dev, card):
    """(b) The spin-2 transforms at full width with float16 tables and with
    float64 tables, both under float32 compute, against float32-table ones
    at NCHAINS chains: GL lmax 512 dense and ring-split, HEALPix nside 256
    (padded layout) dense; synthesis, adjoint and analysis, max|err|/max|ref|
    (<= PAIR_TRANSFORM_TOL), ms per transform (3 calls, CUDA events, beside
    the float32 one) and table bytes.  The counts are set to 0 before and
    read after; returns {suffix: pair_counts}."""
    from gibbssampler_tpu_torch.harmonics import ell_mask_state, nstate
    from gibbssampler_tpu_torch.sht import make_healpix_sht, make_sht
    gen = torch.Generator(device=dev).manual_seed(42)
    f32 = torch.float32
    kw = dict(dtype=f32, spin2=True, device=dev)
    lk.reset_launch_counts()
    for label, mk in (
            ("GL dense", lambda td: make_sht(LMAX, table_dtype=td, **kw)),
            ("GL ring-split", lambda td: make_sht(LMAX, table_dtype=td,
                                                  ring_split=True, **kw)),
            ("HEALPix dense", lambda td: make_healpix_sht(
                NSIDE, LMAX, layout="padded", table_dtype=td, **kw))):
        ref = mk(None)
        shp = (ref.npix_layout,) if hasattr(ref, "geo") else (ref.nrings,
                                                             ref.nphi)
        m2 = torch.as_tensor(ell_mask_state(LMAX, 2), dtype=f32, device=dev)
        e, b = (torch.randn((NCHAINS, nstate(LMAX)), generator=gen,
                            dtype=f32, device=dev) * m2 for _ in range(2))
        q, u = (torch.randn((NCHAINS,) + shp, generator=gen, dtype=f32,
                            device=dev) for _ in range(2))
        for sfx, (tdn, *_r) in PAIR_KERNELS.items():
            t0 = time.time()
            tr = mk(tdn)
            torch.cuda.synchronize()
            built = time.time() - t0
            td = getattr(torch, tdn)
            check(tr.table_dtype == td and tr.dtype == f32 and all(
                t is None or t.dtype == td
                for t in (tr.lam0, tr.lam_p2, tr.lam_m2, tr.lam_w, tr.lam_x)),
                f"pairs {label}: tables not in {tdn}")
            tol = PAIR_TRANSFORM_TOL[tdn]
            for what, meth, args in (
                    ("synthesis", "synthesis_spin2_state", (e, b)),
                    ("adjoint", "adjoint_synthesis_spin2_state", (q, u)),
                    ("analysis", "analysis_spin2_state", (q, u))):
                want = getattr(ref, meth)(*args)
                got = getattr(tr, meth)(*args)
                torch.cuda.synchronize()
                err = max(float((a - r).abs().max() / r.abs().max())
                          for a, r in zip(got, want))
                check(err <= tol and all(bool(torch.isfinite(a).all())
                                         for a in got),
                      f"pairs {label} {tdn} tables spin-2 {what}: against "
                      f"float32 tables {err:.3g} > {tol}")
                ms_f = time_ms(torch, lambda: getattr(ref, meth)(*args), 3)
                ms_n = time_ms(torch, lambda: getattr(tr, meth)(*args), 3)
                print(f"pairs {label} lmax {LMAX} spin-2 {what}, float32 "
                      f"compute on {tdn} tables, {NCHAINS} chains: "
                      f"max|err|/max|ref| against float32 tables {err:.2e} "
                      f"(<= {tol}); {ms_n:.3f} ms per transform, float32 "
                      f"tables {ms_f:.3f} ms [{card}]", flush=True)
                del want, got
            print(f"pairs {label} {tdn} tables: table bytes "
                  f"{table_bytes(tr) / 1e9:.4f} GB (float32 tables "
                  f"{table_bytes(ref) / 1e9:.4f} GB), built in {built:.1f} s",
                  flush=True)
            del tr
            torch.cuda.empty_cache()
        del ref, e, b, q, u
        torch.cuda.empty_cache()
    n = {sfx: pair_counts(lk, sfx) for sfx in PAIR_KERNELS}
    check(all(all(v) for v in n.values()), f"pairs transforms: launches "
          f"{n}; every kernel of each pair must run")
    return n


def f16_sites(torch, fn):
    """``fn()`` and the largest |value| at each float16 rounding site while
    it runs: the batches of the Legendre kernels on float16 tables (each
    rounded to float16 in the kernel) and the operands of ``_round_td``
    of float16-table transforms (the azimuthal stages'), recorded by
    wrappers around both.  Returns (fn's result, {site: max|value|})."""
    from gibbssampler_tpu_torch.sht import lcore
    peaks = {}

    def note(site, t):
        if t.numel():
            v = float(t.detach().abs().max())
            peaks[site] = max(peaks.get(site, 0.0), v)

    # the transforms call the wrappers through sht.lcore's names (the
    # wrappers count their launches on themselves: legendre_kernels' own
    # names stay as they are)
    wraps = {}
    for name in NARROW_KERNELS:
        kern = getattr(lcore, name)

        def wrapped(lam, b, *a, _kern=kern, _name=name, **k):
            if lam.dtype == torch.float16:
                note(f"{_name} batch", b)
            return _kern(lam, b, *a, **k)
        wraps[name] = kern
        setattr(lcore, name, wrapped)
    orig_rnd = lcore.LegendreCore._round_td

    def rnd(self, t):
        if self.table_dtype == torch.float16:
            note("azimuthal operand (_round_td)", t)
        return orig_rnd(self, t)
    lcore.LegendreCore._round_td = rnd
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        lcore.LegendreCore._round_td = orig_rnd
        for name, kern in wraps.items():
            setattr(lcore, name, kern)
    return res, peaks


def phase_pair_slices(torch, lk, dev, card):
    """(c) bench.py's ASIS band slice (flagship.build, the tuned record,
    GL 513 x 1026 cut over 65 rings, NCHAINS chains, float32 compute) on
    float64 tables (BENCH_TABLE_DTYPE=float64 with x64 semantics), cut in
    depth to PAIR_ITERS (warm-up, timed), through phase_bf16_slice:
    ms/iter, MH ms/iter, acceptances in ACCEPT_WINDOW, exactly
    ASIS_PER_ITER f64f32 launches per timed iteration and no other
    Legendre launch, peak memory; then the float16-table slice
    (BENCH_TABLE_DTYPE=float16): the largest |value| at each float16
    rounding site over its start and one iteration (f16_sites); if every
    one is
    below 65504 the slice runs as the float64-table one with finite
    outputs required, else it is not run and the overflow is printed.
    Returns {suffix: pair_counts of the slice, or None}."""
    from gibbssampler_tpu_torch import flagship
    out = {"f64f32": phase_bf16_slice(
        torch, lk, dev, card, iters=PAIR_ITERS, td="float64", sfx="f64f32",
        counter=lambda lk: pair_counts(lk, "f64f32"))}
    scheme, dl0 = flagship.build("gl", "band", table_dtype="float16",
                                 device=dev, lmax=LMAX)
    gen = torch.Generator(device=dev).manual_seed(3)
    _, peaks = f16_sites(torch, lambda: scheme.step(
        flagship.start_state(scheme, dl0, NCHAINS, gen), gen=gen))
    top = max(peaks.values())
    print(f"pairs float16 ASIS band: the largest |value| at each float16 "
          f"rounding site over one iteration: "
          f"{ {k: f'{v:.4g}' for k, v in peaks.items()} } (float16's "
          f"largest finite value {F16_MAX:g}) [{card}]", flush=True)
    del scheme
    torch.cuda.empty_cache()
    if top >= F16_MAX:
        print(f"pairs float16 ASIS band slice not run: a float16 rounding "
              f"site reaches {top:.4g} >= {F16_MAX:g} and would round to "
              f"inf, in the JAX package as in the port (a shared "
              f"limitation of float16 tables on this configuration) "
              f"[{card}]", flush=True)
        out["f16"] = None
    else:
        out["f16"] = phase_bf16_slice(
            torch, lk, dev, card, iters=PAIR_ITERS, td="float16", sfx="f16",
            counter=lambda lk: pair_counts(lk, "f16"))
    return out


def phase_pairs(torch, lk, dev, card):
    """The remaining table pairs' phase: (a) the kernels, (b) the
    transforms, (c) the slices (phase_pair_*).  Returns ((a)'s records,
    {suffix: the launches of (b) and (c)})."""
    t0 = time.time()
    recs = phase_pair_kernels(torch, lk, dev, card)
    n_b = phase_pair_transforms(torch, lk, dev, card)
    n_c = phase_pair_slices(torch, lk, dev, card)
    launches = {sfx: [a + b for a, b in zip(n_b[sfx], n_c[sfx] or (0,) * 4)]
                for sfx in PAIR_KERNELS}
    print(f"pairs phase: {time.time() - t0:.1f} s; launches on its paths "
          f"(dense synth, adj, parity synth, adj) {launches} [{card}]",
          flush=True)
    return recs, launches


def main():
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # no table cache but the options phase's own (in a temporary
    # directory): the lmax-512 tables are GBs, and the native engine builds
    # them faster than they are written; spawned processes inherit this
    os.environ["GIBBSSAMPLER_TORCH_TABLE_CACHE"] = "0"
    from gibbssampler_tpu_torch.sht import legendre_kernels as lk

    from gibbssampler_tpu_torch import flagship

    phase_build(lk, card)
    if "--f64-parts" in sys.argv[1:]:
        print(json.dumps({"f64_parts_ms": phase_f64_parts(torch, lk, dev,
                                                          card)}), flush=True)
        return 0
    rec, rec64 = phase_kernels(torch, lk, dev, card)
    phase_slab_kernels(torch, lk, dev, card, rec, rec64)
    hp_mask = flagship.healpix_planckish_mask(NSIDE)
    sht = phase_sht(torch, dev, hp_mask)
    phase_small_steps(torch, dev)
    profile = "--profile" in sys.argv[1:]
    launches, lr_err = {}, {}
    model, dls = phase_dataset(torch, sht)
    launches["centered"] = phase_centered_slice(torch, lk, model, dls, dev,
                                                card)
    # the blocked-MH engines' checks and sweeps beside the main path,
    # counted into tally (and phase 3's checks at their new shapes)
    tally = {"launches": [0] * 4, "shapes": {}}
    launches["ASIS GL band"], scheme, dl0, state = phase_asis_slice(
        torch, lk, model, dls, dev, card, profile, "gl", "band")
    lr_err["GL band"] = phase_mh_sweep(
        torch, scheme, state, dev, card, engines=[(False, "phi"),
                                                  ("m", "coef")],
        no_singles=True, tally=tally, lk=lk)
    launches["ASIS GL band overrelax"] = phase_asis_slice(
        torch, lk, model, dls, dev, card, profile, "gl", "band",
        cr="overrelax", per_iter=OVERRELAX_PER_ITER)[0]
    launches["adaptation"] = phase_adapt(torch, lk, scheme, dl0, dev, card)
    band = (scheme, state)
    del scheme, state
    launches["PNCP GL band"], scheme, state = phase_pncp_slice(
        torch, lk, model, dls, dev, card, profile)
    phase_pncp_sweep(torch, scheme, state, dev, card)
    del scheme, state
    # the phi slice (bench.py's ASIS band configuration with
    # mh_fast="phi"), then one float32 coefficient-engine sweep
    launches["ASIS GL band phi"] = phase_asis_slice(
        torch, lk, model, dls, dev, card, profile, "gl", "band",
        mh_fast="phi", n_timed=PHI_TIMED)[0]
    label = "ASIS gl band aux_mala"
    print(f"MH step ms/iter at 128 chains: phi engine "
          f"{MH_MS[label + ' phi']:.2f}, table engine {MH_MS[label]:.2f} "
          f"(phase 5, this call) [{card}]", flush=True)
    phase_coef_sweep(torch, lk, tally, *band, dev, card)
    # the parallel layer on a fresh flagship ASIS band scheme (phase_adapt
    # swapped adapted scales into phase 5's)
    par_launches = phase_parallel(torch, lk, model, dls, dev, card)
    del model, band
    torch.cuda.empty_cache()
    cg_launches = phase_cg(torch, lk, dev, card, profile)
    launches["CG"] = cg_launches[:2]
    torch.cuda.empty_cache()
    model, dls = phase_planckish_dataset(torch, sht)
    launches["ASIS GL planckish"], scheme, _, state = phase_asis_slice(
        torch, lk, model, dls, dev, card, profile, "gl", "planckish",
        per_iter=PLANCKISH_PER_ITER)
    lr_err["GL planckish"] = phase_mh_sweep(
        torch, scheme, state, dev, card, label=" planckish",
        engines=[(False, "phi"), ("m", "phi")], tally=tally, lk=lk)
    phase_nosplit_sweep(torch, lk, tally, scheme, state, dev, card)
    del model, scheme, state
    torch.cuda.empty_cache()
    model, dls = phase_healpix_dataset(torch, dev)
    launches["ASIS HEALPix planckish"], scheme, _, state = phase_asis_slice(
        torch, lk, model, dls, dev, card, profile, "healpix", "planckish",
        per_iter=HEALPIX_PER_ITER)
    lr_err["HEALPix planckish"] = phase_mh_sweep(
        torch, scheme, state, dev, card, label=" HEALPix planckish",
        engines=[(False, "phi")], tally=tally, lk=lk)
    hsht = model.sht
    del model, scheme, state
    torch.cuda.empty_cache()
    # the runner and the joint TQU family, each phase counted on its own;
    # then phase 3's checks at every shape they launched that it lacks
    new_launches, new_shapes = [tally["launches"]], dict(tally["shapes"])
    with tempfile.TemporaryDirectory() as tmp:
        for phase in (phase_runner, phase_runner_fits, phase_joint):
            n, sh = phase(torch, lk, dev, card, tmp)
            new_launches.append(n)
            for k, v in sh.items():
                new_shapes[k] = new_shapes.get(k, 0) + v
            torch.cuda.empty_cache()
    # the flat interface on the full grids' transforms
    n, sh = phase_flat(torch, lk, dev, card, sht, hsht)
    new_launches.append(n)
    for k, v in sh.items():
        new_shapes[k] = new_shapes.get(k, 0) + v
    # the transform options: the ring-parity split, fft_mode, the tables
    par_rec, par_rec64, opt_par, opt_dense = phase_options(
        torch, lk, dev, card, sht, hsht)
    new_launches.append(opt_dense)
    # the bfloat16 table mode: (a) the kernels, (b) the full-width
    # transforms against phase 4's and the HEALPix phase's, then, with those
    # freed (so that the peak memory compares with phase 5's), (c) the slice
    t0 = time.time()
    bf_rec = phase_bf16_kernels(torch, lk, dev, card)
    n_b = phase_bf16_transforms(torch, lk, dev, card, sht, hsht)
    del sht, hsht
    torch.cuda.empty_cache()
    n_c = phase_bf16_slice(torch, lk, dev, card)
    bf_launches = [a + b for a, b in zip(n_b, n_c)]
    print(f"bf16 phase: {time.time() - t0:.1f} s; bf16 launches on its paths"
          f" (dense synth, adj, parity synth, adj) {bf_launches} [{card}]",
          flush=True)
    torch.cuda.empty_cache()
    # float64 compute on narrow tables: (a) the kernels, (b) the
    # transforms, (c) the CG solves
    nw_rec, nw_launches = phase_narrow(torch, lk, dev, card)
    torch.cuda.empty_cache()
    # the remaining table pairs: float16 and float64 tables under float32
    # compute: (a) the kernels, (b) the transforms, (c) the slices
    pr_rec, pr_launches = phase_pairs(torch, lk, dev, card)
    print_shapes("engine sweeps", tally["shapes"])
    checked, new_rec, new_rec64 = phase_new_shapes(torch, lk, dev, card,
                                                   new_shapes)
    for recs, new in ((rec, new_rec), (rec64, new_rec64)):
        for name, by in new.items():
            recs[name].update(by)
    print(f"phase 3 at the engine, runner, joint and flat phases' "
          f"{len(checked)} new "
          f"shapes (L, nr, C, dtype): "
          f"{', '.join(f'{L} {nr} {C} {str(dt)[6:]}' for L, nr, C, dt in checked)}",
          flush=True)
    # the exact log-ratios: at most a tenth of the old form's rounding; the
    # pCN one under PCN_EXACT_LIMIT nats
    for cfg, errs in lr_err.items():
        for what, (new, old, *_) in errs.items():
            check(np.median(new) <= 0.1 * np.median(old),
                  f"{cfg} {what} log-ratio: float32 rounding median "
                  f"{np.median(new):.3g} nats, not a tenth of the old "
                  f"form's {np.median(old):.3g}")
    new = lr_err["GL band"]["pCN"][0]
    check(new.max() <= PCN_EXACT_LIMIT, f"GL band pCN exact log-ratio: "
          f"float32 rounding max {new.max():.3g} > {PCN_EXACT_LIMIT}")
    launches = [sum(n) for n in zip(*launches.values())] + list(
        cg_launches[2:])
    launches = [sum(n) for n in zip(launches, *new_launches, par_launches)]

    kernels = []
    # (name, TPU source line, kernel source, records, launches): the
    # float32 kernels' top-level times are those at the band's cut rings,
    # the float64 kernels' those at the CG phase's cut rings and chains;
    # every main-path row count is listed under "by_nr"
    for i, (name, line) in enumerate((("legendre_synth_tri", 52),
                                      ("legendre_adj_tri", 106))):
        for src, recs, n in (
                ("gibbssampler_tpu_torch/csrc/legendre_tri.cu", rec,
                 launches[i]),
                ("gibbssampler_tpu_torch/csrc/legendre_tri_f64.cu", rec64,
                 launches[2 + i])):
            kernels.append({
                "name": name if recs is rec else f"{name}_f64",
                "route": "cuda", "source": src,
                "replaces": f"gibbssampler_tpu/sht/pallas_legendre.py:{line}",
                "launches": n, **recs[name][CUT_RINGS],
                "by_nr": {str(nr): r for nr, r in recs[name].items()}})
    # the parity modes of the same sources: top-level times at the split
    # spin-2 columns of 128 chains on the GL grid (float32) and of the CG
    # family's 8 chains (float64); every shape under "by_shape"
    for i, (name, line) in enumerate((("legendre_synth_par", 52),
                                      ("legendre_adj_par", 106))):
        for src, recs, n, key in (
                ("gibbssampler_tpu_torch/csrc/legendre_tri.cu", par_rec,
                 opt_par[i], f"{LMAX + 1} C{4 * NCHAINS}"),
                ("gibbssampler_tpu_torch/csrc/legendre_tri_f64.cu",
                 par_rec64, opt_par[2 + i], f"{LMAX + 1} C{4 * CG_CHAINS}")):
            kernels.append({
                "name": name if recs is par_rec else f"{name}_f64",
                "route": "cuda", "source": src,
                "replaces": f"gibbssampler_tpu/sht/pallas_legendre.py:{line}",
                "launches": n, **recs[name][key],
                "by_shape": recs[name]})
    # the bfloat16-table kernels: top-level times at the band's cut rings
    # (dense) and at the GL grid's 257 north rings (parity), 128 chains
    for i, (name, line, key) in enumerate((
            ("legendre_synth_tri", 52, CUT_RINGS),
            ("legendre_adj_tri", 106, CUT_RINGS),
            ("legendre_synth_par", 52, f"{LMAX + 1} C{2 * NCHAINS}"),
            ("legendre_adj_par", 106, f"{LMAX + 1} C{2 * NCHAINS}"))):
        recs = bf_rec[name + "_bf16"]
        kernels.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": "gibbssampler_tpu_torch/csrc/legendre_tri_bf16.cu",
            "replaces": f"gibbssampler_tpu/sht/pallas_legendre.py:{line}",
            "launches": bf_launches[i], **recs[key],
            "by_shape": {str(k): r for k, r in recs.items()}})
    # the narrow-table float64 kernels: top-level times at the band's cut
    # rings (dense) and the GL grid's 257 north rings (parity), the CG
    # family's 8 chains
    for tdn, sfx in NARROW_SFX.items():
        for i, (name, line, key) in enumerate((
                ("legendre_synth_tri", 52, f"{CUT_RINGS} C{2 * CG_CHAINS}"),
                ("legendre_adj_tri", 106, f"{CUT_RINGS} C{2 * CG_CHAINS}"),
                ("legendre_synth_par", 52, f"{LMAX + 1} C{2 * CG_CHAINS}"),
                ("legendre_adj_par", 106, f"{LMAX + 1} C{2 * CG_CHAINS}"))):
            recs = nw_rec[f"{name}_{sfx}"]
            kernels.append({
                "name": f"{name}_{sfx}", "route": "cuda",
                "source": "gibbssampler_tpu_torch/csrc/"
                          "legendre_tri_narrow_f64.cu",
                "replaces": f"gibbssampler_tpu/sht/pallas_legendre.py:{line}",
                "launches": nw_launches[tdn][i], **recs[key],
                "by_shape": recs})
    # the float16-table and float64-table float32 kernels: top-level times
    # at the band's cut rings (dense) and the GL grid's 257 north rings
    # (parity), 128 chains
    for sfx, (_tdn, src, _cnt, _pipe) in PAIR_KERNELS.items():
        for i, (name, line, key) in enumerate((
                ("legendre_synth_tri", 52, f"{CUT_RINGS} C{2 * NCHAINS}"),
                ("legendre_adj_tri", 106, f"{CUT_RINGS} C{2 * NCHAINS}"),
                ("legendre_synth_par", 52, f"{LMAX + 1} C{2 * NCHAINS}"),
                ("legendre_adj_par", 106, f"{LMAX + 1} C{2 * NCHAINS}"))):
            recs = pr_rec[f"{name}_{sfx}"]
            kernels.append({
                "name": f"{name}_{sfx}", "route": "cuda",
                "source": f"gibbssampler_tpu_torch/csrc/{src}",
                "replaces": f"gibbssampler_tpu/sht/pallas_legendre.py:{line}",
                "launches": pr_launches[sfx][i], **recs[key],
                "by_shape": recs})
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} not launched by the main path")
    print(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
