#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the repository root; one card)

Phases, each reported on its own lines; any failure raises and exits
non-zero:

1. needs torch.cuda.is_available(); prints the card's name and power limit
   (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
2. builds the CUDA kernels from gibbssampler_tpu_torch/csrc (one nvcc per
   source, started together, sm_90a) and prints ptxas's registers, spills
   and shared memory for every kernel;
3. compares each kernel with its plain PyTorch version (true float32) on
   the card at the JAX package's Pallas test shapes, a ragged shape, the
   main-path shapes and a batch of 200, in float32 (<= 1e-5 max|ref|) and
   float64 (<= 1e-12), with contiguous operands and with the strided views
   the main path passes, the outputs given NaN-filled memory; checks
   adjointness; and times kernel and plain version at L 513, C 256 and 65
   or 513 rings, with TFLOP/s and GB/s against the data sheet's peaks;
4. checks the lmax-512 transforms in float32 (round trip and the cut
   transform's adjointness) and one scheme step at a small size, card
   against CPU on the same injected variates;
5. runs the slice: the centered aux-Gibbs + MALA sampler on a band-masked
   polarized sky at lmax 512 (GL grid 513 x 1026, cut decomposition over
   65 rings), 128 chains, the initial CR draw, 10 warm-up and 50 timed
   iterations; checks the D_ell, the acceptance and the kernel launch
   counts, and reports ms/iter and median pooled ESS/s;
6. prints the kernels' JSON line, then {"ok": true, "device": {...}} last.

It imports nothing of JAX; the port is imported from this file's
directory.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

LMAX = 512
NCHAINS = 128
N_WARM = 10
N_TIMED = 50
PER_ITER = 6          # spin-2 cut transforms of each kind per aux_mala step


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def planck_bins(lmax):
    """Unit bins to l = 50, then 10 wide to 200 and 30 wide beyond."""
    edges = list(range(2, min(51, lmax + 2)))
    l = edges[-1]
    while l < lmax + 1:
        l = min(l + (10 if l < 200 else 30), lmax + 1)
        edges.append(l)
    return np.array(edges)


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


def phase_build(lk):
    """Build every kernel source (nvcc in parallel); print ptxas's report
    of each kernel and the float32 kernels' dynamic shared memory."""
    t0 = time.time()
    built = lk.build()
    print(f"built {', '.join(os.path.relpath(so) for so, _ in built.values())}"
          f" in {time.time() - t0:.1f} s", flush=True)
    keys = ("Compiling entry function", "spill", "Used")
    for _, report in built.values():
        for ln in report.splitlines():
            if any(k in ln for k in keys):
                print(f"  ptxas: {ln.strip()}", flush=True)
    print(f"  float32 kernels' dynamic shared memory (bytes): "
          f"{lk.f32_dynamic_smem()}", flush=True)


def phase_kernels(torch, lk, dev, card):
    """Kernel vs plain on the card, contiguous and in the main path's
    layouts; returns the main-path records."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain versions must run in true float32 (allow_tf32 is on)")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(16, 12, 8), (37, 19, 10), (LMAX + 1, 65, 2 * NCHAINS),
              (LMAX + 1, 65, 200), (LMAX + 1, LMAX + 1, 2 * NCHAINS)]
    tols = {torch.float32: 1e-5, torch.float64: 1e-12}
    rec = {}
    for L, nr, C in shapes:
        for dtype, tol in tols.items():
            lam = tri_table(torch, L, nr, dtype, dev, gen)
            x0 = torch.randn((L, C, L), generator=gen, dtype=dtype, device=dev)
            g0 = torch.randn((L, nr, C), generator=gen, dtype=dtype, device=dev)
            # y = K1 x + noise, so that <K1 x, y> is large
            y0 = (lk.legendre_synth_tri_plain(lam, x0)
                  + torch.randn((L, nr, C), generator=gen, dtype=dtype,
                                device=dev))
            for lay, (x, g, y) in {
                    "contiguous": (x0, g0, y0),
                    "state views": (x_view(x0), g_view(g0), g_view(y0))
            }.items():
                errs, rels = {}, {}
                for name, kern, plain, b, shape in (
                        ("legendre_synth_tri", lk.legendre_synth_tri,
                         lk.legendre_synth_tri_plain, x, (L, nr, C)),
                        ("legendre_adj_tri", lk.legendre_adj_tri,
                         lk.legendre_adj_tri_plain, g, (C, L, L))):
                    # NaN in the memory the output will be given: the kernel
                    # must write every element, the adjoint's l < m zeros too
                    torch.full(shape, float("nan"), dtype=dtype, device=dev)
                    out = kern(lam, b)
                    ref = plain(lam, b)
                    torch.cuda.synchronize()
                    err = float((out - ref).abs().max())
                    scale = float(ref.abs().max())
                    check(err <= tol * scale,
                          f"{name} L={L} nr={nr} C={C} {dtype} {lay}: "
                          f"max|err| {err} > {tol} * {scale}")
                    errs[name] = err
                    rels[name] = err / scale
                lhs = float((lk.legendre_synth_tri(lam, x).double()
                             * y.double()).sum())
                rhs = float((x.double()
                             * lk.legendre_adj_tri(lam, y).double()).sum())
                rel = abs(lhs - rhs) / abs(lhs)
                check(rel <= (1e-5 if dtype == torch.float32 else 1e-12),
                      f"adjointness L={L} nr={nr} C={C} {dtype} {lay}: {rel}")
                print(f"kernels L={L} nr={nr} C={C} {str(dtype)[6:]} {lay}: "
                      f"max|err|/max|ref| synth "
                      f"{rels['legendre_synth_tri']:.2e} adj "
                      f"{rels['legendre_adj_tri']:.2e} (<= {tol}), "
                      f"adjointness {rel:.2e}", flush=True)
                if (L == LMAX + 1 and C == 2 * NCHAINS
                        and dtype == torch.float32):
                    rec.update(time_kernels(torch, lk, lam, x, g, lay, card,
                                            errs))
            del lam, x0, g0, y0, x, g, y
    torch.cuda.empty_cache()
    return rec


def time_kernels(torch, lk, lam, x, g, lay, card, errs):
    """Kernel and plain times (plain, kernel, kernel, plain) with rates;
    returns the records of the main-path shape and layout."""
    L, nr, C = lam.shape[0], lam.shape[2], x.shape[1]
    reps = 20 if nr == 65 else 5
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
        flops, nbytes = work(name, L, nr, C)
        tflops, gbs = flops / ms * 1e-9, nbytes / ms * 1e-6
        print(f"time {name} L={L} nr={nr} C={C} float32 {lay}: kernel "
              f"{ms:.4f} ms, plain einsum {pms:.4f} ms; kernel "
              f"{tflops:.2f} TFLOP/s on the triangle ({tflops / 67:.1%} of "
              f"67 fp32 FMA; 3xTF32 {3 * tflops / 495:.1%} of 495 TF32), "
              f"{gbs:.0f} GB/s ({gbs / 3350:.1%} of 3350) [{card}]",
              flush=True)
        if nr == 65 and lay == "state views":
            rec[name] = {"design": "3xtf32-mma.sync",
                         "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                         "tflops": tflops}
    return rec


def phase_sht(torch, dev):
    """lmax-512 float32 transforms on the card; returns the full SHT."""
    from gibbssampler_tpu_torch.harmonics import ell_mask_state, nstate
    from gibbssampler_tpu_torch.sht import SHT, make_sht, subgrid_rows
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
    q, u = cut.synthesis_spin2_state(e, b)
    q2 = q + torch.randn(q.shape, generator=gen, **f32)
    u2 = u + torch.randn(u.shape, generator=gen, **f32)
    ae, ab = cut.adjoint_synthesis_spin2_state(q2, u2)
    lhs = float((q.double() * q2.double()).sum()
                + (u.double() * u2.double()).sum())
    rhs = float((e.double() * ae.double()).sum()
                + (b.double() * ab.double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    check(rel <= 1e-5, f"cut transform adjointness {rel} > 1e-5")
    print(f"sht float32: round trip max rel err spin2 {rt2:.2e} spin0 "
          f"{rt0:.2e}; cut transform ({rows.size} rings) adjointness "
          f"{rel:.2e}", flush=True)
    return sht


def phase_small_step(torch, dev):
    """One CenteredGibbs step at lmax 16 in float64, card against CPU, on
    the same dataset and injected variates: the kernels inside the path."""
    from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
    from gibbssampler_tpu_torch.interop import model_from_numpy
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    from gibbssampler_tpu_torch.schemes import CenteredGibbs
    from gibbssampler_tpu_torch.schemes.gibbs import GibbsState
    lmax, nch = 16, 4
    gen = torch.Generator().manual_seed(2)
    dls = np.stack([example_dl(lmax, "ee"), example_dl(lmax, "bb")])
    nr = lmax + 1
    theta = np.arccos(np.polynomial.legendre.leggauss(nr)[0][::-1])
    keep = (np.abs(np.pi / 2 - theta) > 0.2).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (nr, 2 * lmax + 2))
    cpu_model, _ = simulate_dataset(lmax, 2, dls, 0.2 ** 2,
                                    fwhm_radians=np.radians(0.5), mask=mask,
                                    dtype=torch.float64, gen=gen)
    g = cpu_model.sht.grid
    arrays = {"d": cpu_model.d.numpy(), "tau": cpu_model.noise.tau.numpy(),
              "q_map": cpu_model.noise.q_map.numpy(),
              "omega": cpu_model.noise.omega, "bl": cpu_model.bl.numpy(),
              "spin": 2, "theta": g.theta, "weights": g.weights,
              "phi0": g.phi0, "nphi": g.nphi}
    bins = np.array([2, 4, 7, 11, 17])
    nb = len(bins) - 1
    dl0 = [np.tile([d[lo:hi].mean() for lo, hi in zip(bins[:-1], bins[1:])],
                   (nch, 1)) for d in dls]
    rng = np.random.default_rng(3)
    outs = []
    for device in ("cpu", dev):
        model = with_cut_decomposition(model_from_numpy(arrays, device))
        scheme = CenteredGibbs(model, [bins, bins], cr_method="aux_mala",
                               cr_options={"n_gibbs": 1, "tau": 0.02})
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        if not outs:
            var = scheme.var_cls(tuple(t(d) for d in dl0)).cpu().numpy()
            s0 = np.sqrt(var) * rng.normal(size=var.shape)
            pool = {"state": rng.normal(size=(nch, 2, 2, model.nstate)),
                    "aux": rng.normal(size=(nch, 1) + tuple(model.w_cut.shape))}
            u = rng.uniform(size=nch)
            gam = [rng.gamma(3.0, size=(nch, nb)) for _ in range(2)]
        state = GibbsState(s=t(s0), dl=tuple(t(d) for d in dl0))
        new, info = scheme.step(state, noise={k: t(v) for k, v in pool.items()},
                                u=t(u), gammas=tuple(t(x) for x in gam))
        outs.append([new.s.cpu().numpy(), new.dl[0].cpu().numpy(),
                     new.dl[1].cpu().numpy(),
                     info["cr_accept"].cpu().numpy()])
    worst = 0.0
    for a, b in zip(*outs):
        err = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))
        worst = max(worst, err)
    check(worst <= 1e-9, f"small-step card vs CPU rel err {worst} > 1e-9")
    print(f"small step lmax={lmax} {nch} chains float64: card vs CPU max rel "
          f"err {worst:.2e}", flush=True)


def phase_slice(torch, lk, sht, dev, card):
    """The main path at full width; returns (launch counts, metrics)."""
    from gibbssampler_tpu_torch.diagnostics import summarize_chains
    from gibbssampler_tpu_torch.inference import example_dl, simulate_dataset
    from gibbssampler_tpu_torch.ops import with_cut_decomposition
    from gibbssampler_tpu_torch.schemes import CenteredGibbs
    lk.reset_launch_counts()
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(0)
    lat = np.abs(np.pi / 2 - sht.grid.theta)
    keep = (lat > 0.2).astype(np.float64)
    mask = np.broadcast_to(keep[:, None], (sht.nrings, sht.nphi))
    dls = np.stack([example_dl(LMAX, "ee"), example_dl(LMAX, "bb")])
    model, _ = simulate_dataset(LMAX, 2, dls, 0.2 ** 2,
                                fwhm_radians=np.radians(0.5), mask=mask,
                                dtype=torch.float32, device=dev, sht=sht,
                                gen=gen)
    model = with_cut_decomposition(model)
    check(model.cut_sht.nrings == 65,
          f"{model.cut_sht.nrings} cut rings, expected 65")
    bins = planck_bins(LMAX)
    scheme = CenteredGibbs(model, [bins, bins], cr_method="aux_mala",
                           cr_options={"n_gibbs": 1, "tau": 0.02})
    dl0 = tuple(np.array([d[lo:hi].mean() for lo, hi in zip(bins[:-1],
                                                             bins[1:])])
                for d in dls)
    torch.cuda.synchronize()
    print(f"slice set-up (simulate, cut decomposition over "
          f"{model.cut_sht.nrings} rings, scheme): {time.time() - t0:.1f} s",
          flush=True)
    t0 = time.time()
    warm = scheme.run(dl0, n_iter=N_WARM, nchains=NCHAINS, gen=gen)
    torch.cuda.synchronize()
    print(f"initial CR draw + {N_WARM} warm-up iterations x {NCHAINS} chains: "
          f"{time.time() - t0:.1f} s", flush=True)
    before = (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    out = scheme.run(dl0, n_iter=N_TIMED, gen=gen, state=warm["final_state"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches)
    for name, b, a in zip(("synth", "adj"), before, launches):
        check(a - b == PER_ITER * N_TIMED,
              f"{name} launches in the timed run {a - b}, expected "
              f"{PER_ITER} x {N_TIMED}")
    dl_all = [np.concatenate([warm["dl_chains"][f].cpu().numpy(),
                              out["dl_chains"][f].cpu().numpy()], axis=1)
              for f in range(2)]
    for f, dl in enumerate(dl_all):
        check(dl.shape == (NCHAINS, N_WARM + N_TIMED, len(bins) - 1),
              f"dl_chains[{f}] shape {dl.shape}")
        check(np.isfinite(dl).all() and (dl > 0).all(),
              f"dl_chains[{f}] has non-finite or non-positive values")
    acc = float(out["cr_accept"].mean())
    check(acc > 0.0, "mean MALA acceptance is 0")
    ess = np.concatenate([
        summarize_chains(out["dl_chains"][f].cpu().numpy(),
                         burn_frac=0.2)["ess"] for f in range(2)])
    ms = wall / N_TIMED * 1e3
    ess_s = float(np.median(ess)) / wall
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"slice lmax={LMAX} {NCHAINS} chains centered aux_mala: "
          f"{ms:.2f} ms/iter over {N_TIMED} iterations; mean MALA acceptance "
          f"{acc:.4f}; median pooled ESS/s {ess_s:.3f} ({N_TIMED} "
          f"iterations, burn 20%); peak device memory {peak:.2f} GiB "
          f"[{card}]", flush=True)
    print(f"launches in the main path: legendre_synth_tri {launches[0]}, "
          f"legendre_adj_tri {launches[1]} ({PER_ITER} each per iteration)",
          flush=True)
    return launches


def main():
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
    from gibbssampler_tpu_torch.sht import legendre_kernels as lk

    phase_build(lk)
    rec = phase_kernels(torch, lk, dev, card)
    sht = phase_sht(torch, dev)
    phase_small_step(torch, dev)
    launches = phase_slice(torch, lk, sht, dev, card)

    src = "gibbssampler_tpu_torch/csrc/legendre_tri.cu"
    kernels = [
        {"name": "legendre_synth_tri", "route": "cuda", "source": src,
         "replaces": "gibbssampler_tpu/sht/pallas_legendre.py:52",
         "launches": launches[0], **rec["legendre_synth_tri"]},
        {"name": "legendre_adj_tri", "route": "cuda", "source": src,
         "replaces": "gibbssampler_tpu/sht/pallas_legendre.py:106",
         "launches": launches[1], **rec["legendre_adj_tri"]},
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} not launched by the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
