"""Tune the flagship proposal scales on the card: the port's counterpart
of ``tools/tune_flagship.py``.

    python -m gibbssampler_tpu_torch.tune --grid gl --mask band --cr aux_mala
    python -m gibbssampler_tpu_torch.tune --grid healpix --mask planckish \\
        --segments 6 --seg-iters 100
    python -m gibbssampler_tpu_torch.tune --scheme pncp --grid gl \\
        --mask band --lcut none,300

Builds the flagship configuration (``flagship.build``: ASIS, or PNCP with
the per-field ``--lcut``) from bench.py's analytic seeds, then runs
warm-up segments of ``--nchains`` chains and ``--seg-iters`` iterations,
each started afresh (``flagship.start_state``) at the previous segment's
pooled last D_ell, and after each segment rescales every MH block's
proposal scale by the pure multiplicative rule of
``parallel.adapt.rescale_sigmas`` (window 0.2-0.5).  Logs each segment's
acceptances, per field of its multi-bin block(s) and of its single-bin
blocks, with ms/iter, to stderr.  The record (scales, per-segment
per-block acceptances, the blocks, chains, iterations, segments, dtype, the card's
name and power limit from nvidia-smi, the commit) replaces only the record
of its own key (scheme, grid, mask, lmax, nbins, cr, l_cut) in ``--out``,
by default ``gibbssampler_tpu_torch/tuned_proposals.json``.  Prints the
last segment's acceptances as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import flagship
from .interop import RECORD_KEYS, record_key
from .parallel.adapt import rescale_sigmas


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card(device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them; None on
    the CPU."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def head_commit() -> str | None:
    """The checkout's commit, where it is a git checkout."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                             text=True, timeout=30,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    except OSError:
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def write_record(path, rec):
    """Replace the record of ``rec``'s key in ``path`` (or add it)."""
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            recs = json.load(f)["records"]
    recs = [r for r in recs
            if any(r.get(k) != rec.get(k) for k in RECORD_KEYS)]
    with open(path, "w") as f:
        json.dump({"records": recs + [rec]}, f, indent=1)
        f.write("\n")


def accept_summary(acc, blocks_list) -> dict:
    """{field: {"big": mean over its multi-bin blocks, "singles": mean over
    its single-bin blocks}} of one segment's per-block acceptances (a kind
    the field lacks is left out)."""
    out = {}
    for f, (a, blocks) in enumerate(zip(acc, blocks_list)):
        single = np.array([hi - lo == 1 for lo, hi in blocks], dtype=bool)
        kinds = {"big": ~single, "singles": single}
        out[("EE", "BB")[f]] = {k: float(np.mean(a[m]))
                                for k, m in kinds.items() if m.any()}
    return out


def tune(grid: str, mask: str, cr: str, device="cuda", lmax: int = 512,
         nchains: int = 64, seg_iters: int = 150, segments: int = 4,
         seed: int = 11, scheme: str = "asis",
         lcut=flagship.PNCP_LCUT) -> dict:
    """Run the warm-up segments; returns the record (without provenance)."""
    t0 = time.time()
    sch, dl0 = flagship.build(grid, mask, cr, device=device, lmax=lmax,
                              seed=True, scheme=scheme, lcut=lcut)
    log(f"{scheme} {grid} {mask} {cr} lmax {lmax}: set-up "
        f"{time.time() - t0:.1f} s")
    blocks = sch.blocks_list
    sig = [s.copy() for s in sch.prop_sigma_list]
    gen = torch.Generator(device=device).manual_seed(seed)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    accs_log, ms_log = [], []
    for seg in range(segments):
        sch.set_proposal_sigmas(sig)
        sync()
        t0 = time.time()
        out = sch.run(dl0, n_iter=seg_iters, gen=gen,
                      state=flagship.start_state(sch, dl0, nchains, gen))
        sync()
        ms = (time.time() - t0) / seg_iters * 1e3
        sig, acc = rescale_sigmas(sig, out, blocks)
        log(f"segment {seg}: {ms:.2f} ms/iter; accept "
            f"{accept_summary(acc, blocks)}")
        accs_log.append([a.tolist() for a in acc])
        ms_log.append(ms)
        dl0 = tuple(c[:, -1, :].mean(dim=0).cpu().numpy()
                    for c in out["dl_chains"])
    nbins = [len(s) for s in sig]
    l_cut = sch.l_cut if scheme == "pncp" else None
    return {**record_key(scheme, grid, mask, lmax, nbins, cr, l_cut),
            "cr_options": flagship.CR_OPTIONS[cr], "n_iter_mh": 1,
            "blocks": [[list(b) for b in bl] for bl in blocks],
            "nchains": nchains, "seg_iters": seg_iters, "segments": segments,
            "seed": seed, "dtype": str(sch.model.sht.dtype).split(".")[-1],
            "sig": [s.tolist() for s in sig],
            "dl_warm": [np.asarray(d).tolist() for d in dl0],
            "accept_per_block_per_segment": accs_log,
            "ms_per_iter_per_segment": ms_log}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scheme", choices=("asis", "pncp"), default="asis")
    p.add_argument("--grid", choices=flagship.GRIDS, required=True)
    p.add_argument("--mask", choices=flagship.MASKS, required=True)
    p.add_argument("--cr", choices=tuple(flagship.CR_OPTIONS),
                   default="aux_mala")
    p.add_argument("--lcut", default=",".join(map(str, flagship.PNCP_LCUT)),
                   help="PNCP: the per-field l_cut, EE,BB ('none' = fully "
                        "centered; default bench.py's BENCH_LCUT)")
    p.add_argument("--nchains", type=int, default=64)
    p.add_argument("--seg-iters", type=int, default=150)
    p.add_argument("--segments", type=int, default=4)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--lmax", type=int, default=512)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=flagship.RECORDS)
    p.add_argument("--commit", default=None,
                   help="the commit tuned on (default: git rev-parse HEAD)")
    a = p.parse_args(argv)
    lcut = tuple(c.strip() if c.strip() == "none" else int(c)
                 for c in a.lcut.split(","))
    rec = tune(a.grid, a.mask, a.cr, a.device, a.lmax, a.nchains,
               a.seg_iters, a.segments, a.seed, a.scheme, lcut)
    rec["card"] = card(a.device)
    rec["commit"] = a.commit or head_commit()
    write_record(a.out, rec)
    log(f"wrote {a.out}")
    blocks = [[tuple(b) for b in bl] for bl in rec["blocks"]]
    last = [np.asarray(x) for x in rec["accept_per_block_per_segment"][-1]]
    print(json.dumps({"scheme": a.scheme, "grid": a.grid, "mask": a.mask,
                      "cr": a.cr, "l_cut": rec["l_cut"],
                      "accept": accept_summary(last, blocks),
                      "card": rec["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
