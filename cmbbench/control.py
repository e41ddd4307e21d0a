"""The control of the correctness check, at a cell's own size.

    python3 cmbbench/control.py --workload <cell> --seeds 1 2 3

The control is the plain reference computed one precision step below the
configuration's (float32 with TF32 products, ``reference.sphere``), put in
the measured program's place: from the same inputs and variates it makes
the start (one CR draw from s = 0) and one Gibbs iteration from there, and
the float64 reference judges them as it judges the program.  For each seed
it prints the numbers that the run compares, as JSON lines; a sound limit
lies below the smallest of them.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ["GIBBSSAMPLER_TORCH_TABLE_CACHE"] = "0"


def control_numbers(root, name, seed, device) -> dict:
    """{number: largest value over the chains} of the control at ``seed``."""
    import torch
    from cmbbench import harness, inputs as inp
    from cmbbench.reference import check as check_mod
    from cmbbench.reference.posterior import Posterior
    _, _, cell, cfg = harness.load_cell(root, name)
    var_seed, _ = harness._seeds(seed)
    n = int(cell["nchains"])
    tau = float(cell["cr_options"]["tau"])
    pix = inp.pixelization(cfg)
    mask = inp.make_mask(cfg, pix)
    bl = inp.beam(cfg)
    d, alm = inp.simulate(cfg, pix, mask, bl,
                          torch.Generator(device=device).manual_seed(
                              cfg["data_seed"]), device)
    dl0 = inp.start_dl(cfg, alm)
    # the program only lays out the variates and declares its auxiliary
    # pixels; it computes nothing that is judged here
    prog = harness.Program(cfg, cell, pix, mask, bl, d, device)
    gen = torch.Generator(device=device).manual_seed(var_seed)
    v0, v1 = prog.draw(n, gen), prog.draw(n, gen)
    aux, kind = prog.aux_geometry(), prog.kind
    del prog
    ctrl = Posterior(cfg, pix, mask, d, bl, aux, device, torch.float32,
                     tf32=True)
    dl_start = tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                     .expand(n, -1).clone() for x in dl0)
    s_sky = alm.float().expand(n, -1, -1).clone()
    start = check_mod.control_outputs(
        ctrl, kind, {"what": "start", "s_in": s_sky, "dl_in": dl_start,
                     "variates": v0}, tau)
    it = check_mod.control_outputs(
        ctrl, kind, {"what": "iter", "s_in": start["s_out"],
                     "dl_in": start["dl_out"], "variates": v1}, tau)
    del ctrl
    ref = Posterior(cfg, pix, mask, d, bl, aux, device)
    per = check_mod.judge(ref, kind, [start, it], tau)
    return {k: float(x.max()) for k, x in per.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, nargs="+")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    from cmbbench import harness
    if not torch.cuda.is_available():
        print("cmbbench.control: no CUDA device", file=sys.stderr)
        return 2
    card = harness.card_info()
    for name in args.workload:
        for seed in args.seeds:
            t0 = time.perf_counter()
            nums = control_numbers(Path.cwd(), name, seed, "cuda")
            print(json.dumps({"control": name, "seed": seed, "numbers": nums,
                              "seconds": time.perf_counter() - t0,
                              "card": card}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
