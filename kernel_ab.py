#!/usr/bin/env python3
"""Time the full-table Legendre kernels of two source trees in turns.

    python3 kernel_ab.py OTHER_TREE [--reps 40]

OTHER_TREE is a directory holding another version of the port's package
(``gibbssampler_tpu_torch/``), for example a parent commit unpacked with
``git archive <commit> gibbssampler_tpu_torch | tar -x -C OTHER_TREE``.
Each tree's kernels are built (into that tree's ``_build/``) and timed in a
process of its own, in the order other, this, this, other, on one card:
both kernels at the main path's shapes (L 513; float32 at C 256 and
float64 at C 16, nr 65 and 513; the state views the transforms pass), mean
ms per call over ``--reps`` launches between CUDA events.  Prints the
card's name and power limit, one JSON line per run, then one JSON line of
the mean of each tree's two runs per shape and this tree's ratio to the
other's.  Needs a CUDA card.
"""

import json
import os
import subprocess
import sys

SHAPES = (("float32", 256, 65), ("float32", 256, 513),
          ("float64", 16, 65), ("float64", 16, 513))
L = 513


def time_tree(root: str, reps: int) -> dict:
    """{"<kernel> <dtype> nr<nr> C<C>": ms} of the package under root."""
    sys.path.insert(0, root)
    import torch
    from gibbssampler_tpu_torch.sht import legendre_kernels as lk
    if not os.path.realpath(lk.__file__).startswith(os.path.realpath(root)):
        raise RuntimeError(f"imported {lk.__file__}, not the tree {root}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lk.build()
    gen = torch.Generator(device=dev).manual_seed(0)

    def ms_per_call(fn):
        for _ in range(3):
            fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    out = {}
    for dtype_name, C, nr in SHAPES:
        dtype = getattr(torch, dtype_name)
        tri = (torch.arange(L, device=dev)[None, :]
               >= torch.arange(L, device=dev)[:, None])
        lam = (torch.randn((L, L, nr), generator=gen, dtype=dtype, device=dev)
               * tri[:, :, None]).contiguous()
        # the (m, C, l) view of (C, m, l) grids and the (m, r, C) view of
        # an (m, C, r) copy, as sht.lcore passes them
        x = torch.randn((L, C, L), generator=gen, dtype=dtype, device=dev) \
            .transpose(0, 1).contiguous().transpose(0, 1)
        g = torch.randn((L, nr, C), generator=gen, dtype=dtype, device=dev) \
            .transpose(1, 2).contiguous().transpose(1, 2)
        key = f"{dtype_name} nr{nr} C{C}"
        out[f"synth {key}"] = ms_per_call(
            lambda: lk.legendre_synth_tri(lam, x))
        out[f"adj {key}"] = ms_per_call(lambda: lk.legendre_adj_tri(lam, g))
        del lam, x, g
    return out


def main() -> int:
    args = sys.argv[1:]
    if "--worker" in args:
        root, reps = args[args.index("--worker") + 1], int(args[-1])
        print(json.dumps(time_tree(root, reps)), flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(args[0])
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 40
    this = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(other, "gibbssampler_tpu_torch")):
        print(f"{other} holds no gibbssampler_tpu_torch/", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    runs = {"other": [], "this": []}
    for label, root in (("other", other), ("this", this), ("this", this),
                        ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root, str(reps)], cwd=root,
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        runs[label].append(ms)
        print(json.dumps({"tree": label, "root": root, "ms": ms}), flush=True)
    mean = {t: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
            for t, rs in runs.items()}
    print(json.dumps({"card": card, "mean_ms": mean, "ratio_this_to_other": {
        k: mean["this"][k] / mean["other"][k] for k in mean["this"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
