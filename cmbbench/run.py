"""The benchmark of gibbssampler_tpu_torch on one NVIDIA GPU.

    python3 cmbbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python -m cmbbench.run`` with the same arguments), from the root of
a checkout holding ``BENCHMARK.json``.  With ``--trace 0`` the run measures
the cell's end-to-end metrics over a window of ``--seconds``; with
``--trace 1`` its per-layer metrics over a short traced window.  Either way
it then checks what the window's timed path produced against the plain
reference (``cmbbench.reference``) and prints the compared numbers with
their limits as its last lines on standard error, and one JSON object as
the last line of standard output.

It fails, printing no result, without a CUDA device, and when JAX or the
JAX package has been loaded by the time the window closes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the package's on-disk table cache would write gigabytes a run; the nvcc
# build stays in the package's own _build/ inside the checkout
os.environ["GIBBSSAMPLER_TORCH_TABLE_CACHE"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from cmbbench import harness
    root = Path.cwd()
    bench, entry, _, _ = harness.load_cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"cmbbench: the cell needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    card = harness.card_info()
    tag = f"[{card['name']}, power limit {card['power_limit_w']} W]"
    log = lambda msg: print(f"cmbbench {args.workload}: {msg} {tag}",
                            file=sys.stderr, flush=True)
    res = harness.execute(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), device="cuda", t_start=T_START,
                          log=log, card=card)
    bad = harness.forbidden_modules()
    if bad:
        print(f"cmbbench: modules loaded that the benchmark forbids: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for name, m in res["metrics"].items():
        log(f"{name} = {m['value']!r} {m['unit']}")
    print(f"correct = {res['correct']}", file=sys.stderr)
    for name, c in res["checked"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
