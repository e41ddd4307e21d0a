"""Multi-process launch: one process per card, a global ("chains", "m")
mesh (PyTorch counterpart of ``tools/launch_pod.py``).

The reference's scaling story is a SLURM array of 10 independent processes
(reference: job-script.sh:1-8) pooled offline (config.py:161-225).  Here
one program runs over all processes of a ``torch.distributed`` group: the
chains shard over the "chains" axis, the SHT's Legendre tables over the
"m" axis (``--n-m``), and the ESS and R-hat are pooled with collectives
over the chains group instead of pulling every chain to one process.

Run with torchrun (its env:// rendezvous), one process per card:

    torchrun --standalone --nproc_per_node 4 \\
        -m gibbssampler_tpu_torch.launch_pod --lmax 256 --nchains 64

``--device cuda`` (the default) runs NCCL with process r on
``cuda:LOCAL_RANK``; ``--device cpu`` runs gloo on the CPU.  Without
torchrun, give ``--coordinator host:port --num-processes N --process-id
r`` to each process.  Process 0 writes the npz (``dl_chain_0``, the first
field's chains gathered from all processes; ``ess``, ``rhat``, ``wall``,
``config``) and prints the median ESS and the largest R-hat.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def parser() -> argparse.ArgumentParser:
    """tools/launch_pod.py's arguments and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--lmax", type=int, default=128)
    ap.add_argument("--nchains", type=int, default=16,
                    help="global chain count (divisible by the chains axis)")
    ap.add_argument("--n-m", type=int, default=1,
                    help="m-axis (model-parallel) mesh extent")
    ap.add_argument("--n-iter", type=int, default=500)
    ap.add_argument("--noise-sigma2", type=float, default=0.04)
    ap.add_argument("--mask-band-deg", type=float, default=11.5)
    ap.add_argument("--cr-method", default="aux_mala")
    ap.add_argument("--out", default="pod_results.npz")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (else torchrun's env://)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: NCCL, a card per process; cpu: gloo")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from .inference import example_dl, simulate_dataset
    from .parallel import (ess_device, gather_chains, make_mesh, shard_sht,
                           sharded_run, split_rhat_device)
    from .schemes import CenteredGibbs
    from .sht import gauss_legendre_grid

    cuda = args.device == "cuda"
    if cuda:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    backend = "nccl" if cuda else "gloo"
    if args.coordinator:
        dist.init_process_group(backend,
                                init_method=f"tcp://{args.coordinator}",
                                world_size=args.num_processes,
                                rank=args.process_id)
    else:
        dist.init_process_group(backend)
    try:
        pid = dist.get_rank()
        lmax = args.lmax
        grid = gauss_legendre_grid(lmax)
        lat = np.abs(np.pi / 2 - grid.theta)
        keep = (lat > np.radians(args.mask_band_deg)).astype(np.float64)
        mask = (np.broadcast_to(keep[:, None], (grid.nrings, grid.nphi))
                if args.mask_band_deg > 0 else None)
        fields = np.stack([example_dl(lmax, "ee", amp=1000.0),
                           example_dl(lmax, "bb", amp=1000.0)])
        # every process draws the same dataset
        model, _ = simulate_dataset(
            lmax, spin=2, dl_fields=fields, noise_sigma2=args.noise_sigma2,
            fwhm_radians=np.radians(0.5), mask=mask, dtype=torch.float32,
            device=dev, gen=torch.Generator(device=dev).manual_seed(0))

        world = dist.get_world_size()
        mesh = make_mesh(n_chains=world // args.n_m, n_m=args.n_m,
                         device_type=dev.type)
        if args.n_m > 1:
            model = dataclasses.replace(model,
                                        sht=shard_sht(model.sht, mesh))
        bins = np.arange(2, lmax + 2)
        scheme = CenteredGibbs(model, [bins, bins], cr_method=args.cr_method,
                               cr_options={"n_gibbs": 1, "tau": 0.02})
        dl0 = tuple(np.maximum(f[2:], 1e-6) for f in fields)

        if pid == 0:
            print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
                  f"{world} processes ({backend}, {dev.type}); "
                  f"{args.nchains} chains", flush=True)
        t0 = time.time()
        out = sharded_run(scheme, dl0, n_iter=args.n_iter,
                          nchains=args.nchains, mesh=mesh, seed=1)
        if cuda:
            torch.cuda.synchronize(dev)
        wall = time.time() - t0

        chain = out["dl_chains"][0]
        group = mesh.get_group("chains")
        post = chain[:, int(0.2 * chain.shape[1]):]   # burn 20%
        ess = ess_device(post, group=group).numpy()
        rhat = split_rhat_device(post.double(), group=group).cpu().numpy()
        full = gather_chains(chain, mesh).cpu().numpy()
        if pid == 0:
            np.savez(args.out, dl_chain_0=full, ess=ess, rhat=rhat,
                     wall=wall, config=json.dumps(vars(args)))
            print(f"{args.n_iter} iters x {args.nchains} chains in "
                  f"{wall:.1f}s; median ESS {float(np.median(ess)):.1f}, "
                  f"max R-hat {float(np.max(rhat)):.3f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
