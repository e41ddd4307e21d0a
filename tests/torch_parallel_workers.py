"""Worker processes of the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_shard_sht.py).

``spawn`` starts ``world`` processes with the "spawn" start method; they
form a gloo group through a ``FileStore`` under the test's tmp_path (so
that pytest workers running side by side never share a port), run one of
the worker functions below on the CPU in float64 with one torch thread,
and save what it returns as ``rank<r>.npz``; the parent test reads those
and compares them with the JAX package's results, which it computes
itself.  A spawned child imports this module by name, so it imports
neither jax nor the JAX package (nor the test files, which do).
"""

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gibbssampler_tpu_torch.interop import model_from_numpy
from gibbssampler_tpu_torch.ops import with_cut_decomposition
from gibbssampler_tpu_torch.parallel import (acceptance_mean, chain_seed,
                                             chain_sharding, ess_device,
                                             gather_chains, make_mesh,
                                             pooled_moments, shard_sht,
                                             sharded_run, split_rhat_device)
from gibbssampler_tpu_torch.schemes import ASISGibbs, CenteredGibbs
from gibbssampler_tpu_torch.sht import make_healpix_sht, make_sht

F64 = torch.float64
TIMEOUT = datetime.timedelta(seconds=120)   # a stuck collective fails


def spawn(fn, world: int, tmp, *args) -> list:
    """fn(rank, world, *args) in ``world`` gloo processes; returns each
    rank's saved arrays, rank by rank."""
    tmp = str(tmp)
    mp.start_processes(_entry, args=(fn, world, tmp, args), nprocs=world,
                       start_method="spawn", join=True)
    out = []
    for r in range(world):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        res = fn(rank, world, *args)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _n(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _run_arrays(out, prefix: str) -> dict:
    """A scheme.run output as flat arrays under ``prefix``."""
    res = {f"{prefix}cr_accept": _n(out["cr_accept"]),
           f"{prefix}s": _n(out["final_state"].s)}
    for f, c in enumerate(out["dl_chains"]):
        res[f"{prefix}dl{f}"] = _n(c)
    for f, a in enumerate(out.get("mh_accept", ())):
        res[f"{prefix}mh{f}"] = _n(a)
    return res


# ---------------------------------------------------------------------------
# chain sharding and the collectives
# ---------------------------------------------------------------------------

def chain_run(rank, world, arrays, dl0, n_iter, nchains, seed):
    """``sharded_run`` of CenteredGibbs (exact CR) on a (world, 1) mesh,
    beside the unsharded ``scheme.run`` of this rank's chains with its
    generator, and the chains gathered from every rank."""
    model = model_from_numpy(arrays, device="cpu")
    bins = np.arange(2, model.lmax + 2)
    scheme = CenteredGibbs(model, [bins] * model.nfields, cr_method="exact")
    mesh = make_mesh(world, 1, device_type="cpu")
    out = sharded_run(scheme, dl0, n_iter=n_iter, nchains=nchains,
                      mesh=mesh, seed=seed)
    gen = torch.Generator().manual_seed(chain_seed(seed, rank))
    ref = scheme.run(dl0, n_iter=n_iter, nchains=nchains // world, gen=gen)
    sl = chain_sharding(mesh, nchains)
    return {**_run_arrays(out, "s_"), **_run_arrays(ref, "u_"),
            **_run_arrays(gather_chains(out, mesh), "g_"),
            "range": np.array([sl.start, sl.stop])}


def collectives(rank, world, chains, accepts):
    """The collectives over this rank's chains of a (world, 1) mesh."""
    mesh = make_mesh(world, 1, device_type="cpu")
    sl = chain_sharding(mesh, chains.shape[0])
    group = mesh.get_group("chains")
    x = torch.as_tensor(chains[sl])
    m, v = pooled_moments(x, group=group)
    return {"mean": _n(m), "var": _n(v),
            "rhat": _n(split_rhat_device(x, group=group)),
            "ess": _n(ess_device(x, group=group)),
            "acc": _n(acceptance_mean(torch.as_tensor(accepts[sl]),
                                      group=group))}


# ---------------------------------------------------------------------------
# the m-sharded transform and runs
# ---------------------------------------------------------------------------

def _transform(kind, lmax, arrays):
    """The unsharded transform of ``kind``: "gl" (make_sht), "healpix"
    (nside 8, ring layout) or "cut" (the cut SHT of the model ``arrays``)."""
    if kind == "gl":
        return make_sht(lmax, dtype=F64, spin2=True, device="cpu")
    if kind == "healpix":
        return make_healpix_sht(8, lmax, dtype=F64, spin2=True,
                                device="cpu")
    model = with_cut_decomposition(model_from_numpy(arrays, device="cpu"))
    return model.cut_sht


def _table_rows(sht) -> list:
    """Rows held of each Legendre table the transform has."""
    return [t.shape[0] for t in (sht.lam0, sht.lam_p2, sht.lam_m2)
            if t is not None]


def sht_transforms(rank, world, kind, lmax, arrays, x, f, e, b, q, u):
    """Spin-0 and spin-2 synthesis, analysis and adjoint of the transform
    of ``kind`` m-sharded over a (1, world) mesh."""
    sht = _transform(kind, lmax, arrays)
    mesh = make_mesh(1, world, device_type="cpu")
    msh = shard_sht(sht, mesh)
    t = lambda a: torch.as_tensor(a)
    res = {"rows": np.array(_table_rows(msh)), "ms": _n(msh._ms),
           "syn0": _n(msh.synthesis_state(t(x))),
           "adj0": _n(msh.adjoint_synthesis_state(t(f)))}
    res["syn_q"], res["syn_u"] = map(_n, msh.synthesis_spin2_state(t(e),
                                                                   t(b)))
    res["adj_e"], res["adj_b"] = map(
        _n, msh.adjoint_synthesis_spin2_state(t(q), t(u)))
    res["ana0"] = _n(msh.analysis_state(t(f)))
    res["ana_e"], res["ana_b"] = map(_n, msh.analysis_spin2_state(t(q),
                                                                  t(u)))
    return res


def split_transforms(rank, world, lmax, inputs):
    """Spin-0 and spin-2 synthesis, adjoint and analysis of the ring-split
    GL and HEALPix (nside 8) transforms m-sharded over a (1, world) mesh;
    ``inputs`` {kind: (x, f, e, b, q, u)}."""
    mesh = make_mesh(1, world, device_type="cpu")
    t = lambda a: torch.as_tensor(a)
    res = {}
    for kind, (x, f, e, b, q, u) in inputs.items():
        sht = (make_sht(lmax, dtype=F64, spin2=True, device="cpu",
                        ring_split=True) if kind == "gl" else
               make_healpix_sht(8, lmax, dtype=F64, spin2=True, device="cpu",
                                ring_split=True))
        msh = shard_sht(sht, mesh)
        tabs = (msh.lam0, msh.lam_w, msh.lam_x)
        res[f"{kind}_rows"] = np.array([tb.shape[0] for tb in tabs])
        res[f"{kind}_nh"] = np.array([tb.shape[2] for tb in tabs])
        res[f"{kind}_ms"] = _n(msh._ms)
        res[f"{kind}_syn0"] = _n(msh.synthesis_state(t(x)))
        res[f"{kind}_adj0"] = _n(msh.adjoint_synthesis_state(t(f)))
        res[f"{kind}_ana0"] = _n(msh.analysis_state(t(f)))
        res[f"{kind}_syn_q"], res[f"{kind}_syn_u"] = map(
            _n, msh.synthesis_spin2_state(t(e), t(b)))
        res[f"{kind}_adj_e"], res[f"{kind}_adj_b"] = map(
            _n, msh.adjoint_synthesis_spin2_state(t(q), t(u)))
    return res


def table_pair_transforms(rank, world, lmax, pairs, inputs):
    """Spin-2 synthesis and adjoint of the GL transform, dense and
    ring-split, m-sharded over a (1, world) mesh and unsharded, for each
    (table dtype, compute dtype) name pair of ``pairs``; ``inputs`` (e,
    b, q, u) in float64, cast to the compute dtype."""
    mesh = make_mesh(1, world, device_type="cpu")
    res = {}
    for td, cd in pairs:
        dt = getattr(torch, cd)
        e, b, q, u = (torch.as_tensor(a).to(dt) for a in inputs)
        for split in (False, True):
            sht = make_sht(lmax, dtype=dt, spin2=True, device="cpu",
                           ring_split=split, table_dtype=td)
            msh = shard_sht(sht, mesh)
            key = f"{td}_{cd}_{int(split)}"
            res[f"{key}_dtype"] = np.array(
                [str(msh.lam0.dtype) == f"torch.{td}"])
            for who, tr in (("sharded", msh), ("full", sht)):
                sq, su = tr.synthesis_spin2_state(e, b)
                ae, ab = tr.adjoint_synthesis_spin2_state(q, u)
                for k, v in (("q", sq), ("u", su), ("e", ae), ("b", ab)):
                    res[f"{key}_{who}_{k}"] = _n(v).astype(np.float64)
    return res


def _scheme(model, spec):
    bins_list = [np.asarray(b) for b in spec["bins"]]
    if spec["scheme"] == "asis":
        return ASISGibbs(model, bins_list, spec["blocks"], spec["sig"],
                         n_iter_mh=1, cr_method=spec["cr"])
    return CenteredGibbs(model, bins_list, cr_method=spec["cr"],
                         cr_options=spec.get("opts", {}))


def sharded_chains(rank, world, arrays, spec):
    """``spec["scheme"]`` on the model ``arrays`` (cut-decomposed when
    ``spec["cut"]``) with its transforms m-sharded over a ``spec["mesh"]``
    mesh, run by ``sharded_run``; beside it the unsharded model's
    ``scheme.run`` of the same chains with the same generator."""
    model = model_from_numpy(arrays, device="cpu")
    if spec.get("cut"):
        model = with_cut_decomposition(model)
    mesh = make_mesh(*spec["mesh"], device_type="cpu")
    msh = dataclasses.replace(
        model, sht=shard_sht(model.sht, mesh),
        cut_sht=(None if model.cut_sht is None
                 else shard_sht(model.cut_sht, mesh)))
    sch_s, sch_u = _scheme(msh, spec), _scheme(model, spec)
    nchains, seed, n_iter = spec["nchains"], spec["seed"], spec["n_iter"]
    out = sharded_run(sch_s, spec["dl0"], n_iter=n_iter, nchains=nchains,
                      mesh=mesh, seed=seed)
    c = mesh.get_local_rank("chains")
    gen = torch.Generator().manual_seed(chain_seed(seed, c))
    ref = sch_u.run(spec["dl0"], n_iter=n_iter,
                    nchains=nchains // spec["mesh"][0], gen=gen)
    return {**_run_arrays(out, "s_"), **_run_arrays(ref, "u_"),
            "coord": np.array([c, mesh.get_local_rank("m")]),
            "cut_mh": np.array([bool(getattr(sch_s, "_use_cut_mh", False)),
                                bool(getattr(sch_u, "_use_cut_mh", False))]),
            "rows": np.array(_table_rows(msh.sht))}
