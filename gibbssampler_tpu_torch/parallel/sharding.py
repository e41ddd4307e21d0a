"""Process sharding of the chains and of the SHT's m axis (PyTorch
counterpart of ``gibbssampler_tpu.parallel.sharding``).

The reference's parallelism is a SLURM array of independent processes
(job-script.sh:6, SURVEY.md 2.5).  Here one process runs per card, the
processes form a ``torch.distributed`` device mesh with dims
("chains", "m"), and the port's kernels run on each process's own tensors
(no DTensor: they are launched on raw pointers):

- **chains**: each coordinate along "chains" runs its own ``nchains /
  n_chains`` chains, drawn from its own generator (``sharded_run``); the
  chains come together with ``gather_chains``, pooled statistics with
  ``parallel.collectives`` over ``mesh.get_group("chains")``.
- **m**: within an "m" group each process holds only its slab of every
  Legendre table (``shard_sht``): it launches the kernels in their m-slab
  form on its own rows and all-gathers the result; the ring DFTs, the
  samplers and the chains stay replicated across the group.

The random streams are not JAX's.  JAX gives every chain its own key, so
a sharded run equals the unsharded one chain for chain.  The port draws
all chains of a call from one generator, so a chain's numbers depend on
how many chains share the call: a chain-sharded run equals, process by
process, the unsharded ``scheme.run`` of that process's chains with its
generator (``chain_seed``), and within an m group every process draws the
same numbers.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..sht.lcore import LegendreCore
from ..sht.legendre_kernels import legendre_adj_tri, legendre_synth_tri

__all__ = ["make_mesh", "chain_sharding", "chain_seed", "shard_sht",
           "sharded_run", "gather_chains", "m_rows"]

_TABLES = ("lam0", "lam_p2", "lam_m2", "lam_w", "lam_x")


def make_mesh(n_chains: int | None = None, n_m: int = 1,
              device_type: str = "cuda"):
    """A ``torch.distributed`` device mesh of shape (n_chains, n_m) with
    dims ("chains", "m") over the default process group (which must be
    initialized; n_chains defaults to world size / n_m).  ``device_type``
    is the mesh's: "cuda" over NCCL, "cpu" over gloo (whose collectives
    also take CUDA tensors)."""
    world = dist.get_world_size()
    if n_chains is None:
        n_chains = world // n_m
    if n_chains * n_m != world:
        raise ValueError(f"mesh {n_chains} x {n_m} does not cover the "
                         f"{world} processes")
    return init_device_mesh(device_type, (n_chains, n_m),
                            mesh_dim_names=("chains", "m"))


def chain_sharding(mesh, nchains: int) -> slice:
    """This process's range of the ``nchains`` global chains: the
    contiguous block of its "chains" coordinate.  Raises ValueError when
    nchains is not divisible by the "chains" extent."""
    n = mesh.size(mesh.mesh_dim_names.index("chains"))
    if nchains % n:
        raise ValueError(f"nchains={nchains} not divisible by chains axis "
                         f"size {n}")
    k = nchains // n
    c = mesh.get_local_rank("chains")
    return slice(c * k, (c + 1) * k)


def chain_seed(seed: int, coordinate: int) -> int:
    """The generator seed of "chains" coordinate ``coordinate``:
    (seed + coordinate * 0x9E3779B9) mod 2**32.  Coordinate 0 takes
    ``seed`` itself (for 0 <= seed < 2**32), so a run on one process equals
    ``scheme.run`` with a generator seeded with ``seed``.  The seeds stay
    within 32 bits because the CPU generator keeps only those."""
    return (int(seed) + int(coordinate) * 0x9E3779B9) % 2 ** 32


def sharded_run(scheme, dl_init_tuple, n_iter: int, nchains: int, mesh,
                seed: int) -> dict:
    """``scheme.run`` of this process's ``nchains / n_chains`` chains (the
    range ``chain_sharding`` gives), from a generator on the scheme's
    device seeded with ``chain_seed(seed, c)``, c this process's "chains"
    coordinate: every process of an "m" group draws the same numbers and
    holds the same chains.  Returns the local run's output;
    ``gather_chains`` brings all chains together."""
    sl = chain_sharding(mesh, nchains)
    gen = torch.Generator(device=scheme.device)
    gen.manual_seed(chain_seed(seed, mesh.get_local_rank("chains")))
    return scheme.run(dl_init_tuple, n_iter=n_iter,
                      nchains=sl.stop - sl.start, gen=gen)


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The group's ``t``s (equal shapes) stacked along a new leading axis,
    in group-rank order, on t's device."""
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def gather_chains(out, mesh):
    """A ``sharded_run`` output (or any nest of tuples, named tuples and
    dicts of tensors with the chains on axis 0) with every tensor
    all-gathered over the "chains" group along axis 0: the global chains
    in coordinate order, on every process."""
    group = mesh.get_group("chains")
    n = dist.get_world_size(group)
    if n == 1:
        return out

    def gather(x):
        if isinstance(x, torch.Tensor):
            return _all_gather(x, group, n).flatten(0, 1)
        if isinstance(x, dict):
            return {k: gather(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(gather(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(gather(v) for v in x)
        return x
    return gather(out)


# ---------------------------------------------------------------------------
# the m-sharded transform
# ---------------------------------------------------------------------------

def m_rows(L: int, n_m: int) -> list:
    """The degree orders each of ``n_m`` processes holds of an L-row table.
    The units (m, L-1-m), and the middle m of an odd L alone, are dealt
    round-robin; a process lists its pairs' small m ascending, its middle
    m, then the large m descending, so that rows i and M-1-i hold one pair
    (the float64 synthesis kernel runs the rows i and M-1-i of a slab in
    one block) and each pair is L + 1 degree rows of work.  A process
    holds at most 2 ceil(L / (2 n_m)) rows."""
    units = [(m, L - 1 - m) for m in range(L // 2)]
    if L % 2:
        units.append((L // 2,))
    rows = []
    for k in range(n_m):
        mine = units[k::n_m]
        pairs = [u for u in mine if len(u) == 2]
        rows.append([u[0] for u in pairs]
                    + [u[0] for u in mine if len(u) == 1]
                    + [u[1] for u in reversed(pairs)])
    return rows


class _MSlab:
    """The Legendre stage of an m-sharded ``LegendreCore`` copy: the
    tables hold this process's rows ``_ms`` only; the kernels run on them
    in their m-slab form and the rows are all-gathered over the "m" group,
    each padded to ``_mpad`` rows, and put back in m order (``_mpos``).
    A ring-split transform holds its rows of the half-ring tables and
    launches the kernels' parity mode on them, in its slab form."""

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This process's rows (M, ...) -> all L rows in m order."""
        pad = self._mpad - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
        if self._nm > 1:
            t = _all_gather(t, self._mgroup, self._nm).flatten(0, 1)
        return t.index_select(0, self._mpos)

    def _lsynth_stack(self, lam: torch.Tensor, g2: torch.Tensor,
                      flip: bool = False) -> torch.Tensor:
        L = self.lmax + 1
        batch = g2.shape[:-2]
        C = int(np.prod(batch))
        # this process's m rows of the (m, C, l) view: (M, C, l), contiguous
        x = g2.reshape(C, L, L).transpose(0, 1).index_select(0, self._mrow)
        if self.ring_split:
            F = self._synth_par(lam, x, flip, self._ms)
        else:
            F = legendre_synth_tri(lam, x, self._ms)
        F = self._gather_rows(F)
        return F.permute(2, 1, 0).reshape(batch + (F.shape[1], L))

    def _ladj_stack(self, lam: torch.Tensor, g: torch.Tensor,
                    flip: bool = False) -> torch.Tensor:
        L = self.lmax + 1
        batch = g.shape[:-2]
        nr = g.shape[-2]
        C = int(np.prod(batch))
        # this process's m columns in (m, C, r) order, as the (m, r, C) view
        gk = g.reshape(C, nr, L).permute(2, 0, 1) \
            .index_select(0, self._mrow).transpose(1, 2)
        a = (self._adj_par(lam, gk, flip, self._ms) if self.ring_split
             else legendre_adj_tri(lam, gk, self._ms))
        a = self._gather_rows(a)
        return a.transpose(0, 1).reshape(batch + (L, L))

    def lsel_table(self, lam: torch.Tensor, j_idx) -> torch.Tensor:
        """The full (L, J, nr) gather (the blocked-MH engines' contractions
        with it stay replicated)."""
        return self._gather_rows(super().lsel_table(lam, j_idx))


@functools.cache
def _sharded_class(cls):
    return type(f"MSharded{cls.__name__}", (_MSlab, cls),
                {"__module__": __name__})


def shard_sht(sht, mesh):
    """A copy of ``sht`` (an ``SHT``, a ``HealpixSHT``, a cut ``SHT``: any
    ``LegendreCore`` transform) that holds only this process's slab of
    every Legendre table: the rows ``m_rows(lmax + 1, n_m)`` deals to its
    "m" coordinate, at most 2 ceil(L / (2 n_m)) of the L rows.  Its
    transforms launch the kernels on the slab and all-gather the result
    over the mesh's "m" group, so every process of the group must call
    each of them together; their results equal the unsharded transform's.
    Drop ``sht`` to free the full tables.  A model's ``PointSHT`` (a few
    rows of hole points) may stay replicated, as in the JAX package."""
    if not isinstance(sht, LegendreCore) or isinstance(sht, _MSlab):
        raise TypeError(f"shard_sht takes an unsharded transform, not "
                        f"{type(sht).__name__}")
    group = mesh.get_group("m")
    n_m = dist.get_world_size(group)
    L = sht.lmax + 1
    rows = m_rows(L, n_m)
    mine = rows[mesh.get_local_rank("m")]
    mpad = max(len(r) for r in rows)
    pos = np.empty(L, dtype=np.int64)
    for k, r in enumerate(rows):
        pos[r] = k * mpad + np.arange(len(r))
    out = copy.copy(sht)
    out.__class__ = _sharded_class(type(sht))
    dev = sht.device
    out._ms = torch.as_tensor(mine, dtype=torch.int32, device=dev)
    out._mrow = out._ms.long()
    out._mpos = torch.as_tensor(pos, device=dev)
    out._mpad, out._nm, out._mgroup = mpad, n_m, group
    for name in _TABLES:
        tab = getattr(sht, name, None)
        if tab is not None:
            setattr(out, name, tab.index_select(0, out._mrow).contiguous())
    # the compute-dtype equator rows of a split table in another dtype,
    # sliced alike
    out.eq_rows = {name: row.index_select(0, out._mrow).contiguous()
                   for name, row in sht.eq_rows.items()}
    return out
