"""Triangular Legendre contractions: hand-written CUDA kernels and their
plain PyTorch versions.

Counterparts of ``gibbssampler_tpu/sht/pallas_legendre.py`` with the same
names and math:

    legendre_synth_tri(lam, x):  out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
    legendre_adj_tri(lam, g):    out[m, c, l] = sum_r lam[m, l, r] g[m, r, c]
                                 (zero for l < m)

    lam (L, L, nr) [m, l, r], contiguous, zero for l < m;
    x (L, C, L) with unit stride on l (any m and c strides);
    g (L, nr, C) with unit stride on r or on c.

Synthesis returns a contiguous (L, nr, C) tensor; the adjoint returns its
(L, C, L) result as a view of a contiguous (C, L, L) [c, m, l] buffer, the
order of the state's grids.

The m-slab form: with ``ms``, an int32 tensor of M <= L degree orders on
the operands' device, lam is an (M, L, nr) slab of rows of a table, x
(M, C, L) and g (M, nr, C), and row i is of degree order ms[i]:

    out[i, r, c] = sum_{l >= ms[i]} lam[i, l, r] x[i, c, l]
    out[i, c, l] = sum_r lam[i, l, r] g[i, r, c]   (zero for l < ms[i])

with outputs (M, nr, C) and (M, C, L).  An m-sharded transform
(``parallel.shard_sht``) holds and launches only its rows so; ``ms=None``
is the full table (M = L, ms[i] = i).  Each ms[i] must lie in [0, L); the
plain versions check it, the kernels read it as given.  So ``sht.lcore`` passes the state's grids as a
permuted view, and gets them back the same way, without copying the batch.
Any other layout raises ``ValueError``, on the CPU as on the card.

The ring-parity mode (the ``_par`` functions), for a grid whose ring
nr-1-r mirrors ring r about the equator: lam is (M, L, nh), the table at
the nh = ceil(nr / 2) north rings (the equator last when nr is odd), and
with lam_lm(pi - theta) = f (-1)^(l+m) lam_lm(theta), f = -1 for a table
of the opposite reflection parity (``flip``, the spin-2 X table) and +1
otherwise,

    legendre_synth_par(lam, x, nr, flip):
        out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]        (r < nh)
        out[m, nr-1-r, c] = sum_{l >= m} f (-1)^(l+m) lam[m, l, r] x[m, c, l]
    legendre_adj_par(lam, g, flip):
        out[m, c, l] = sum_{r < nh} lam[m, l, r] (g[m, r, c]
                       + f (-1)^(l+m) g[m, nr-1-r, c])  (the equator once)

the dense kernels' functions on the full (L, L, nr) table, computed from
the half one: each kernel reads a table entry once and keeps the sums over
even and odd l - m apart.  These are the JAX package's split contractions
(``gibbssampler_tpu/sht/lcore.py`` ``_lsynth_stack_sym`` /
``_ladj_stack_sym``, einsums there).  Layouts, the slab form and the
outputs are those of the dense kernels.

The bfloat16 table mode (the JAX package's ``table_dtype=bfloat16``):
lam in bfloat16 with x or g in float32, the output float32.  It is the
JAX contraction ``einsum(lam, b.astype(bfloat16),
preferred_element_type=float32)``: the batch is rounded to bfloat16 (to
nearest, ties to even), the products of the rounded values are exact in
float32 and are summed in float32.  The parity adjoint forms its fold
g[r] + f (-1)^(l+m) g[nr-1-r] in float32 and rounds the fold, as the JAX
package's ``U = (Gn + Gs).astype(table_dtype)`` does.  Any other pair of
dtypes than (float32, float32), (float64, float64) and (bfloat16,
float32) raises ``TypeError``.

The kernels (``csrc/``; design and bounds are noted in each source) are
compiled with nvcc for sm_90a at first use, into ``_build/`` beside the
package, keyed by a hash of every source and the flags, and loaded with
ctypes: ``legendre_tri.cu`` holds the float32 kernels (3xTF32 on the tensor
cores), ``legendre_tri_f64.cu`` the float64 ones (streaming the table
through a ``cp.async`` ring to the FMA pipes), ``legendre_tri_bf16.cu``
the bfloat16-table ones (bf16 ``mma.sync`` with float32 accumulation).  A
wrapper takes the plain ``torch.einsum`` version only for tensors on the
CPU; for CUDA tensors it launches its kernel or raises.  Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (the parity wrappers
apart from the dense ones), those of the float64 kernel alone also in
``<wrapper>.launches_f64`` and those of the bfloat16 one in
``<wrapper>.launches_bf16``, and each launch once more by its shape: a
full-table launch in ``<wrapper>.shapes`` ({(L, nr, C, table dtype):
launches}), a slab launch in ``<wrapper>.slabs`` ({(L, M, nr, C, table
dtype): launches}).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

__all__ = ["legendre_synth_tri", "legendre_adj_tri",
           "legendre_synth_tri_plain", "legendre_adj_tri_plain",
           "legendre_synth_par", "legendre_adj_par",
           "legendre_synth_par_plain", "legendre_adj_par_plain",
           "build", "f32_dynamic_smem", "bf16_dynamic_smem",
           "reset_launch_counts"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (lam, b, out, L, nr, C, strides, ms, M, stream); ms NULL for the full table
_SYNTH_ARGS = [_P] * 3 + [_I] * 3 + [_LL] * 2 + [_P, _I, _P]
_ADJ_ARGS = [_P] * 3 + [_I] * 3 + [_LL] * 5 + [_P, _I, _P]
# the parity modes: (..., ms, M, flip, stream)
_SYNTH_PAR_ARGS = _SYNTH_ARGS[:-1] + [_I, _P]
_ADJ_PAR_ARGS = _ADJ_ARGS[:-1] + [_I, _P]
# source (csrc/<stem>.cu) -> its entry points and their argument types
_LIBS = {
    "legendre_tri": {"legendre_synth_tri_f32": _SYNTH_ARGS,
                     "legendre_adj_tri_f32": _ADJ_ARGS,
                     "legendre_synth_par_f32": _SYNTH_PAR_ARGS,
                     "legendre_adj_par_f32": _ADJ_PAR_ARGS,
                     "legendre_tri_f32_smem": [_I]},
    "legendre_tri_f64": {"legendre_synth_tri_f64": _SYNTH_ARGS,
                         "legendre_adj_tri_f64": _ADJ_ARGS,
                         "legendre_synth_par_f64": _SYNTH_PAR_ARGS,
                         "legendre_adj_par_f64": _ADJ_PAR_ARGS,
                         "legendre_tri_f64_plan": [_I] * 3},
    "legendre_tri_bf16": {"legendre_synth_tri_bf16": _SYNTH_ARGS,
                          "legendre_adj_tri_bf16": _ADJ_ARGS,
                          "legendre_synth_par_bf16": _SYNTH_PAR_ARGS,
                          "legendre_adj_par_bf16": _ADJ_PAR_ARGS,
                          "legendre_tri_bf16_smem": [_I]},
}
# the (table, batch) dtype pairs the kernels take -> entry-point suffix
_SUFFIX = {(torch.float32, torch.float32): "f32",
           (torch.float64, torch.float64): "f64",
           (torch.bfloat16, torch.float32): "bf16"}
_fns: dict = {}
_loaded = {"tag": None}  # the build whose entry points are in _fns


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the Legendre kernels")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def _build_tag(flags: tuple) -> str:
    """Hash of the nvcc flags and every source under ``csrc/``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(defines: tuple = ()) -> dict:
    """Compile the kernel sources that have no build for the current
    sources and flags (one nvcc each, all started together) and load them.
    ``defines`` ("NAME=VALUE") are passed to nvcc as -D flags; the build
    they make replaces the entry points in use until ``build()`` is called
    again without them (``chip_smoke.py --f64-parts`` times the float64
    kernels' parts so).  Returns {source stem: (path of the shared library,
    the compiler's report, with ptxas's registers and shared memory per
    kernel; empty when an existing build was reused)}."""
    flags = (*_NVCC_FLAGS, *(f"-D{d}" for d in defines))
    tag = _build_tag(flags)
    sos = {stem: _BUILD_DIR / f"{stem}_{tag}.so" for stem in _LIBS}
    reports = dict.fromkeys(sos, "")
    procs = {}
    for stem, so in sos.items():
        if so.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp),
               str(_CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp)
    failed = []
    for stem, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu ({proc.returncode}):\n{out}{err}")
        else:
            os.replace(tmp, sos[stem])
            reports[stem] = out + err
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    if _loaded["tag"] != tag:
        for stem, entries in _LIBS.items():
            lib = ctypes.CDLL(str(sos[stem]))
            for name, argtypes in entries.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
        _loaded["tag"] = tag
    return {stem: (sos[stem], reports[stem]) for stem in sos}


def f32_dynamic_smem() -> dict:
    """Dynamic shared memory (bytes) of each float32 kernel; builds first."""
    if not _fns:
        build()
    fn = _fns["legendre_tri_f32_smem"]
    return {"synth": fn(0), "adj unit-r g": fn(1), "adj unit-c g": fn(2)}


def bf16_dynamic_smem() -> dict:
    """Dynamic shared memory (bytes) of each bfloat16-table kernel; builds
    first."""
    if not _fns:
        build()
    fn = _fns["legendre_tri_bf16_smem"]
    return {kind: fn(k) for k, kind in enumerate(
        ("synth", "adj unit-r g", "adj unit-c g", "synth par",
         "adj par unit-r g", "adj par unit-c g"))}


def f64_plan(nr: int, C: int) -> dict:
    """Threads per block and dynamic shared memory (bytes) of each float64
    kernel's launch at nr rings and C columns; builds first."""
    if not _fns:
        build()
    fn = _fns["legendre_tri_f64_plan"]
    return {kind: {"threads": v >> 20, "smem": v & 0xFFFFF}
            for kind, v in (("synth", fn(0, nr, C)), ("adj", fn(1, nr, C)))}


def reset_launch_counts() -> None:
    for fn in (legendre_synth_tri, legendre_adj_tri, legendre_synth_par,
               legendre_adj_par):
        fn.launches = fn.launches_f64 = fn.launches_bf16 = 0
        fn.shapes = collections.Counter()
        fn.slabs = collections.Counter()


# ---------------------------------------------------------------------------
# plain versions (CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _tri_rows(lam: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
    """The slab lam (M, L, nr) with l < ms[i] set to zero explicitly."""
    L = lam.shape[1]
    if ms.numel() and (int(ms.min()) < 0 or int(ms.max()) >= L):
        raise ValueError(f"ms outside [0, {L}): {ms.tolist()}")
    keep = torch.arange(L, device=lam.device)[None, :] >= ms.to(
        lam.device, torch.int64)[:, None]
    return lam * keep[:, :, None].to(lam.dtype)


def _dtypes(name: str, lam: torch.Tensor, b: torch.Tensor) -> str:
    """The entry-point suffix of the pair (lam, b); TypeError for a pair
    no kernel takes."""
    try:
        return _SUFFIX[(lam.dtype, b.dtype)]
    except KeyError:
        raise TypeError(f"{name}: dtypes {lam.dtype}, {b.dtype}; the "
                        "kernels take float32 or float64 for both, or a "
                        "bfloat16 table with a float32 batch") from None


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16 (to nearest, ties to even),
    back in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _plain_operands(name: str, lam: torch.Tensor, b: torch.Tensor):
    """(lam, b) as the plain versions contract them: a bfloat16 table
    upcast to float32 and the float32 batch rounded to bfloat16, so that
    the float32 einsum forms the kernel's exact products (never an einsum
    on bfloat16 tensors, whose result would be rounded to bfloat16)."""
    if _dtypes(name, lam, b) == "bf16":
        return lam.float(), _bf16_round(b)
    return lam, b


def legendre_synth_tri_plain(lam: torch.Tensor, x: torch.Tensor,
                             ms: torch.Tensor | None = None) -> torch.Tensor:
    lam, x = _plain_operands("legendre_synth_tri", lam, x)
    if ms is not None:
        lam = _tri_rows(lam, ms)
    return torch.einsum("mlr,mcl->mrc", lam, x)


def legendre_adj_tri_plain(lam: torch.Tensor, g: torch.Tensor,
                           ms: torch.Tensor | None = None) -> torch.Tensor:
    lam, g = _plain_operands("legendre_adj_tri", lam, g)
    if ms is not None:
        lam = _tri_rows(lam, ms)
    return torch.einsum("mlr,mrc->mcl", lam, g)


def _parity_halves(lam: torch.Tensor, ms: torch.Tensor | None):
    """(lam with l - m odd set to zero, lam with l - m even set to zero),
    with the slab's triangle l < ms[i] zero too."""
    M, L = lam.shape[:2]
    if ms is not None:
        lam = _tri_rows(lam, ms)
        m = ms.to(lam.device, torch.int64)
    else:
        m = torch.arange(M, device=lam.device)
    odd = ((torch.arange(L, device=lam.device)[None, :] - m[:, None]) % 2
           ).to(lam.dtype)[:, :, None]
    return lam * (1 - odd), lam * odd


def legendre_synth_par_plain(lam: torch.Tensor, x: torch.Tensor, nr: int,
                             flip: bool = False,
                             ms: torch.Tensor | None = None) -> torch.Tensor:
    nh = lam.shape[2]
    lam, x = _plain_operands("legendre_synth_par", lam, x)
    lam_e, lam_o = _parity_halves(lam, ms)
    se = torch.einsum("mlr,mcl->mrc", lam_e, x)
    so = torch.einsum("mlr,mcl->mrc", lam_o, x)
    south = (so - se if flip else se - so)[:, : nr - nh].flip(1)
    return torch.cat([se + so, south], dim=1)


def legendre_adj_par_plain(lam: torch.Tensor, g: torch.Tensor,
                           flip: bool = False,
                           ms: torch.Tensor | None = None) -> torch.Tensor:
    nh = lam.shape[2]
    bf16 = _dtypes("legendre_adj_par", lam, g) == "bf16"
    gn = g[:, :nh]
    # the south mirror of north ring r < nr - nh; none for the equator
    gs = torch.zeros_like(gn)
    gs[:, : g.shape[1] - nh] = g[:, nh:].flip(1)
    if flip:
        gs = -gs
    u, v = gn + gs, gn - gs
    if bf16:
        # the fold in float32, then rounded (JAX's (Gn + Gs).astype(td))
        lam, u, v = lam.float(), _bf16_round(u), _bf16_round(v)
    lam_e, lam_o = _parity_halves(lam, ms)
    return (torch.einsum("mlr,mrc->mcl", lam_e, u)
            + torch.einsum("mlr,mrc->mcl", lam_o, v))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _unit(t: torch.Tensor, dim: int) -> bool:
    return t.stride(dim) == 1 or t.shape[dim] == 1


def _check_layout(kind: str, lam: torch.Tensor, b: torch.Tensor,
                  ms: torch.Tensor | None = None,
                  nr: int | None = None) -> None:
    """Shapes and the layouts the kernels take; raises ValueError.  ``nr``:
    the output's rings (the synthesis parity mode), of which lam holds the
    ceil(nr / 2) north ones."""
    name = f"legendre_{kind}_{'tri' if nr is None else 'par'}"
    M, L, nt = lam.shape
    C = b.shape[1] if kind == "synth" else b.shape[-1]
    if kind == "adj" and nr is not None:
        nr = b.shape[1]
    want = (M, C, L) if kind == "synth" else (M, nr or nt, C)
    if (M != L if ms is None else M > L) or tuple(b.shape) != want:
        raise ValueError(f"{name}: lam {tuple(lam.shape)} and "
                         f"{tuple(b.shape)} do not match (M, L, nr), "
                         f"{'(M, C, L)' if kind == 'synth' else '(M, nr, C)'}"
                         f" with M {'= L' if ms is None else '<= L'}")
    if nr is not None and (nr + 1) // 2 != nt:
        raise ValueError(f"{name}: lam {tuple(lam.shape)} holds {nt} rings,"
                         f" not the ceil({nr} / 2) north ones of {nr}")
    if ms is not None and (ms.dtype != torch.int32 or ms.dim() != 1
                           or ms.shape[0] != M or not ms.is_contiguous()
                           or ms.device != lam.device):
        raise ValueError(f"{name}: ms must be a contiguous "
                         f"int32 vector of the {M} slab rows on "
                         f"{lam.device}, not {ms.dtype} {tuple(ms.shape)} "
                         f"on {ms.device}")
    if not lam.is_contiguous():
        raise ValueError(f"{name}: lam must be contiguous")
    if kind == "synth" and not _unit(b, 2):
        raise ValueError(f"{name}: x strides {b.stride()}; the "
                         "l axis must have unit stride")
    if kind == "adj" and not (_unit(b, 1) or _unit(b, 2)):
        raise ValueError(f"{name}: g strides {b.stride()}; the r "
                         "or the c axis must have unit stride")


def _launch(kind: str, lam: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor, ms: torch.Tensor | None,
            nr: int | None = None, flip: bool = False) -> None:
    """One launch; ``nr`` (the output's rings) selects the parity mode."""
    if not _fns:
        build()
    fn = _fns[f"legendre_{kind}_{'tri' if nr is None else 'par'}_"
              f"{_SUFFIX[(lam.dtype, b.dtype)]}"]
    M, L, nt = lam.shape
    # strides of size-1 axes are free in torch; the kernels index them at 0
    sb = [1 if size == 1 else s for size, s in zip(b.shape, b.stride())]
    if kind == "synth":
        C, args = b.shape[1], sb[:2]
    else:
        C, args = b.shape[2], sb + [out.stride(0), out.stride(1)]
    tail = [] if nr is None else [int(flip)]
    with torch.cuda.device(lam.device):
        stream = torch.cuda.current_stream(lam.device).cuda_stream
        err = fn(lam.data_ptr(), b.data_ptr(), out.data_ptr(), L,
                 nt if nr is None else nr, C, *args,
                 None if ms is None else ms.data_ptr(), M, *tail, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed with "
                           f"CUDA error {err}")


def _count(fn, lam: torch.Tensor, nr: int, C: int, ms) -> None:
    """One launch of ``fn``'s kernel on ``lam`` at (nr, C), nr the output's
    rings."""
    M, L = lam.shape[:2]
    fn.launches += 1
    fn.launches_f64 += lam.dtype == torch.float64
    fn.launches_bf16 += lam.dtype == torch.bfloat16
    if ms is None:
        fn.shapes[(L, nr, C, lam.dtype)] += 1
    else:
        fn.slabs[(L, M, nr, C, lam.dtype)] += 1


def _check_card(name: str, lam: torch.Tensor, b: torch.Tensor) -> None:
    if lam.device != b.device or lam.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {lam.device} and "
                         f"{b.device}; both must be on one CUDA device")
    _dtypes(name, lam, b)


def legendre_synth_tri(lam: torch.Tensor, x: torch.Tensor,
                       ms: torch.Tensor | None = None) -> torch.Tensor:
    """out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l].
    lam: (L, L, nr); x: (L, C, L), unit stride on l -> (L, nr, C).  With
    ``ms`` (M,) the slab form: lam (M, L, nr), x (M, C, L) -> (M, nr, C),
    row i of degree order ms[i]."""
    _check_layout("synth", lam, x, ms)
    if lam.device.type == "cpu" and x.device.type == "cpu":
        return legendre_synth_tri_plain(lam, x, ms)
    _check_card("legendre_synth_tri", lam, x)
    M, _, nr = lam.shape
    out = torch.empty((M, nr, x.shape[1]), dtype=x.dtype, device=lam.device)
    if out.numel():
        _launch("synth", lam, x, out, ms)
        _count(legendre_synth_tri, lam, nr, x.shape[1], ms)
    return out


def legendre_adj_tri(lam: torch.Tensor, g: torch.Tensor,
                     ms: torch.Tensor | None = None) -> torch.Tensor:
    """out[m, c, l] = sum_r lam[m, l, r] g[m, r, c], zero for l < m.
    lam: (L, L, nr); g: (L, nr, C), unit stride on r or c -> (L, C, L),
    a view of a contiguous (C, L, L) tensor.  With ``ms`` (M,) the slab
    form: lam (M, L, nr), g (M, nr, C) -> (M, C, L), a view of a (C, M, L)
    tensor, row i of degree order ms[i]."""
    _check_layout("adj", lam, g, ms)
    if lam.device.type == "cpu" and g.device.type == "cpu":
        # the kernel's layout: (C, M, L) memory
        return legendre_adj_tri_plain(lam, g, ms).transpose(0, 1) \
            .contiguous().transpose(0, 1)
    _check_card("legendre_adj_tri", lam, g)
    M, L, nr = lam.shape
    C = g.shape[2]
    out = torch.empty((C, M, L), dtype=g.dtype,
                      device=lam.device).transpose(0, 1)
    if out.numel():
        _launch("adj", lam, g, out, ms)
        _count(legendre_adj_tri, lam, nr, C, ms)
    return out


def legendre_synth_par(lam: torch.Tensor, x: torch.Tensor, nr: int,
                       flip: bool = False,
                       ms: torch.Tensor | None = None) -> torch.Tensor:
    """The ring-parity synthesis (module docstring): lam (L, L, nh) at the
    nh = ceil(nr / 2) north rings, x (L, C, L) with unit stride on l ->
    (L, nr, C) over all nr rings.  With ``ms`` (M,) the slab form, as
    ``legendre_synth_tri``'s."""
    _check_layout("synth", lam, x, ms, nr)
    if lam.device.type == "cpu" and x.device.type == "cpu":
        return legendre_synth_par_plain(lam, x, nr, flip, ms)
    _check_card("legendre_synth_par", lam, x)
    M = lam.shape[0]
    out = torch.empty((M, nr, x.shape[1]), dtype=x.dtype, device=lam.device)
    if out.numel():
        _launch("synth", lam, x, out, ms, nr, flip)
        _count(legendre_synth_par, lam, nr, x.shape[1], ms)
    return out


def legendre_adj_par(lam: torch.Tensor, g: torch.Tensor, flip: bool = False,
                     ms: torch.Tensor | None = None) -> torch.Tensor:
    """The ring-parity adjoint (module docstring): lam (L, L, nh), g (L,
    nr, C) with nh = ceil(nr / 2) and unit stride on r or c -> (L, C, L), a
    view of a contiguous (C, L, L) tensor.  With ``ms`` (M,) the slab form,
    as ``legendre_adj_tri``'s."""
    _check_layout("adj", lam, g, ms, g.shape[1])
    if lam.device.type == "cpu" and g.device.type == "cpu":
        return legendre_adj_par_plain(lam, g, flip, ms).transpose(0, 1) \
            .contiguous().transpose(0, 1)
    _check_card("legendre_adj_par", lam, g)
    M, L = lam.shape[:2]
    nr, C = g.shape[1], g.shape[2]
    out = torch.empty((C, M, L), dtype=g.dtype,
                      device=lam.device).transpose(0, 1)
    if out.numel():
        _launch("adj", lam, g, out, ms, nr, flip)
        _count(legendre_adj_par, lam, nr, C, ms)
    return out


reset_launch_counts()
