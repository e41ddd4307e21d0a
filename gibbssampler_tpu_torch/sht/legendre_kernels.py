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

The other table modes (the JAX package's ``table_dtype`` other than its
compute dtype): lam in bfloat16 or float16 with x or g in float32, lam in
bfloat16, float16 or float32 with x or g in float64 (narrow tables), or
lam in float64 with x or g in float32 (the wide table); the output in the
batch's dtype.  Each is the JAX contraction ``einsum(lam,
b.astype(lam.dtype), preferred_element_type=b.dtype)``.  A narrow table:
the batch is rounded to the table dtype (to nearest, ties to even; a
float64 value bound for bfloat16 is rounded to float32 first, as JAX's
and torch's conversions do; one bound for float16 is rounded once, as
JAX's is and torch's is not: ``cast_to``), the products of the rounded
values are exact in the batch's dtype and are summed in it.  The wide
table: the batch is widened exactly, the products are summed in float64
and each output is rounded once to float32; the parity synthesis rounds
its sums over even and odd l - m to float32 each before it combines them
in float32, as the JAX package's split synthesis does.  The parity
adjoint forms its fold g[r] + f (-1)^(l+m) g[nr-1-r] in the batch's dtype
and then rounds (or widens) the fold, as the JAX package's
``U = (Gn + Gs).astype(table_dtype)`` does.  Any other pair of dtypes than
those of ``_SUFFIX`` raises ``TypeError``.

The kernels (``csrc/``; design and bounds are noted in each source) are
compiled with nvcc for sm_90a at first use, into ``_build/`` beside the
package, keyed by a hash of every source and the flags, and loaded with
ctypes: ``legendre_tri.cu`` holds the float32 kernels (3xTF32 on the tensor
cores; the parity synthesis at the ring tile ``f32_par_synth_tile(nh)``
picks), ``legendre_tri_f64.cu`` the float64 ones (streaming the table
through a ``cp.async`` ring to the FMA pipes, both parity kernels to the
fp64 tensor cores), ``legendre_tri_bf16.cu`` the bfloat16-table ones (bf16
``mma.sync`` with float32 accumulation; the dense synthesis at the ring
tile ``bf16_synth_tile(nr)`` picks, the parity synthesis at the ring tile
``bf16_par_synth_tile(nh)`` picks), ``legendre_tri_f16.cu`` the
float16-table ones with a float32 batch (the bfloat16 source in its
float16 mode: f16 ``mma.sync``), ``legendre_tri_narrow_f64.cu`` those of
a bfloat16, float16 or float32 table with a float64 batch and those of a
float64 table with a float32 batch (the table kept in its own dtype in
shared memory and widened in registers, the batch staged in float64, all
on the fp64 tensor cores, their plans in ``narrow_plan(nr, C)``, the
parity synthesis' ring tiles those of ``narrow_par_synth_plan(nh, C)``).  A
wrapper takes the plain ``torch.einsum`` version only for tensors on the
CPU; for CUDA tensors it launches its kernel or raises.  Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (the parity wrappers
apart from the dense ones), those of the float64 kernel alone also in
``<wrapper>.launches_f64``, those of the bfloat16 one (float32 batch) in
``<wrapper>.launches_bf16``, those of the float16 one (float32 batch) in
``<wrapper>.launches_f16``, those of the narrow-table float64 ones in
``<wrapper>.launches_narrow`` and those of the float64 table with a
float32 batch in ``<wrapper>.launches_wide``, and each launch once more by
its shape: a full-table launch in ``<wrapper>.shapes`` ({(L, nr, C,
kernel dtype): launches}), a slab launch in ``<wrapper>.slabs`` ({(L, M,
nr, C, kernel dtype): launches}); the kernel dtype is the table's for the
float32, float64, bfloat16 and float16 kernels, else the pair (table
dtype, batch dtype).
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
           "build", "f32_dynamic_smem", "f32_blocks_per_sm",
           "bf16_dynamic_smem", "bf16_blocks_per_sm", "cast_to",
           "reset_launch_counts"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the entry-point suffixes of csrc/legendre_tri_narrow_f64.cu, in the order
# of its plan's table codes: a bfloat16, float32 or float16 table with a
# float64 batch, and a float64 table with a float32 batch
NARROW_SFX = ("bf16f64", "f32f64", "f16f64", "f64f32")
# (lam, b, out, L, nr, C, strides, ms, M, stream); ms NULL for the full table
_SYNTH_ARGS = [_P] * 3 + [_I] * 3 + [_LL] * 2 + [_P, _I, _P]
_ADJ_ARGS = [_P] * 3 + [_I] * 3 + [_LL] * 5 + [_P, _I, _P]
# the parity modes: (..., ms, M, flip, stream); the bfloat16 dense
# synthesis: (..., ms, M, ring tile, stream); the float32 and bfloat16
# parity syntheses: (..., ms, M, flip, ring tile, stream)
_SYNTH_PAR_ARGS = _SYNTH_ARGS[:-1] + [_I, _P]
_SYNTH_PAR_TILE_ARGS = _SYNTH_ARGS[:-1] + [_I, _I, _P]
_ADJ_PAR_ARGS = _ADJ_ARGS[:-1] + [_I, _P]
# source (csrc/<stem>.cu) -> its entry points and their argument types
_LIBS = {
    "legendre_tri": {"legendre_synth_tri_f32": _SYNTH_ARGS,
                     "legendre_adj_tri_f32": _ADJ_ARGS,
                     "legendre_synth_par_f32": _SYNTH_PAR_TILE_ARGS,
                     "legendre_adj_par_f32": _ADJ_PAR_ARGS,
                     "legendre_tri_f32_info": [_I, _I]},
    "legendre_tri_f64": {"legendre_synth_tri_f64": _SYNTH_ARGS,
                         "legendre_adj_tri_f64": _ADJ_ARGS,
                         "legendre_synth_par_f64": _SYNTH_PAR_ARGS,
                         "legendre_adj_par_f64": _ADJ_PAR_ARGS,
                         "legendre_tri_f64_plan": [_I] * 3},
    **{f"legendre_tri_{sfx}": {f"legendre_synth_tri_{sfx}": _SYNTH_PAR_ARGS,
                               f"legendre_adj_tri_{sfx}": _ADJ_ARGS,
                               f"legendre_synth_par_{sfx}":
                                   _SYNTH_PAR_TILE_ARGS,
                               f"legendre_adj_par_{sfx}": _ADJ_PAR_ARGS,
                               f"legendre_tri_{sfx}_info": [_I, _I]}
       for sfx in ("bf16", "f16")},
    "legendre_tri_narrow_f64": {
        **{f"legendre_{kind}_{sfx}": args
           for sfx in NARROW_SFX
           for kind, args in (("synth_tri", _SYNTH_ARGS),
                              ("adj_tri", _ADJ_ARGS),
                              ("synth_par", _SYNTH_PAR_ARGS),
                              ("adj_par", _ADJ_PAR_ARGS))},
        "legendre_tri_narrow_f64_plan": [_I] * 4},
}
# the (table, batch) dtype pairs the kernels take -> entry-point suffix
_SUFFIX = {(torch.float32, torch.float32): "f32",
           (torch.float64, torch.float64): "f64",
           (torch.bfloat16, torch.float32): "bf16",
           (torch.float16, torch.float32): "f16",
           (torch.bfloat16, torch.float64): "bf16f64",
           (torch.float32, torch.float64): "f32f64",
           (torch.float16, torch.float64): "f16f64",
           (torch.float64, torch.float32): "f64f32"}
# the ring tiles of the bfloat16 dense synthesis (csrc/legendre_tri_bf16.cu)
BF16_SYNTH_TILES = (80, 96, 128, 144)
# the ring tiles of the float32 parity synthesis (csrc/legendre_tri.cu)
F32_PAR_SYNTH_TILES = (64, 72, 80, 88)
# the ring tiles of the bfloat16 parity synthesis (csrc/legendre_tri_bf16.cu)
BF16_PAR_SYNTH_TILES = (128, 144)
# the float32 kernels in the order of legendre_tri_f32_info's kinds
_F32_KINDS = ("synth", "adj unit-r g", "adj unit-c g", "adj par unit-r g",
              "adj par unit-c g") + tuple(
    f"synth par tile {t}" for t in F32_PAR_SYNTH_TILES)
# the bfloat16-table kernels in the order of legendre_tri_bf16_info's kinds
_BF16_KINDS = tuple(f"synth tile {t}" for t in BF16_SYNTH_TILES) + (
    "adj unit-r g", "adj unit-c g") + tuple(
    f"synth par tile {t}" for t in BF16_PAR_SYNTH_TILES) + (
    "adj par unit-r g", "adj par unit-c g")
# legendre_tri_narrow_f64_plan's kinds of each kernel: threads << 20 |
# dynamic shared memory, resident blocks an SM, and a synthesis' ring tiles
# and rings a warp
_NARROW_PLAN_KINDS = {"synth": (0, 1, 2, 5), "adj": (3, 4),
                      "synth_par": (6, 7, 8, 9), "adj_par": (10, 11)}
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
    fn = _fns["legendre_tri_f32_info"]
    return {kind: fn(k, 0) for k, kind in enumerate(_F32_KINDS)}


def f32_blocks_per_sm() -> dict:
    """Resident blocks an SM of each float32 kernel on the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its threads and
    dynamic shared memory); builds first."""
    if not _fns:
        build()
    fn = _fns["legendre_tri_f32_info"]
    return {kind: fn(k, 1) for k, kind in enumerate(_F32_KINDS)}


def _fewest_tiles(tiles: tuple, n: int) -> int:
    """Of ``tiles``, the one that covers n with the fewest tiles, then the
    least padding."""
    return min(tiles, key=lambda t: (-(-n // t), t))


def bf16_synth_tile(nr: int) -> int:
    """The ring tile of the bfloat16 dense synthesis at nr rings: the one
    with the fewest tiles (each ring tile reads the batch again), then the
    least padding."""
    return _fewest_tiles(BF16_SYNTH_TILES, nr)


def f32_par_synth_tile(nh: int) -> int:
    """The ring tile of the float32 parity synthesis at nh north rings: the
    one with the fewest tiles (each ring tile stages the batch again), then
    the least padding."""
    return _fewest_tiles(F32_PAR_SYNTH_TILES, nh)


def bf16_par_synth_tile(nh: int) -> int:
    """The ring tile of the bfloat16 parity synthesis at nh north rings:
    the one with the fewest tiles (each ring tile stages the batch again),
    then the least padding."""
    return _fewest_tiles(BF16_PAR_SYNTH_TILES, nh)


def bf16_dynamic_smem(sfx: str = "bf16") -> dict:
    """Dynamic shared memory (bytes) of each bfloat16-table kernel (``sfx``
    "f16": the float16-table ones, the same source in its float16 mode);
    builds first."""
    if not _fns:
        build()
    fn = _fns[f"legendre_tri_{sfx}_info"]
    return {kind: fn(k, 0) for k, kind in enumerate(_BF16_KINDS)}


def bf16_blocks_per_sm(sfx: str = "bf16") -> dict:
    """Resident blocks an SM of each bfloat16-table kernel (``sfx`` "f16":
    the float16-table ones) on the current card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at its threads and
    dynamic shared memory); builds first."""
    if not _fns:
        build()
    fn = _fns[f"legendre_tri_{sfx}_info"]
    return {kind: fn(k, 1) for k, kind in enumerate(_BF16_KINDS)}


def f64_plan(nr: int, C: int) -> dict:
    """Threads per block and dynamic shared memory (bytes) of each float64
    kernel's launch at nr rings (the output's or g's, for the parity
    kernels) and C columns (the parity adjoint with g's unit stride on r),
    and each parity kernel's resident blocks an SM on the current card;
    builds first."""
    if not _fns:
        build()
    fn = _fns["legendre_tri_f64_plan"]
    plan = {kind: {"threads": v >> 20, "smem": v & 0xFFFFF}
            for kind, v in (("synth", fn(0, nr, C)), ("adj", fn(1, nr, C)),
                            ("synth par", fn(2, nr, C)),
                            ("adj par", fn(4, nr, C)))}
    plan["synth par"]["blocks_per_sm"] = fn(3, nr, C)
    plan["adj par"]["blocks_per_sm"] = fn(5, nr, C)
    return plan


def narrow_col_tile(C: int) -> int:
    """The column tile of the narrow-table float64 kernels at C columns:
    8, 16 or 32, so that the table is read once at every C <= 32."""
    return 8 if C <= 8 else 16 if C <= 16 else 32


def narrow_par_synth_plan(nh: int, C: int) -> dict:
    """The ring tiles of the narrow-table float64 parity synthesis at nh
    north rings and C columns, as its launcher picks them
    (``SynthParNarrowPlan`` in ``csrc/legendre_tri_narrow_f64.cu``; phase 2
    of chip_smoke.py holds the two equal): a warp holds 16 rings at 32
    columns (two m16 tiles of both classes' sums would take 128 registers)
    and while one block of at most 6 warps holds every ring, else 32; the
    fewest ring tiles of at most 6 warps, of sizes that differ by at most
    one ring.  Returns {"ring_tiles", "warps" (a block), "warp_rings"}."""
    wr = 16 if narrow_col_tile(C) == 32 or nh <= 16 * 6 else 32
    wt = -(-nh // wr)
    tiles = -(-wt // 6)
    return {"ring_tiles": tiles, "warps": -(-wt // tiles), "warp_rings": wr}


def narrow_plan(nr: int, C: int) -> dict:
    """The launches of ``csrc/legendre_tri_narrow_f64.cu``'s kernels at nr
    rings (the output's or g's, for the parity pair) and C columns, for
    each of its entry-point suffixes (``NARROW_SFX``): threads per block,
    dynamic shared memory (bytes) and resident blocks an SM on the current
    card of the dense pair ("synth", "adj") and the parity pair
    ("synth_par", "adj_par"), and each synthesis' ring tiles and rings a
    warp (the adjoints with g's unit stride on r); builds first."""
    if not _fns:
        build()
    fn = _fns["legendre_tri_narrow_f64_plan"]
    plan = {}
    for code, sfx in enumerate(NARROW_SFX):
        plan[sfx] = {}
        for name, kinds in _NARROW_PLAN_KINDS.items():
            v = fn(kinds[0], code, nr, C)
            plan[sfx][name] = {"threads": v >> 20, "smem": v & 0xFFFFF}
            for key, k in zip(("blocks_per_sm", "ring_tiles", "warp_rings"),
                              kinds[1:]):
                plan[sfx][name][key] = fn(k, code, nr, C)
    return plan


def reset_launch_counts() -> None:
    for fn in (legendre_synth_tri, legendre_adj_tri, legendre_synth_par,
               legendre_adj_par):
        fn.launches = fn.launches_f64 = fn.launches_bf16 = 0
        fn.launches_f16 = fn.launches_narrow = fn.launches_wide = 0
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
                        "kernels take float32 or float64 for both, a "
                        "bfloat16 or float16 table with a float32 batch, a "
                        "bfloat16, float16 or float32 table with a float64 "
                        "batch, or a float64 table with a float32 batch") \
            from None


def _f16_of_f64(t: torch.Tensor) -> torch.Tensor:
    """A float64 tensor in float16, rounded once (to nearest, ties to
    even): rounded to odd in float32 precision on its bits (the 29 low
    significand bits cleared, the lowest kept one set where any of them
    was; 24 bits, at least 11 + 2, so that the second rounding cannot land
    on a tie that the first made; a NaN stays a NaN), then to float16.
    torch's own conversion rounds to nearest twice, through float32, and
    misses values such as 1 + 2^-11 + 2^-40."""
    bits = t.view(torch.int64)
    low = 2 ** 29 - 1
    odd = (bits & ~low) | ((bits & low) != 0).to(torch.int64) << 29
    return odd.view(torch.float64).to(torch.float32).to(torch.float16)


def cast_to(t: torch.Tensor, td: torch.dtype) -> torch.Tensor:
    """``t`` in dtype ``td`` as the JAX package's ``astype`` gives it: one
    rounding to nearest, ties to even (float64 -> float16 included), but
    float64 -> bfloat16 through float32, as JAX (ml_dtypes) and torch both
    convert it."""
    if t.dtype == torch.float64 and td == torch.float16:
        return _f16_of_f64(t)
    return t.to(td)


def _round_to(t: torch.Tensor, td: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``td`` (``cast_to``), back in ``t``'s dtype."""
    return cast_to(t, td).to(t.dtype)


def _plain_operands(name: str, lam: torch.Tensor, b: torch.Tensor):
    """(lam, b) as the plain versions contract them, both in the wider of
    their dtypes: a narrow table upcast to the batch's dtype and the batch
    rounded to the table dtype, so that the einsum in the batch's dtype
    forms the kernel's exact products (never an einsum on narrow tensors,
    whose result would be rounded); a wide table as it is and the batch
    widened (the caller rounds the float64 result to the batch's
    dtype)."""
    _dtypes(name, lam, b)
    if lam.dtype.itemsize < b.dtype.itemsize:
        return lam.to(b.dtype), _round_to(b, lam.dtype)
    return lam, b.to(lam.dtype)


def legendre_synth_tri_plain(lam: torch.Tensor, x: torch.Tensor,
                             ms: torch.Tensor | None = None) -> torch.Tensor:
    dt = x.dtype
    lam, x = _plain_operands("legendre_synth_tri", lam, x)
    if ms is not None:
        lam = _tri_rows(lam, ms)
    return torch.einsum("mlr,mcl->mrc", lam, x).to(dt)


def legendre_adj_tri_plain(lam: torch.Tensor, g: torch.Tensor,
                           ms: torch.Tensor | None = None) -> torch.Tensor:
    dt = g.dtype
    lam, g = _plain_operands("legendre_adj_tri", lam, g)
    if ms is not None:
        lam = _tri_rows(lam, ms)
    return torch.einsum("mlr,mrc->mcl", lam, g).to(dt)


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
    nh, dt = lam.shape[2], x.dtype
    lam, x = _plain_operands("legendre_synth_par", lam, x)
    lam_e, lam_o = _parity_halves(lam, ms)
    # each class's sums in the batch's dtype, then combined in it
    se = torch.einsum("mlr,mcl->mrc", lam_e, x).to(dt)
    so = torch.einsum("mlr,mcl->mrc", lam_o, x).to(dt)
    south = (so - se if flip else se - so)[:, : nr - nh].flip(1)
    return torch.cat([se + so, south], dim=1)


def legendre_adj_par_plain(lam: torch.Tensor, g: torch.Tensor,
                           flip: bool = False,
                           ms: torch.Tensor | None = None) -> torch.Tensor:
    nh = lam.shape[2]
    _dtypes("legendre_adj_par", lam, g)
    gn = g[:, :nh]
    # the south mirror of north ring r < nr - nh; none for the equator
    gs = torch.zeros_like(gn)
    gs[:, : g.shape[1] - nh] = g[:, nh:].flip(1)
    if flip:
        gs = -gs
    u, v = gn + gs, gn - gs
    # the fold in g's dtype, then rounded or widened (JAX's
    # (Gn + Gs).astype(td)); each output is one class's sum
    v = _plain_operands("legendre_adj_par", lam, v)[1]
    lam, u = _plain_operands("legendre_adj_par", lam, u)
    lam_e, lam_o = _parity_halves(lam, ms)
    return (torch.einsum("mlr,mrc->mcl", lam_e, u)
            + torch.einsum("mlr,mrc->mcl", lam_o, v)).to(g.dtype)


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
    sfx = _SUFFIX[(lam.dtype, b.dtype)]
    fn = _fns[f"legendre_{kind}_{'tri' if nr is None else 'par'}_{sfx}"]
    M, L, nt = lam.shape
    # strides of size-1 axes are free in torch; the kernels index them at 0
    sb = [1 if size == 1 else s for size, s in zip(b.shape, b.stride())]
    if kind == "synth":
        C, args = b.shape[1], sb[:2]
    else:
        C, args = b.shape[2], sb + [out.stride(0), out.stride(1)]
    if nr is not None:
        tail = [int(flip)]
        if kind == "synth" and sfx == "f32":
            tail.append(f32_par_synth_tile(nt))
        elif kind == "synth" and sfx in ("bf16", "f16"):
            tail.append(bf16_par_synth_tile(nt))
    elif kind == "synth" and sfx in ("bf16", "f16"):
        tail = [bf16_synth_tile(nt)]
    else:
        tail = []
    with torch.cuda.device(lam.device):
        stream = torch.cuda.current_stream(lam.device).cuda_stream
        err = fn(lam.data_ptr(), b.data_ptr(), out.data_ptr(), L,
                 nt if nr is None else nr, C, *args,
                 None if ms is None else ms.data_ptr(), M, *tail, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed with "
                           f"CUDA error {err}")


def _count(fn, lam: torch.Tensor, b: torch.Tensor, nr: int, C: int,
           ms) -> None:
    """One launch of ``fn``'s kernel on (``lam``, batch ``b``) at (nr, C),
    nr the output's rings."""
    M, L = lam.shape[:2]
    sfx = _SUFFIX[(lam.dtype, b.dtype)]
    fn.launches += 1
    fn.launches_f64 += sfx == "f64"
    fn.launches_bf16 += sfx == "bf16"
    fn.launches_f16 += sfx == "f16"
    fn.launches_narrow += sfx in ("bf16f64", "f32f64", "f16f64")
    fn.launches_wide += sfx == "f64f32"
    dt = lam.dtype if len(sfx) <= 4 else (lam.dtype, b.dtype)
    if ms is None:
        fn.shapes[(L, nr, C, dt)] += 1
    else:
        fn.slabs[(L, M, nr, C, dt)] += 1


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
        _count(legendre_synth_tri, lam, x, nr, x.shape[1], ms)
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
        _count(legendre_adj_tri, lam, g, nr, C, ms)
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
        _count(legendre_synth_par, lam, x, nr, x.shape[1], ms)
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
        _count(legendre_adj_par, lam, g, nr, C, ms)
    return out


reset_launch_counts()
