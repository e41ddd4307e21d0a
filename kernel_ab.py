#!/usr/bin/env python3
"""Time the full-table Legendre kernels of two source trees in turns.

    python3 kernel_ab.py OTHER_TREE [--reps 40] [--only TEXT]
    python3 kernel_ab.py --variant NAME [--base TREE] [--reps 40]

OTHER_TREE is a directory holding another version of the port's package
(``gibbssampler_tpu_torch/``), for example a parent commit unpacked with
``git archive <commit> gibbssampler_tpu_torch | tar -x -C OTHER_TREE``.
Each tree's kernels are built (into that tree's ``_build/``) and timed in a
process of its own, in the order other, this, this, other, on one card,
at L 513 in the state views the transforms pass: both dense kernels in
float32 at C 256 and in float64 at C 16, nr 65 and 513; with bfloat16
tables at C 256, the dense synthesis at nr 65, 83, 513 and 1023, the dense
adjoint at nr 65, 83 and 513, the parity synthesis at nr 513 and the parity
adjoint at nr 513 and 1023; the float32 parity synthesis and parity
adjoint at nr 513, C 256 and 512, and nr 1023, C 256; the float64 parity
synthesis and parity adjoint at nr 513, C 16 and 32; the bfloat16 parity
synthesis at nr 1023 too (parity kernels on half tables of ceil(nr / 2)
rings); the dense pair on bfloat16 and float32 tables with a float64 batch
("bfloat16+float64", "float32+float64") at nr 65, C 16 and nr 513, C 16
and 32, and the parity pair on them at nr 513, C 16 and 32; the dense pair
on a float64 table with a float32 batch ("float64+float32") at nr 65 and
513, C 256, and its parity pair at nr 513, C 256; mean ms per call over
``--reps`` launches replayed from one CUDA graph between CUDA events (no
host time between the launches); ``--only TEXT`` keeps the shapes whose
"<kernel> <dtype>" holds TEXT.  Prints the
card's name and power limit, one JSON line per run, then one JSON line of
the mean of each tree's two runs per shape and this tree's ratio to the
other's.  Needs a CUDA card.

``--variant NAME`` takes as OTHER_TREE a copy of this tree's package, in
a temporary directory, with the text patches of VARIANTS[NAME] applied (a
design variant of one kernel, or the kernel with a part compiled out,
which computes a wrong result on purpose: its copies, its MMAs or, for
the bfloat16 dense adjoint and parity synthesis and the narrow-table
float64 kernels, its staging pass or its stores alone; "wide-*" the
float64-table dense pair's, "wide-par-*" its parity pair's: each part
alone, "wide-par-{copies,staging,mma,stores}-only", and the alternatives
"wide-par-synth-128-columns" (two column warps a block), "-synth-3-deep"
(three stages in flight), "-adj-64-columns", "-adj-256-rows" (128 rows of
each class x 64 columns)), and times only that kernel's SHAPES.  With
``--base TREE`` the variant is made from
TREE's package and timed against TREE instead of this tree (the
"narrow-par-v1-*" variants patch the first version of the narrow-table
float64 parity synthesis, which a tree from before its redesign holds;
"wide-v1-*" the float64-table dense adjoint's before its redesign).
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

# (kernel, table dtype, C, nr)
SHAPES = tuple((k, dt, C, nr) for dt, C, nr in (
    ("float32", 256, 65), ("float32", 256, 513), ("float64", 16, 65),
    ("float64", 16, 513)) for k in ("synth", "adj")) + tuple(
    ("synth", "bfloat16", 256, nr) for nr in (65, 83, 513, 1023)) + (
    ("adj", "bfloat16", 256, 65), ("adj", "bfloat16", 256, 83),
    ("adj", "bfloat16", 256, 513), ("synth_par", "bfloat16", 256, 513),
    ("adj_par", "bfloat16", 256, 513), ("adj_par", "bfloat16", 256, 1023),
    ("synth_par", "float32", 256, 513), ("synth_par", "float32", 512, 513),
    ("synth_par", "float32", 256, 1023), ("synth_par", "float64", 16, 513),
    ("synth_par", "float64", 32, 513), ("adj_par", "float32", 256, 513),
    ("adj_par", "float32", 512, 513), ("adj_par", "float32", 256, 1023),
    ("adj_par", "float64", 16, 513), ("adj_par", "float64", 32, 513),
    ("synth_par", "bfloat16", 256, 1023)) + tuple(
    (k, f"{dt}+float64", C, nr) for dt in ("bfloat16", "float32")
    for C, nr in ((16, 65), (16, 513), (32, 513)) for k in ("synth", "adj")
) + tuple((k, f"{dt}+float64", C, 513) for dt in ("bfloat16", "float32")
          for C in (16, 32) for k in ("synth_par", "adj_par")) + tuple(
    (k, "float64+float32", 256, nr) for nr in (65, 513)
    for k in ("synth", "adj")) + tuple(
    (k, "float64+float32", 256, 513) for k in ("synth_par", "adj_par"))
L = 513

_F32 = "gibbssampler_tpu_torch/csrc/legendre_tri.cu"
_F64 = "gibbssampler_tpu_torch/csrc/legendre_tri_f64.cu"
_BF16 = "gibbssampler_tpu_torch/csrc/legendre_tri_bf16.cu"
_PY = "gibbssampler_tpu_torch/sht/legendre_kernels.py"
_F32_TILES = "F32_PAR_SYNTH_TILES = (64, 72, 80, 88)"
_BF16_PAR_TILES = "BF16_PAR_SYNTH_TILES = (128, 144)"
# the lines of the sources that the part-alone variants patch
_RING_COPIES = "    if (kt + K::DEPTH < KT) k.issue(kt + K::DEPTH);"
_F32_ADJ_MMA = "    if (rows > 48) mma_rows<4>(s, p);"
# (the dense adjoint is the parity adjoint's block with DENSE true)
_BF16_ADJ_STAGE = ("  __device__ __forceinline__ void stage(int s) {\n"
                   "    if (s == 0) {")
_BF16_ADJ_MMA = "    const bool odd = wm0 >= BM;  // the warp's parity"
_BF16_NO_MMA = (_BF16, _BF16_ADJ_MMA, "    if (DENSE) return;\n" + _BF16_ADJ_MMA)
_BF16_RUNS = "        store_run(out + c * soc, f_ + c * SC, min(2 * BM, lv), lane);"
_BF16_NO_STORES = (_BF16, _BF16_RUNS, "        if (0)\n" + _BF16_RUNS)
_BF16_ZEROS = ("        if (zeros > 0) store_run(out + c * soc - zeros, nullptr, "
               "zeros, lane);")
_BF16_NO_ZEROS = (_BF16, _BF16_ZEROS, _BF16_ZEROS.replace("zeros > 0", "0"))
# the bfloat16 parity synthesis (the dense synthesis' block with PAR true):
# its MMAs, its staging pass, its stores
_BF16_SP_NO_MMA = (_BF16, "        if (kk != cls || kv <= cls) continue;",
                   "        continue;")
_BF16_SP_STAGE = ("  __device__ __forceinline__ void stage(int s) {\n"
                  "    const unsigned char* slot_")
_BF16_SP_ROWS = "    for (int row = tid >> 5; row < jv + jv2; row += WARPS) {"
_BF16_SP_NO_STORES = (_BF16, _BF16_SP_ROWS,
                      _BF16_SP_ROWS.replace("row < jv", "0 && row < jv"))
_BF16_WN = "  static constexpr int WM = 32, WN = BN / 2;"
_BF16_BM = "  static constexpr int BM = 128, BN = BN_, BK = 32, DEPTH = 3;"


def _bf16_par_tiles(a, b):
    """The patches that set the bfloat16 parity synthesis' ring tiles."""
    return [(_PY, _BF16_PAR_TILES, f"BF16_PAR_SYNTH_TILES = ({a}, {b})"),
            (_BF16, "constexpr int kParTile0 = 128, kParTile1 = 144;",
             f"constexpr int kParTile0 = {a}, kParTile1 = {b};")]


_NARROW = "gibbssampler_tpu_torch/csrc/legendre_tri_narrow_f64.cu"
_NARROW_PARTS = "#define LEGENDRE_NARROW_PARTS 15"
# the narrow-table float64 dense pair, both table dtypes
_NARROW_SYNTH = tuple(("synth", f"{dt}+float64") for dt in ("bfloat16",
                                                           "float32"))
_NARROW_ADJ = tuple(("adj", f"{dt}+float64") for dt in ("bfloat16",
                                                       "float32"))
# the float64-table float32 dense pair
_WIDE_SYNTH, _WIDE_ADJ = ("synth", "float64+float32"), ("adj",
                                                         "float64+float32")
# ... and its parity pair
_WIDE_SYNTH_PAR = ("synth_par", "float64+float32")
_WIDE_ADJ_PAR = ("adj_par", "float64+float32")
# the issue of a stage's copies in the wide synthesis' ring, before the
# products of the stage before, or after them
_WIDE_RING = ("    cp_async_wait<K::DEPTH - 1>();\n    __syncthreads();\n"
              "    if (kt + K::DEPTH < KT) k.issue(kt + K::DEPTH);\n"
              "    cp_async_commit();\n    k.mma(kt);\n")
_WIDE_RING_LATE = ("    cp_async_wait<K::DEPTH - 1>();\n    __syncthreads();\n"
                   "    k.mma(kt);\n"
                   "    if (kt + K::DEPTH < KT) k.issue(kt + K::DEPTH);\n"
                   "    cp_async_commit();\n")
# the first version of its adjoint (--base a tree from before its
# redesign): the (m, row tile) pair in blockIdx.x and the column tile in
# blockIdx.y swapped, so that a pair's column tiles run next to each other
_V1_ADJ_KERNEL = "  using K = AdjNarrow<T, TC, KUNIT>;\n  extern __shared__"
_V1_ADJ_GRID = "  const dim3 grid(blocks, (C + TC - 1) / TC);\n" \
    "  const cudaError_t e = allow_smem(adj_narrow<T, TC, KUNIT>, K::SMEM);"


# ... and the parity pair on them; its synthesis' stage rows by table dtype
_PAR_KL = "int par_kl(int es) { return es == 2 ? 32 : 16; }"
_NARROW_SYNTH_PAR = tuple(("synth_par", f"{dt}+float64")
                          for dt in ("bfloat16", "float32"))
_NARROW_ADJ_PAR = tuple(("adj_par", f"{dt}+float64")
                        for dt in ("bfloat16", "float32"))
# the first version of the narrow parity synthesis (a thread a ring on the
# FMA pipes): its table loads, its batch staging, its FMAs
_V1_LOAD0 = "  load_rows(t, col, m, L, nt, live);"
_V1_LOADN = "    load_rows(tn, col, l0 + KL, L, nt, live && l0 + KL < L);"
_V1_BATCH = ("      xs[c][k] = (c0 + c < C && l0 + k < L)\n"
             "                     ? Narrow<T>::round(xi[(c0 + c) * sxc + l0 + k])\n"
             "                     : 0.0;")
_V1_FMA = ("#pragma unroll\n    for (int k = 0; k < KL; k += 2) {\n"
           "      const double t0 = t[k], t1 = t[k + 1];")
_V1_NEXT = "    for (int k = 0; k < KL; ++k) t[k] = tn[k];"


def _narrow_parts(bits):
    """The patch that keeps the narrow-table kernels' parts ``bits`` only."""
    return [(_NARROW, _NARROW_PARTS, _NARROW_PARTS.replace("15", str(bits)))]


_F64_ADJ = "constexpr int kAdjPar"
_F64_BLOCKS = ("  static constexpr int MIN_BLOCKS = SMEM <= 113 * 1024 ? 2 "
               ": 1;")
# name -> (the kernel's SHAPES: kernel, dtype; [(file, text, replacement)])
VARIANTS = {
    # the float32 parity synthesis at one ring tile whatever nh is
    **{f"f32-par-tile-{t}": (("synth_par", "float32"), [
        (_PY, _F32_TILES, f"F32_PAR_SYNTH_TILES = ({t},)")])
       for t in (64, 72, 80)},
    # its copies alone: no MMA
    "f32-par-copies-only": (("synth_par", "float32"), [
        (_F32, "      mma_stage<T, false, 0, T::KH>(sA, sB",
         "      if (0) mma_stage<T, false, 0, T::KH>(sA, sB"),
        (_F32, "      mma_stage<T, true, 0, T::KH>(",
         "      if (0) mma_stage<T, true, 0, T::KH>(")]),
    # its MMA path alone: no copies but a block's first STAGES - 1 stages
    "f32-par-mma-only": (("synth_par", "float32"), [
        (_F32, "      load_stage<T, 1>(st, st + T::A_TILE, A, sxc, iv, B, nh, jv,\n"
               "                       nx * T::BK, Kn);",
         "      if (0) load_stage<T, 1>(st, st + T::A_TILE, A, sxc, iv, B, nh,"
         " jv, nx * T::BK, Kn);")]),
    # the float64 parity synthesis with 4 stages of 16 degree rows
    "f64-par-16-row-stages": (("synth_par", "float64"), [
        (_F64, "constexpr int kParKL = 16;", "constexpr int kParKL = 8;"),
        (_F64, "constexpr int kParStages = 2;", "constexpr int kParStages = 4;")]),
    # ... and with ring tiles of 4 warps at 32 columns
    "f64-par-4-warps": (("synth_par", "float64"), [
        (_F64, "return tc == 32 ? 6 : 8;", "return tc == 32 ? 4 : 8;")]),
    # the float32 parity adjoint's copies and staging pass alone: no MMA
    "f32-par-adj-copies-only": (("adj_par", "float32"), [
        (_F32, _F32_ADJ_MMA, "    if (true) return;\n" + _F32_ADJ_MMA)]),
    # its MMA path alone: no copies but a block's first DEPTH stages
    "f32-par-adj-mma-only": (("adj_par", "float32"), [
        (_F32, _RING_COPIES, _RING_COPIES.replace("if (", "if (0 && "))]),
    # the bfloat16 dense adjoint's copies and staging pass alone
    "bf16-adj-copies-only": (("adj", "bfloat16"), [
        _BF16_NO_MMA, _BF16_NO_STORES, _BF16_NO_ZEROS]),
    # its MMAs alone: no copies but a block's first DEPTH stages, no stores
    "bf16-adj-mma-only": (("adj", "bfloat16"), [
        (_BF16, _RING_COPIES, _RING_COPIES.replace("if (", "if (0 && ")),
        _BF16_NO_STORES, _BF16_NO_ZEROS]),
    # its stores alone: the zeros and the sums' runs, no copies but a
    # block's first DEPTH stages, no staging pass, no MMA
    "bf16-adj-stores-only": (("adj", "bfloat16"), [
        (_BF16, _RING_COPIES, _RING_COPIES.replace("if (", "if (0 && ")),
        (_BF16, _BF16_ADJ_STAGE, _BF16_ADJ_STAGE.replace(
            "{\n", "{\n    if (DENSE) return;\n")),
        _BF16_NO_MMA]),
    # the bfloat16 parity synthesis' copies and staging pass alone
    "bf16-par-synth-copies-only": (("synth_par", "bfloat16"), [
        _BF16_SP_NO_MMA, _BF16_SP_NO_STORES]),
    # its MMAs alone: no copies but a block's first DEPTH stages, no stores
    "bf16-par-synth-mma-only": (("synth_par", "bfloat16"), [
        (_BF16, _RING_COPIES, _RING_COPIES.replace("if (", "if (0 && ")),
        _BF16_SP_NO_STORES]),
    # its stores alone: no copies but a block's first DEPTH stages, no
    # staging pass, no MMA
    "bf16-par-synth-stores-only": (("synth_par", "bfloat16"), [
        (_BF16, _RING_COPIES, _RING_COPIES.replace("if (", "if (0 && ")),
        (_BF16, _BF16_SP_STAGE, _BF16_SP_STAGE.replace(
            "{\n", "{\n    if (PAR) return;\n")),
        _BF16_SP_NO_MMA]),
    # its design alternatives: 128 x 64 / 72 tiles of 8 warps (two blocks
    # an SM), 256 x 64 / 72 and 64 x 256 / 288 tiles of 16 warps, four
    # stages in flight
    "bf16-par-synth-8-warps": (("synth_par", "bfloat16"), [
        *_bf16_par_tiles(64, 72), (_BF16, _BF16_WN, _BF16_WN.replace(
            "BN / 2", "PAR ? BN : BN / 2"))]),
    "bf16-par-synth-256-columns": (("synth_par", "bfloat16"), [
        *_bf16_par_tiles(64, 72), (_BF16, _BF16_WN, _BF16_WN.replace(
            "BN / 2", "PAR ? BN : BN / 2")),
        (_BF16, _BF16_BM, _BF16_BM.replace("128", "PAR ? 256 : 128"))]),
    "bf16-par-synth-64-columns": (("synth_par", "bfloat16"), [
        *_bf16_par_tiles(256, 288), (_BF16, _BF16_WN, _BF16_WN.replace(
            "BN / 2", "PAR ? BN / 4 : BN / 2")),
        (_BF16, _BF16_BM, _BF16_BM.replace("128", "PAR ? 64 : 128"))]),
    "bf16-par-synth-4-deep": (("synth_par", "bfloat16"), [
        (_BF16, _BF16_BM, _BF16_BM.replace("DEPTH = 3", "DEPTH = PAR ? 4 : 3"))]),
    # the float64 parity adjoint with 32-ring stages (one block an SM),
    # three stages in flight, 32-row classes, three blocks an SM
    "f64-par-adj-32-ring-stages": (("adj_par", "float64"), [
        (_F64, _F64_ADJ + "Rings = 16;", _F64_ADJ + "Rings = 32;")]),
    "f64-par-adj-3-deep": (("adj_par", "float64"), [
        (_F64, _F64_ADJ + "Depth = 2;", _F64_ADJ + "Depth = 3;")]),
    "f64-par-adj-32-row-classes": (("adj_par", "float64"), [
        (_F64, _F64_ADJ + "Rows = 64;", _F64_ADJ + "Rows = 32;")]),
    "f64-par-adj-3-blocks": (("adj_par", "float64"), [
        (_F64, _F64_BLOCKS, _F64_BLOCKS.replace(
            "SMEM <= 113", "SMEM <= 75 * 1024 ? 3 : SMEM <= 113"))]),
    # the narrow-table float64 dense synthesis and adjoint, each part alone
    # (LEGENDRE_NARROW_PARTS): the copies (the table's and the batch's), the
    # staging pass (the batch rounded), the MMAs, the stores
    **{f"narrow-{k}-{part}-only": (sel, _narrow_parts(bits))
       for k, sel in (("synth", _NARROW_SYNTH), ("adj", _NARROW_ADJ))
       for part, bits in (("copies", 1), ("staging", 2), ("mma", 4),
                          ("stores", 8))},
    # their design alternatives: three stages in flight, 64-row synthesis
    # stages, synthesis warps of 16 rings at every nr, adjoint stages of 128
    # bytes of each row (64 bfloat16 or 32 float32 rings), 128-row adjoint
    # blocks of 4 warps
    "narrow-synth-3-deep": (_NARROW_SYNTH, [
        (_NARROW, "constexpr int kSynDepth = 2;", "constexpr int kSynDepth = 3;")]),
    "narrow-synth-64-row-stages": (_NARROW_SYNTH, [
        (_NARROW, "constexpr int kSynRows = 32;", "constexpr int kSynRows = 64;")]),
    "narrow-synth-16-ring-warps": (_NARROW_SYNTH, [
        (_NARROW, "mt = nr <= 16 * kSynMaxWarps ? 1 : 2;", "mt = 1;")]),
    "narrow-adj-3-deep": (_NARROW_ADJ, [
        (_NARROW, "constexpr int kAdjDepth = 2;", "constexpr int kAdjDepth = 3;")]),
    "narrow-adj-128-byte-pieces": (_NARROW_ADJ, [
        (_NARROW, "constexpr int kAdjPiece = 64;", "constexpr int kAdjPiece = 128;")]),
    "narrow-adj-128-rows": (_NARROW_ADJ, [
        (_NARROW, "constexpr int kAdjRows = 256;", "constexpr int kAdjRows = 128;"),
        (_NARROW, "constexpr int kAdjWarps = 8;", "constexpr int kAdjWarps = 4;")]),
    # the float64-table float32 dense synthesis and adjoint together, each
    # part alone (LEGENDRE_NARROW_PARTS)
    **{f"wide-{part}-only": ((_WIDE_SYNTH, _WIDE_ADJ), _narrow_parts(bits))
       for part, bits in (("copies", 1), ("staging", 2), ("mma", 4),
                          ("stores", 8))},
    # its design alternatives: synthesis blocks of at most 2 column warps
    # (128 columns), stages of 16 degree rows, a stage's copies issued after
    # the products of the stage before; adjoint blocks of 64 columns above
    # C 64, stages of 8 or 40 rings; three stages in flight in both
    "wide-synth-128-columns": ((_WIDE_SYNTH,), [
        (_NARROW, "constexpr int kWideColWarps = 4;",
         "constexpr int kWideColWarps = 2;")]),
    "wide-synth-16-row-stages": ((_WIDE_SYNTH,), [
        (_NARROW, "constexpr int kWideSynRows = 32;",
         "constexpr int kWideSynRows = 16;")]),
    "wide-adj-64-columns": ((_WIDE_ADJ,), [
        (_NARROW, "return C <= 32 ? 1 : (C <= 64 ? 2 : 4);",
         "return C <= 32 ? 1 : 2;")]),
    **{f"wide-adj-{n}-ring-stages": ((_WIDE_ADJ,), [
        (_NARROW, "constexpr int kWideAdjRings = 24;",
         f"constexpr int kWideAdjRings = {n};")]) for n in (8, 40)},
    "wide-3-deep": ((_WIDE_SYNTH, _WIDE_ADJ), [
        (_NARROW, "constexpr int kWideDepth = 2;",
         "constexpr int kWideDepth = 3;")]),
    "wide-synth-late-copies": ((_WIDE_SYNTH,), [
        (_NARROW, _WIDE_RING, _WIDE_RING_LATE)]),
    # the float64-table float32 parity synthesis and adjoint together,
    # each part alone (LEGENDRE_NARROW_PARTS)
    **{f"wide-par-{part}-only": ((_WIDE_SYNTH_PAR, _WIDE_ADJ_PAR),
                                 _narrow_parts(bits))
       for part, bits in (("copies", 1), ("staging", 2), ("mma", 4),
                          ("stores", 8))},
    # its design alternatives: synthesis blocks of at most 2 column warps
    # (128 columns, 64 rings: the table enters twice, x half as often),
    # three synthesis stages in flight; adjoint blocks of 64 columns (the
    # table enters 4 times), of 256 rows l (128 of each class) x 64 columns
    "wide-par-synth-128-columns": ((_WIDE_SYNTH_PAR,), [
        (_NARROW, "constexpr int kWideParColWarps = 4;",
         "constexpr int kWideParColWarps = 2;")]),
    "wide-par-synth-3-deep": ((_WIDE_SYNTH_PAR,), [
        (_NARROW, "constexpr int kWideDepth = 2;",
         "constexpr int kWideDepth = 3;")]),
    # ... and, measured for a later redesign: its k8 steps unrolled; blocks
    # of 8 warps, 128 columns x 32 rings, two an SM (the table enters
    # twice); adjoint blocks of 64 columns with one stage in flight, two
    # an SM
    "wide-par-synth-unrolled": ((_WIDE_SYNTH_PAR,), [
        (_NARROW, "#pragma unroll 1\n      for (int kk = 0; kk < KL / 8; ++kk) {",
         "#pragma unroll\n      for (int kk = 0; kk < KL / 8; ++kk) {")]),
    "wide-par-synth-2-blocks": ((_WIDE_SYNTH_PAR,), [
        (_NARROW, "constexpr int kWideParColWarps = 4;",
         "constexpr int kWideParColWarps = 2;"),
        (_NARROW, "constexpr int kWideSynWarps = 16;",
         "constexpr int kWideSynWarps = 8;"),
        (_NARROW, "__launch_bounds__(32 * kWideSynWarps, 1)\n    synth_par_wide(",
         "__launch_bounds__(32 * kWideSynWarps, 2)\n    synth_par_wide(")]),
    "wide-par-adj-2-blocks": ((_WIDE_ADJ_PAR,), [
        (_NARROW, "return C <= 32 ? 1 : (C <= 64 ? 2 : 4);",
         "return C <= 32 ? 1 : 2;"),
        (_NARROW, "constexpr int kWideDepth = 2;",
         "constexpr int kWideDepth = 1;")]),
    "wide-par-adj-64-columns": ((_WIDE_ADJ_PAR,), [
        (_NARROW, "return C <= 32 ? 1 : (C <= 64 ? 2 : 4);",
         "return C <= 32 ? 1 : 2;")]),
    "wide-par-adj-256-rows": ((_WIDE_ADJ_PAR,), [
        (_NARROW, "return C <= 32 ? 1 : (C <= 64 ? 2 : 4);",
         "return C <= 32 ? 1 : 2;"),
        (_NARROW, "constexpr int kWideParAdjRows = 128;",
         "constexpr int kWideParAdjRows = 256;")]),
    # the first version of its adjoint with a pair's column tiles next to
    # each other in launch order (blockIdx.x), so that L2 serves the
    # table's repeats
    "wide-v1-adj-columns-fastest": ((_WIDE_ADJ,), [
        (_NARROW, _V1_ADJ_KERNEL, _V1_ADJ_KERNEL.replace(
            "\n", "\n  const uint3 blockIdx = sizeof(T) == 8 ? make_uint3("
            "::blockIdx.y, ::blockIdx.x, 0) : ::blockIdx;\n")),
        (_NARROW, _V1_ADJ_GRID, _V1_ADJ_GRID.replace(
            "grid(blocks, (C + TC - 1) / TC)",
            "grid = sizeof(T) == 8 ? dim3((C + TC - 1) / TC, blocks) : "
            "dim3(blocks, (C + TC - 1) / TC)"))]),
    # the narrow-table float64 parity synthesis and adjoint, each part alone
    **{f"narrow-par-{k}-{part}-only": (sel, _narrow_parts(bits))
       for k, sel in (("synth", _NARROW_SYNTH_PAR), ("adj", _NARROW_ADJ_PAR))
       for part, bits in (("copies", 1), ("staging", 2), ("mma", 4),
                          ("stores", 8))},
    # the parity synthesis with warps of 16 rings at every column tile,
    # with stages of 32 degree rows in both dtypes, of 64 in both
    "narrow-par-synth-16-ring-warps": (_NARROW_SYNTH_PAR, [
        (_NARROW, "mt = tc == 32 || nt <= 16 * kParMaxWarps ? 1 : 2;",
         "mt = 1;")]),
    **{f"narrow-par-synth-{2 * kl}-row-stages": (_NARROW_SYNTH_PAR, [
        (_NARROW, _PAR_KL, f"int par_kl(int es) {{ return {kl}; }}")])
       for kl in (16, 32)},
    # its first version (--base a tree that holds it) without its table
    # loads (the ring columns read as zeros), without its batch staging
    # (zeros staged), without its FMAs (each table value summed once)
    "narrow-par-v1-synth-no-table": (_NARROW_SYNTH_PAR, [
        (_NARROW, _V1_LOAD0, _V1_LOAD0.replace("live)", "false)")),
        (_NARROW, _V1_LOADN, _V1_LOADN.replace(
            "live && l0 + KL < L)", "false)"))]),
    "narrow-par-v1-synth-no-batch": (_NARROW_SYNTH_PAR, [
        (_NARROW, _V1_BATCH, "      xs[c][k] = 0.0;")]),
    "narrow-par-v1-synth-no-fma": (_NARROW_SYNTH_PAR, [
        (_NARROW, _V1_FMA, _V1_FMA.replace("k < KL", "0 && k < KL")),
        (_NARROW, _V1_NEXT, "    for (int k = 0; k < KL; ++k) {\n"
         "      se[k % NC] += t[k];\n      t[k] = tn[k];\n    }")]),
}


def variant_tree(name: str, base: str) -> str:
    """A temporary copy of the package under ``base`` with
    VARIANTS[name]'s patches; returns its root."""
    root = tempfile.mkdtemp(prefix=f"kernel_ab_{name}_")
    shutil.copytree(os.path.join(base, "gibbssampler_tpu_torch"),
                    os.path.join(root, "gibbssampler_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, text, repl in VARIANTS[name][1]:
        path = os.path.join(root, rel)
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            raise RuntimeError(f"variant {name}: {text!r} is not in {rel} "
                               "exactly once")
        with open(path, "w") as f:
            f.write(src.replace(text, repl))
    return root


def time_tree(root: str, reps: int, shapes=SHAPES) -> dict:
    """{"<kernel> <dtype> nr<nr> C<C>": ms} of the package under root."""
    import chip_smoke  # graph_ms, from this script's directory
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
        return chip_smoke.graph_ms(torch, fn, reps)

    out = {}
    for kind, dtype_name, C, nr in shapes:
        # "table+batch" names a narrow table under a wider batch
        tname, _, bname = dtype_name.partition("+")
        dtype = getattr(torch, tname)
        batch = getattr(torch, bname) if bname else (
            torch.float32 if dtype == torch.bfloat16 else dtype)
        nt = (nr + 1) // 2 if kind.endswith("_par") else nr
        tri = (torch.arange(L, device=dev)[None, :]
               >= torch.arange(L, device=dev)[:, None])
        lam = (torch.randn((L, L, nt), generator=gen, device=dev)
               * tri[:, :, None]).to(dtype).contiguous()
        # the (m, C, l) view of (C, m, l) grids and the (m, r, C) view of
        # an (m, C, r) copy, as sht.lcore passes them
        if kind.startswith("synth"):
            b = torch.randn((L, C, L), generator=gen, dtype=batch,
                            device=dev).transpose(0, 1).contiguous() \
                .transpose(0, 1)
        else:
            b = torch.randn((L, nr, C), generator=gen, dtype=batch,
                            device=dev).transpose(1, 2).contiguous() \
                .transpose(1, 2)
        fn, args = {"synth": (lk.legendre_synth_tri, ()),
                    "adj": (lk.legendre_adj_tri, ()),
                    "synth_par": (lk.legendre_synth_par, (nr,)),
                    "adj_par": (lk.legendre_adj_par, ())}[kind]
        out[f"{kind} {dtype_name} nr{nr} C{C}"] = ms_per_call(
            lambda: fn(lam, b, *args))
        del lam, b
    return out


def main() -> int:
    args = sys.argv[1:]
    variant = args[args.index("--variant") + 1] if "--variant" in args \
        else None
    if variant is None:
        shapes = SHAPES
    else:  # one (kernel, dtype) pair or a tuple of them
        sel = VARIANTS[variant][0]
        sel = (sel,) if isinstance(sel[0], str) else sel
        shapes = tuple(sh for sh in SHAPES if sh[:2] in sel)
    only = args[args.index("--only") + 1] if "--only" in args else ""
    shapes = tuple(sh for sh in shapes if only in f"{sh[0]} {sh[1]}")
    if "--worker" in args:
        root, reps = args[args.index("--worker") + 1], int(args[-1])
        print(json.dumps(time_tree(root, reps, shapes)), flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    this = os.path.abspath(args[args.index("--base") + 1]) \
        if "--base" in args else os.path.dirname(os.path.abspath(__file__))
    other = variant_tree(variant, this) if variant else \
        os.path.abspath(args[0])
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 40
    if not os.path.isdir(os.path.join(other, "gibbssampler_tpu_torch")):
        print(f"{other} holds no gibbssampler_tpu_torch/", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    runs = {"other": [], "this": []}
    try:
        for label, root in (("other", other), ("this", this),
                            ("this", this), ("other", other)):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 *(("--variant", variant) if variant else ()),
                 *(("--only", only) if only else ()), "--worker",
                 root, str(reps)], cwd=root, capture_output=True, text=True,
                timeout=600)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            ms = json.loads(res.stdout.strip().splitlines()[-1])
            runs[label].append(ms)
            print(json.dumps({"tree": label, "root": root, "ms": ms}),
                  flush=True)
    finally:
        if variant:
            shutil.rmtree(other)
    mean = {t: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
            for t, rs in runs.items()}
    print(json.dumps({"card": card, "mean_ms": mean, "ratio_this_to_other": {
        k: mean["this"][k] / mean["other"][k] for k in mean["this"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
