"""The yardstick of the Legendre stage: the least time of one call, keyed on
the call and not on the kernel that serves it.

A call is what the SHT's Legendre stage asks for, a synthesis or an
adjoint of the triangular (m, l, r) contraction at (L, rings, columns,
table dtype, compute dtype).  Its work is counted at the least that any
implementation needs: the triangle of the table at the rings, halved when
the ring set is symmetric about the equator (the ring-parity form needs
only the north half and half the products); the batch read once (the
synthesis' input triangle, the adjoint's (rings, L) columns) and the
output written once (the synthesis' (L, rings) columns, the adjoint's
whole (L, L) grid, which the caller reads).  The least time is the larger
of its bytes over the HBM rate and its FLOPs over the peak of its (table,
compute) dtype pair on one NVIDIA H100 SXM (data sheet, dense rates):
float32 on float32 by 3xTF32 tensor-core products, 495 / 3 TFLOP/s;
16-bit tables under float32 989 TFLOP/s; anything with a float64 side on
the float64 tensor cores, 67 TFLOP/s; 3.35 TB/s.
"""

from __future__ import annotations

import math
import re

__all__ = ["HBM_BYTES_PER_S", "peak_flops", "call_work", "least_time",
           "LEGENDRE_KERNEL"]

HBM_BYTES_PER_S = 3.35e12
_PEAKS = {("float32", "float32"): 495e12 / 3,
          ("bfloat16", "float32"): 989e12,
          ("float16", "float32"): 989e12}
_FP64_PEAK = 67e12
_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}

# the hand-written Legendre kernels' names (csrc/legendre_tri*.cu)
LEGENDRE_KERNEL = re.compile(r"(?<![A-Za-z])(synth|adj)_(tri|par|narrow|wide)")


def peak_flops(table_dtype: str, compute_dtype: str) -> float:
    if "float64" in (table_dtype, compute_dtype):
        return _FP64_PEAK
    return _PEAKS[(table_dtype, compute_dtype)]


def call_work(kind: str, L: int, nr: int, C: int, table_dtype: str,
              compute_dtype: str, symmetric: bool):
    """(FLOPs, bytes) the call needs at least; ``kind`` "synth" or
    "adj"."""
    tri = L * (L + 1) // 2
    nt = math.ceil(nr / 2) if symmetric else nr
    ts, cs = _ITEMSIZE[table_dtype], _ITEMSIZE[compute_dtype]
    table = tri * nt * ts
    if kind == "synth":
        nbytes = table + tri * C * cs + L * nr * C * cs
    elif kind == "adj":
        nbytes = table + nr * L * C * cs + L * L * C * cs
    else:
        raise ValueError(f"kind={kind!r}; synth or adj")
    return 2 * tri * nt * C, nbytes


def least_time(kind, L, nr, C, table_dtype, compute_dtype, symmetric):
    """Seconds: max(bytes / HBM rate, FLOPs / peak)."""
    flops, nbytes = call_work(kind, L, nr, C, table_dtype, compute_dtype,
                              symmetric)
    return max(nbytes / HBM_BYTES_PER_S,
               flops / peak_flops(table_dtype, compute_dtype))
