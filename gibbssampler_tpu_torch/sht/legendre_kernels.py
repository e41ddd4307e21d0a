"""Triangular Legendre contractions: hand-written CUDA kernels and their
plain PyTorch versions.

Counterparts of ``gibbssampler_tpu/sht/pallas_legendre.py`` with the same
names, layouts and math:

    legendre_synth_tri(lam, x):  out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l]
    legendre_adj_tri(lam, g):    out[m, c, l] = sum_r lam[m, l, r] g[m, r, c]
                                 (zero for l < m)

    lam (L, L, nr) [m, l, r], zero for l < m;  x (L, C, L);  g (L, nr, C).

The kernels (``csrc/legendre_tri.cu``; design and bounds are noted there)
are compiled with nvcc for sm_90a at first use, into ``_build/`` beside the
package, keyed by a hash of the source, and loaded with ctypes.  A wrapper
takes the plain ``torch.einsum`` version only for tensors on the CPU; for
CUDA tensors it launches its kernel or raises.  Each wrapper counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

__all__ = ["legendre_synth_tri", "legendre_adj_tri",
           "legendre_synth_tri_plain", "legendre_adj_tri_plain",
           "build", "reset_launch_counts"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "legendre_tri.cu"
_BUILD_DIR = _PKG / "_build"
_ENTRY = ("legendre_synth_tri_f32", "legendre_synth_tri_f64",
          "legendre_adj_tri_f32", "legendre_adj_tri_f64")
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the Legendre kernels")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> tuple[pathlib.Path, str]:
    """Compile ``csrc/legendre_tri.cu`` (once per source hash) and load it.
    Returns (path of the shared library, the compiler's report; empty when
    an existing build was reused)."""
    global _lib
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"legendre_tri_{tag}.so"
    report = ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        report = proc.stdout + proc.stderr
    if _lib is None:
        lib = ctypes.CDLL(str(so))
        for name in _ENTRY:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return so, report


def reset_launch_counts() -> None:
    legendre_synth_tri.launches = 0
    legendre_adj_tri.launches = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def legendre_synth_tri_plain(lam: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("mlr,mcl->mrc", lam, x)


def legendre_adj_tri_plain(lam: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.einsum("mlr,mrc->mcl", lam, g)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch(kind: str, lam: torch.Tensor, b: torch.Tensor,
            out_shape: tuple) -> torch.Tensor:
    if lam.device != b.device or lam.device.type != "cuda":
        raise ValueError(f"legendre_{kind}_tri: tensors on {lam.device} and "
                         f"{b.device}; both must be on one CUDA device")
    if lam.dtype != b.dtype or lam.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"legendre_{kind}_tri: dtypes {lam.dtype}, {b.dtype}; "
                        "the kernel takes float32 or float64, the same for both")
    if not (lam.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"legendre_{kind}_tri: inputs must be contiguous")
    L, _, nr = lam.shape
    C = out_shape[1] if kind == "adj" else out_shape[2]
    out = torch.empty(out_shape, dtype=lam.dtype, device=lam.device)
    if out.numel() == 0:
        return out
    if _lib is None:
        build()
    suffix = "f32" if lam.dtype == torch.float32 else "f64"
    fn = getattr(_lib, f"legendre_{kind}_tri_{suffix}")
    with torch.cuda.device(lam.device):
        stream = torch.cuda.current_stream(lam.device).cuda_stream
        err = fn(lam.data_ptr(), b.data_ptr(), out.data_ptr(), L, nr, C,
                 stream)
    if err != 0:
        raise RuntimeError(f"legendre_{kind}_tri: kernel launch failed with "
                           f"CUDA error {err}")
    return out


def legendre_synth_tri(lam: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[m, r, c] = sum_{l >= m} lam[m, l, r] x[m, c, l].
    lam: (L, L, nr); x: (L, C, L) -> (L, nr, C)."""
    L, L2, nr = lam.shape
    C = x.shape[1]
    if L != L2 or tuple(x.shape) != (L, C, L):
        raise ValueError(f"legendre_synth_tri: lam {tuple(lam.shape)} and x "
                         f"{tuple(x.shape)} do not match (L, L, nr), (L, C, L)")
    if lam.device.type == "cpu" and x.device.type == "cpu":
        return legendre_synth_tri_plain(lam, x)
    out = _launch("synth", lam, x, (L, nr, C))
    legendre_synth_tri.launches += 1
    return out


def legendre_adj_tri(lam: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """out[m, c, l] = sum_r lam[m, l, r] g[m, r, c], zero for l < m.
    lam: (L, L, nr); g: (L, nr, C) -> (L, C, L)."""
    L, L2, nr = lam.shape
    C = g.shape[-1]
    if L != L2 or tuple(g.shape) != (L, nr, C):
        raise ValueError(f"legendre_adj_tri: lam {tuple(lam.shape)} and g "
                         f"{tuple(g.shape)} do not match (L, L, nr), (L, nr, C)")
    if lam.device.type == "cpu" and g.device.type == "cpu":
        return legendre_adj_tri_plain(lam, g)
    out = _launch("adj", lam, g, (L, C, L))
    legendre_adj_tri.launches += 1
    return out


legendre_synth_tri.launches = 0
legendre_adj_tri.launches = 0
