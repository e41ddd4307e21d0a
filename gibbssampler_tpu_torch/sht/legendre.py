"""Associated-Legendre / Wigner-d operator tables (float64, on the host).

A copy of the numpy recurrences of ``gibbssampler_tpu.sht.legendre`` (the
port must not import that package, whose ``sht/__init__`` imports jax).
The tables are built once per (lmax, grid) on the host; the transform
loads them to the device in its compute dtype.

The table layer of the JAX package, ported:

- the native engine: ``csrc/tables.cpp`` (a copy of the JAX package's
  ``native/tables.cpp``, the same recurrences in C++ with OpenMP over m),
  built with ``g++ -O3 -march=native -fopenmp`` at first use into the
  package's ``_build/`` (keyed by a hash of the source and the flags) and
  loaded with ctypes; ``legendre_table`` and ``wigner_d_table`` take it when
  it loads.  Without it (no g++, a failed build) they take the numpy
  recurrences below, the reference, after one line on stderr.
- the disk cache: each table is kept in
  ``$XDG_CACHE_HOME/gibbssampler_tpu_torch/tables`` (``~/.cache`` without
  the variable) as a .npy file keyed by the JAX package's (kind, lmax,
  extra, sha1 of the nodes); ``CACHE = False`` turns it off, and so does
  GIBBSSAMPLER_TORCH_TABLE_CACHE=0 in the environment at import.

Conventions
-----------
- ``lambda_lm(x)`` is the orthonormal latitude factor:
  Y_lm(theta, phi) = lambda_lm(cos theta) e^{i m phi},
  lambda_lm = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) P_lm (Condon-Shortley).
- Spin-weighted: sLambda_lm = (-1)^s sqrt((2l+1)/(4 pi)) d^l_{m,-s}(theta).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np
from scipy.special import gammaln

__all__ = ["legendre_table", "wigner_d_table", "spin2_lambda_tables"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "tables.cpp"
_BUILD_DIR = _PKG / "_build"
_GXX = ("g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
_native = {"lib": None, "tried": False}
# the disk cache of the tables; False: every table is computed
CACHE = os.environ.get("GIBBSSAMPLER_TORCH_TABLE_CACHE", "1") != "0"


def native_engine():
    """The native engine's library, built at first use; None where it
    cannot be built or loaded (then the numpy recurrences serve)."""
    if _native["tried"]:
        return _native["lib"]
    _native["tried"] = True
    try:
        tag = hashlib.sha256(" ".join(_GXX).encode()
                             + _SRC.read_bytes()).hexdigest()[:16]
        so = _BUILD_DIR / f"tables_{tag}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run([*_GXX, str(_SRC), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        arr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.gs_legendre_table.argtypes = [ctypes.c_int, ctypes.c_int, arr,
                                          arr]
        lib.gs_wigner_d_table.argtypes = [ctypes.c_int] * 3 + [arr, arr]
        _native["lib"] = lib
    except Exception as e:
        print(f"gibbssampler_tpu_torch.sht.legendre: native table engine "
              f"unavailable ({e}); using numpy", file=sys.stderr)
    return _native["lib"]


def _cache_dir() -> pathlib.Path:
    d = pathlib.Path(os.environ.get("XDG_CACHE_HOME",
                                    os.path.expanduser("~/.cache")))
    return d / "gibbssampler_tpu_torch" / "tables"


def _cached(kind: str, lmax: int, extra, nodes: np.ndarray, compute):
    """The table ``compute()`` gives, through the disk cache keyed by
    (kind, lmax, extra, the nodes): the precompute is O(lmax^2 nrings)
    host work, the same in every run of one configuration."""
    if not CACHE:
        return compute()
    h = hashlib.sha1(np.ascontiguousarray(nodes).tobytes()).hexdigest()[:16]
    f = _cache_dir() / f"{kind}_{lmax}_{extra}_{h}.npy"
    if f.exists():
        try:
            return np.load(f)
        except Exception:
            pass
    out = compute()
    try:
        f.parent.mkdir(parents=True, exist_ok=True)
        tmp = f.with_name(f"{f.stem}.{os.getpid()}.tmp.npy")
        np.save(tmp, out)
        os.replace(tmp, f)
    except Exception:
        pass
    return out


def legendre_table(lmax: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal lambda_lm(x) for all 0 <= m <= l <= lmax.

    x: (nr,) cos(theta) ring nodes.  Returns (lmax+1, lmax+1, nr) float64,
    [m, l, r]; entries with l < m are 0.  The native engine's where it
    loads, else the numpy recurrence's; through the disk cache."""
    x = np.asarray(x, dtype=np.float64)

    def compute():
        lib = native_engine()
        if lib is None:
            return _legendre_table_np(lmax, x)
        xc = np.ascontiguousarray(x)
        out = np.empty((lmax + 1, lmax + 1, xc.shape[0]))
        lib.gs_legendre_table(lmax, xc.shape[0], xc, out)
        return out

    return _cached("leg", lmax, 0, x, compute)


def _legendre_table_np(lmax: int, x: np.ndarray) -> np.ndarray:
    """The numpy reference of ``legendre_table``."""
    x = np.asarray(x, dtype=np.float64)
    nr = x.shape[0]
    L = lmax + 1
    out = np.zeros((L, L, nr))
    sx = np.sqrt(np.maximum(0.0, 1.0 - x * x))  # sin(theta)
    # lambda_00 = sqrt(1/4pi); lambda_{m+1,m+1} = -sqrt((2m+3)/(2m+2)) sx lambda_mm
    lam_mm = np.full(nr, np.sqrt(1.0 / (4.0 * np.pi)))
    for m in range(L):
        out[m, m] = lam_mm
        if m + 1 < L:
            # lambda_{m+1, m} = x sqrt(2m+3) lambda_mm
            out[m, m + 1] = x * np.sqrt(2.0 * m + 3.0) * lam_mm
        for l in range(m + 2, L):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            out[m, l] = a * (x * out[m, l - 1] - b * out[m, l - 2])
        if m + 1 < L:
            lam_mm = -np.sqrt((2.0 * m + 3.0) / (2.0 * m + 2.0)) * sx * lam_mm
    return out


def _d_top_row(j: int, mp, beta: np.ndarray) -> np.ndarray:
    """d^j_{j, mp}(beta) = sqrt((2j)!/((j+mp)!(j-mp)!)) c^{j+mp} (-s)^{j-mp},
    c = cos(beta/2), s = sin(beta/2), in log space (stable for large j)."""
    beta = np.asarray(beta, dtype=np.float64)
    c = np.cos(beta / 2.0)
    s = np.sin(beta / 2.0)
    mp = np.asarray(mp)
    lognorm = 0.5 * (gammaln(2 * j + 1) - gammaln(j + mp + 1)
                     - gammaln(j - mp + 1))
    with np.errstate(divide="ignore"):
        logc = np.where(c > 0, np.log(np.maximum(c, 1e-300)), -np.inf)
        logs = np.where(s > 0, np.log(np.maximum(s, 1e-300)), -np.inf)
    mag = np.exp(lognorm + (j + mp) * logc + (j - mp) * logs)
    # exact pole values (c or s == 0), where the power may be 0
    mag = np.where((c == 0.0) & (j + mp > 0), 0.0, mag)
    mag = np.where((s == 0.0) & (j - mp > 0), 0.0, mag)
    mag = np.where((c == 0.0) & (j + mp == 0), np.exp(lognorm), mag)
    mag = np.where((s == 0.0) & (j - mp == 0), np.exp(lognorm), mag)
    return mag * ((-1.0) ** (j - mp))


def wigner_d_table(lmax: int, s: int, beta: np.ndarray) -> np.ndarray:
    """d^l_{m, s}(beta) for all m = 0..lmax, l = max(m,|s|)..lmax.

    Returns (lmax+1, lmax+1, nr) float64 [m, l, r]; entries with
    l < max(m, |s|) are 0.  The native engine's where it loads, else the
    numpy recurrence's; through the disk cache."""
    beta = np.asarray(beta, dtype=np.float64)

    def compute():
        lib = native_engine()
        if lib is None:
            return _wigner_d_table_np(lmax, s, beta)
        bc = np.ascontiguousarray(beta)
        out = np.empty((lmax + 1, lmax + 1, bc.shape[0]))
        lib.gs_wigner_d_table(lmax, s, bc.shape[0], bc, out)
        return out

    return _cached("wig", lmax, s, beta, compute)


def _wigner_d_table_np(lmax: int, s: int, beta: np.ndarray) -> np.ndarray:
    """The numpy reference of ``wigner_d_table``: upward three-term
    recurrence in l, seeded at l0 = max(m, |s|) with the closed-form
    top-row values."""
    beta = np.asarray(beta, dtype=np.float64)
    x = np.cos(beta)
    nr = beta.shape[0]
    L = lmax + 1
    sa = abs(s)
    out = np.zeros((L, L, nr))
    for m in range(L):
        l0 = max(m, sa)
        if l0 > lmax:
            break
        if m >= sa:
            seed = _d_top_row(m, s, beta)  # d^m_{m, s}
        elif s >= 0:
            # d^l_{m,s} = (-1)^{m-s} d^l_{s,m}
            seed = ((-1.0) ** (m - s)) * _d_top_row(s, m, beta)
        else:
            # d^l_{m,-|s|} = d^l_{|s|,-m}
            seed = _d_top_row(sa, -m, beta)
        out[m, l0] = seed
        dl_m1 = np.zeros(nr)  # d^{l0-1} (its coefficient vanishes at l = l0)
        dl = seed
        for l in range(l0, lmax):
            if l == 0:
                # only reachable for m = s = 0: d^1_{00} = x d^0_{00}
                dl_m1, dl = dl, x * dl
                out[m, l + 1] = dl
                continue
            num = ((2 * l + 1.0) * (l * (l + 1.0) * x - m * s) * dl
                   - (l + 1.0) * np.sqrt(max(l * l - m * m, 0.0)
                                         * max(l * l - s * s, 0.0)) * dl_m1)
            den = l * np.sqrt(((l + 1.0) ** 2 - m * m)
                              * ((l + 1.0) ** 2 - s * s))
            dl_m1, dl = dl, num / den
            out[m, l + 1] = dl
    return out


def spin2_lambda_tables(lmax: int, theta: np.ndarray):
    """(2Lambda, -2Lambda) tables for m >= 0: sLambda[m, l, r].

    +2Lambda uses d^l_{m,-2} and -2Lambda uses d^l_{m,+2}."""
    theta = np.asarray(theta, dtype=np.float64)
    L = lmax + 1
    norm = np.sqrt((2.0 * np.arange(L) + 1.0) / (4.0 * np.pi))[None, :, None]
    lam_p2 = wigner_d_table(lmax, -2, theta) * norm
    lam_m2 = wigner_d_table(lmax, +2, theta) * norm
    return lam_p2, lam_m2
