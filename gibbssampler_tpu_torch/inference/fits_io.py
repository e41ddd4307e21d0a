"""Pure-numpy FITS I/O for HEALPix maps (a copy of
``gibbssampler_tpu.inference.fits_io``; no astropy dependency).

Standard HEALPix FITS files are a plain primary HDU followed by one BINTABLE
extension whose columns hold the map in RING or NESTED ordering:

- header: 2880-byte blocks of 80-char "KEY = value" cards, ended by END
- BINTABLE: NAXIS1 bytes/row x NAXIS2 rows, column layout from TFORMn
  (rE = r float32, rD = float64, rJ = int32, rK = int64, rI = int16,
  rB = uint8), big-endian
- HEALPix keywords: NSIDE, ORDERING (RING | NESTED)

``read_healpix_map`` returns RING-ordered maps whatever the file's
ordering (NESTED files are permuted through the bit-deinterleave
nest2ring map).  ``write_healpix_map`` writes a standards-conforming file
that healpy reads.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_healpix_map", "write_healpix_map", "nest2ring", "ring2nest"]

_BLOCK = 2880
_TFORM_DTYPES = {"L": "u1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
                 "E": ">f4", "D": ">f8"}
# healpy's bad-pixel sentinel
UNSEEN = -1.6375e30


# ---------------------------------------------------------------------------
# nest <-> ring index maps (bit de-interleave; HEALPix Gorski et al. 2005)
# ---------------------------------------------------------------------------

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _compress_bits(v: np.ndarray) -> np.ndarray:
    """Keep the even-position bits of v and pack them contiguously."""
    v = v & 0x5555555555555555
    v = (v ^ (v >> 1)) & 0x3333333333333333
    v = (v ^ (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v ^ (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v ^ (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v ^ (v >> 16)) & 0x00000000FFFFFFFF
    return v


def nest2ring(nside: int, ipnest=None) -> np.ndarray:
    """RING index of each NESTED pixel (vectorized; ipnest defaults to all
    pixels, giving the permutation m_ring[nest2ring(ns)] = m_nest)."""
    npix = 12 * nside * nside
    if ipnest is None:
        ipnest = np.arange(npix, dtype=np.int64)
    p = np.asarray(ipnest, dtype=np.int64)
    face = p // (nside * nside)
    q = p - face * nside * nside
    ix = _compress_bits(q)
    iy = _compress_bits(q >> 1)
    jr = _JRLL[face] * nside - ix - iy - 1        # ring number 1..4nside-1
    nr = np.where(jr < nside, jr,
                  np.where(jr > 3 * nside, 4 * nside - jr, nside))
    ncap = 2 * nside * (nside - 1)
    startpix = np.where(
        jr < nside, 2 * nr * (nr - 1),
        np.where(jr > 3 * nside, npix - 2 * nr * (nr + 1),
                 ncap + (jr - nside) * 4 * nside))
    kshift = np.where((jr >= nside) & (jr <= 3 * nside),
                      (jr - nside) & 1, 0)
    jp = (_JPLL[face] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    return startpix + jp - 1


def ring2nest(nside: int, ipring=None) -> np.ndarray:
    """NESTED index of each RING pixel (inverse permutation of nest2ring)."""
    npix = 12 * nside * nside
    n2r = nest2ring(nside)
    r2n = np.empty(npix, dtype=np.int64)
    r2n[n2r] = np.arange(npix, dtype=np.int64)
    if ipring is None:
        return r2n
    return r2n[np.asarray(ipring, dtype=np.int64)]


# ---------------------------------------------------------------------------
# FITS parsing
# ---------------------------------------------------------------------------

def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("'"):
        end = raw.rfind("'")
        return raw[1:end].strip()
    if raw in ("T", "F"):
        return raw == "T"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("D", "E"))
    except ValueError:
        return raw


def _read_header(f) -> dict:
    header = {}
    while True:
        block = f.read(_BLOCK)
        if len(block) < _BLOCK:
            raise ValueError("truncated FITS header")
        for i in range(0, _BLOCK, 80):
            card = block[i: i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                return header
            if not key or key in ("COMMENT", "HISTORY") or card[8] != "=":
                continue
            body = card[9:]
            # strip inline comment (a / outside quotes)
            if body.lstrip().startswith("'"):
                q2 = body.find("'", body.find("'") + 1)
                slash = body.find("/", q2 + 1)
            else:
                slash = body.find("/")
            value = body if slash < 0 else body[:slash]
            header[key] = _parse_value(value)


def _data_size(header) -> int:
    if header.get("NAXIS", 0) == 0:
        return 0
    n = abs(int(header["BITPIX"])) // 8
    for i in range(1, int(header["NAXIS"]) + 1):
        n *= int(header[f"NAXIS{i}"])
    n *= int(header.get("GCOUNT", 1))
    n += int(header.get("PCOUNT", 0))
    return n


def _parse_tform(tform: str):
    tform = tform.strip().upper()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    if code not in _TFORM_DTYPES:
        raise ValueError(f"unsupported TFORM {tform!r}")
    return repeat, np.dtype(_TFORM_DTYPES[code])


def read_healpix_map(path, field=0, dtype=np.float64):
    """Read a HEALPix map from a FITS binary table (hp.read_map
    equivalent).

    field: column index, sequence of indices, or None for all columns.
    Returns (map | (nfields, npix) array, header dict); maps are RING-ordered
    float ``dtype`` regardless of the file's ORDERING.
    """
    with open(path, "rb") as f:
        # primary HDU (skip data if any)
        hdr = _read_header(f)
        size = _data_size(hdr)
        f.seek(-(-size // _BLOCK) * _BLOCK, 1)
        # first extension must be the map table
        hdr = _read_header(f)
        if str(hdr.get("XTENSION", "")).strip() != "BINTABLE":
            raise ValueError(f"expected BINTABLE, got {hdr.get('XTENSION')!r}")
        nrow = int(hdr["NAXIS2"])
        rowbytes = int(hdr["NAXIS1"])
        nfields = int(hdr["TFIELDS"])
        forms = [_parse_tform(hdr[f"TFORM{i + 1}"]) for i in range(nfields)]
        names = [str(hdr.get(f"TTYPE{i + 1}", f"col{i}")).strip()
                 for i in range(nfields)]
        if sum(r * dt.itemsize for r, dt in forms) != rowbytes:
            raise ValueError("TFORM layout does not match NAXIS1")
        raw = f.read(nrow * rowbytes)
        if len(raw) < nrow * rowbytes:
            raise ValueError("truncated FITS data")
    rec = np.frombuffer(raw, dtype=np.dtype(
        [(f"f{i}", dt, (r,)) for i, (r, dt) in enumerate(forms)]))
    cols = list(range(nfields)) if field is None else (
        [field] if np.isscalar(field) else list(field))
    maps = np.stack([rec[f"f{c}"].reshape(-1).astype(dtype) for c in cols])
    npix = maps.shape[-1]
    nside = int(hdr.get("NSIDE", int(np.sqrt(npix / 12))))
    if 12 * nside * nside != npix:
        raise ValueError(f"map length {npix} is not a full-sky nside={nside}")
    ordering = str(hdr.get("ORDERING", "RING")).strip().upper()
    if ordering.startswith("NEST"):
        ring_of_nest = nest2ring(nside)
        out = np.empty_like(maps)
        out[:, ring_of_nest] = maps
        maps = out
    hdr["_names"] = names
    if field is not None and np.isscalar(field):
        return maps[0], hdr
    return maps, hdr


# ---------------------------------------------------------------------------
# FITS writing
# ---------------------------------------------------------------------------

def _card(key: str, value, comment: str = "") -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        body = f"{key:<8}= {value:>20.13E}"
    else:
        body = f"{key:<8}= '{value!s:<8}'"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80).encode("ascii")


def _pad_block(b: bytes, fill: bytes = b" ") -> bytes:
    rem = len(b) % _BLOCK
    return b if rem == 0 else b + fill * (_BLOCK - rem)


def write_healpix_map(path, maps, ordering: str = "RING", names=None,
                      dtype=np.float32):
    """Write RING-ordered map(s) as a standard HEALPix FITS binary table.

    maps: (npix,) or (nfields, npix).  ordering selects the on-disk layout
    ("NESTED" permutes on write; the input is always RING)."""
    maps = np.atleast_2d(np.asarray(maps))
    nfields, npix = maps.shape
    nside = int(np.sqrt(npix / 12))
    if 12 * nside * nside != npix:
        raise ValueError(f"not a full-sky HEALPix length: {npix}")
    ordering = ordering.upper()
    if ordering.startswith("NEST"):
        maps = maps[:, nest2ring(nside)]
        ordering = "NESTED"
    else:
        ordering = "RING"
    names = names or [f"SIGNAL{i + 1}" for i in range(nfields)]
    code = {np.dtype(np.float32): "E", np.dtype(np.float64): "D"}[
        np.dtype(dtype)]
    # 1024 elements per row like healpy when possible
    per_row = 1024 if npix % 1024 == 0 else npix
    nrow = npix // per_row

    primary = b"".join([
        _card("SIMPLE", True), _card("BITPIX", 8), _card("NAXIS", 0),
        _card("EXTEND", True), b"END".ljust(80),
    ])
    itemsize = np.dtype(dtype).itemsize
    ext = [
        _card("XTENSION", "BINTABLE"), _card("BITPIX", 8),
        _card("NAXIS", 2),
        _card("NAXIS1", nfields * per_row * itemsize),
        _card("NAXIS2", nrow), _card("PCOUNT", 0), _card("GCOUNT", 1),
        _card("TFIELDS", nfields),
    ]
    for i, nm in enumerate(names):
        ext.append(_card(f"TTYPE{i + 1}", nm))
        ext.append(_card(f"TFORM{i + 1}", f"{per_row}{code}"))
    ext += [
        _card("PIXTYPE", "HEALPIX"), _card("ORDERING", ordering),
        _card("NSIDE", nside), _card("FIRSTPIX", 0),
        _card("LASTPIX", npix - 1), _card("INDXSCHM", "IMPLICIT"),
        _card("OBJECT", "FULLSKY"), b"END".ljust(80),
    ]
    be = ">" + {"E": "f4", "D": "f8"}[code]
    rows = np.empty((nrow, nfields, per_row), dtype=be)
    for i in range(nfields):
        rows[:, i, :] = maps[i].reshape(nrow, per_row)
    with open(path, "wb") as f:
        f.write(_pad_block(primary))
        f.write(_pad_block(b"".join(ext)))
        f.write(_pad_block(rows.tobytes(), fill=b"\x00"))
