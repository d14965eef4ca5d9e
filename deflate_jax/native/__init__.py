"""ctypes bindings for the native host runtime (libdeflate_native.so).

The shared library is built on demand with the in-tree Makefile (g++,
zero dependencies).  All entry points degrade gracefully: if the
toolchain or library is unavailable, `lib()` returns None and callers
fall back to the pure-Python implementations.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libdeflate_native.so")
_lib = None
_tried = False

DT_OK = 0
DT_ERRORS = {
    -1: "truncated or malformed stream",
    -2: "output capacity exceeded",
    -3: "invalid Huffman code or code lengths",
    -4: "distance too far back",
    -5: "reserved block type",
}


def _build() -> bool:
    try:
        subprocess.run(["make", "-s", "-C", _DIR],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(_SO)
    except Exception:
        return False


def lib():
    """The loaded library, building it first if needed; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # always run make: it is a no-op when fresh and rebuilds the .so when
    # the C++ sources are newer (ABI additions would otherwise load stale)
    if not _build() and not os.path.exists(_SO):
        return None
    try:
        L = ctypes.CDLL(_SO)
        L.dt_inflate.restype = ctypes.c_int
        L.dt_inflate.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        L.dt_inflate2.restype = ctypes.c_int
        L.dt_inflate2.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
        L.dt_deflate.restype = ctypes.c_int
        L.dt_deflate.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        L.dt_adler32.restype = ctypes.c_uint32
        L.dt_adler32.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        L.dt_parse_headers.restype = ctypes.c_int
        L.dt_parse_headers.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8)]
        L.dt_skeleton.restype = ctypes.c_int
        L.dt_skeleton.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        for name in ("dt_rfc_tables_inflate", "dt_rfc_tables_deflate"):
            f = getattr(L, name)
            f.restype = None
            f.argtypes = [ctypes.POINTER(ctypes.c_int32)] * 5
        L.dt_stitch.restype = None
        L.dt_stitch.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32)]
        _lib = L
    except OSError:
        _lib = None
    return _lib


def inflate(data: bytes, out_cap: int, exact: bool = False):
    """Native inflate; returns bytes or raises ValueError. None if no lib.

    exact=True treats out_cap as a hard cap (caller declared the output
    size): capacity overflow is an error, matching the Python fallback's
    "output exceeds declared size".  exact=False treats it as a hint and
    grows geometrically, bounded at 1 GiB (a conforming DEFLATE stream
    cannot exceed 1032x expansion, so len(data)*1032 also bounds it).
    """
    L = lib()
    if L is None:
        return None
    limit = min(1 << 30, max(out_cap, 1040 * max(1, len(data)) + 64))
    while True:
        out = (ctypes.c_uint8 * out_cap)()
        out_len = ctypes.c_size_t(0)
        rc = L.dt_inflate(data, len(data), out, out_cap,
                          ctypes.byref(out_len))
        if rc == DT_OK:
            return bytes(bytearray(out)[:out_len.value])
        if rc == -2 and not exact and out_cap < limit:
            out_cap = min(out_cap * 4, limit)
            continue
        raise ValueError(f"inflate: {DT_ERRORS.get(rc, rc)}")


def inflate_consumed(data: bytes, out_cap: int):
    """Native inflate returning (bytes, input_bytes_consumed).

    Used by container parsers (multi-member gzip) that must locate the
    trailer / next member after the DEFLATE payload.  None if no lib.
    """
    L = lib()
    if L is None:
        return None
    limit = min(1 << 30, max(out_cap, 1040 * max(1, len(data)) + 64))
    while True:
        out = (ctypes.c_uint8 * out_cap)()
        out_len = ctypes.c_size_t(0)
        consumed = ctypes.c_size_t(0)
        rc = L.dt_inflate2(data, len(data), out, out_cap,
                           ctypes.byref(out_len), ctypes.byref(consumed))
        if rc == DT_OK:
            return bytes(bytearray(out)[:out_len.value]), consumed.value
        if rc == -2 and out_cap < limit:
            out_cap = min(out_cap * 4, limit)
            continue
        raise ValueError(f"inflate: {DT_ERRORS.get(rc, rc)}")


def deflate(data: bytes, level: int):
    """Native deflate; returns bytes. None if no lib."""
    L = lib()
    if L is None:
        return None
    out_cap = max(1024, len(data) + len(data) // 2 + 4096)
    out = (ctypes.c_uint8 * out_cap)()
    out_len = ctypes.c_size_t(0)
    rc = L.dt_deflate(data, len(data), level, out, out_cap,
                      ctypes.byref(out_len))
    if rc != DT_OK:
        raise ValueError(f"deflate: {DT_ERRORS.get(rc, rc)}")
    return bytes(bytearray(out)[:out_len.value])


def adler32(data: bytes):
    L = lib()
    if L is None:
        return None
    return int(L.dt_adler32(data, len(data)))


def parse_headers(data: bytes, bit_offsets):
    """Batched block-header walk for the wavefront decoder's host prep.

    Returns dict of numpy arrays (btype, data_start, stored_len, err,
    hlit, hdist, lens [B, 320]) or None if the lib is unavailable.
    The batch canonical-metadata math happens in ops/wave.py.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    offs = np.ascontiguousarray(bit_offsets, np.int64)
    B = len(offs)
    btype = np.zeros(B, np.int64)
    dstart = np.zeros(B, np.int64)
    slen = np.zeros(B, np.int64)
    err = np.zeros(B, np.uint8)
    hlit = np.zeros(B, np.int32)
    hdist = np.zeros(B, np.int32)
    lens = np.zeros((B, 320), np.uint8)
    p = ctypes.POINTER
    L.dt_parse_headers(
        data, len(data),
        offs.ctypes.data_as(p(ctypes.c_int64)), B,
        btype.ctypes.data_as(p(ctypes.c_int64)),
        dstart.ctypes.data_as(p(ctypes.c_int64)),
        slen.ctypes.data_as(p(ctypes.c_int64)),
        err.ctypes.data_as(p(ctypes.c_uint8)),
        hlit.ctypes.data_as(p(ctypes.c_int32)),
        hdist.ctypes.data_as(p(ctypes.c_int32)),
        lens.ctypes.data_as(p(ctypes.c_uint8)))
    return {"btype": btype, "data_start": dstart, "stored_len": slen,
            "err": err.astype(bool), "hlit": hlit, "hdist": hdist,
            "lens": lens}


def skeleton(data: bytes, hint_stride: int = 4224, max_vb: int | None = None):
    """Skeleton walk of a raw DEFLATE stream: virtual-block index + decode
    hints for the wavefront device decoder (see dt_skeleton in
    inflate.cpp).  Works on ANY conforming stream — the lever that gives
    foreign (zlib/gzip) streams the vectorized decode path.

    Returns dict(parent_bit, start_bit, out_len, flags, span_bits,
    out_start, btype — int64 [n_vb]; hints uint8 [n_vb, hint_stride];
    total_out int) or None if the native lib is unavailable.
    Raises ValueError on malformed streams.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    if max_vb is None:
        # every vb covers >= 1 output byte or >= one stored block; a
        # conforming stream of n bytes can't exceed ~1032x expansion
        max_vb = max(64, min(2 * len(data) + 16,
                             (1040 * len(data)) // 32768 + 16))
    while True:
        meta = np.zeros((max_vb, 8), np.int64)
        hints = np.zeros((max_vb, hint_stride), np.uint8)
        n_vb = ctypes.c_int64(0)
        total = ctypes.c_int64(0)
        rc = L.dt_skeleton(
            data, len(data), max_vb, hint_stride,
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            hints.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(n_vb), ctypes.byref(total))
        if rc == -2 and max_vb < 1 << 22:
            max_vb *= 4
            continue
        if rc != DT_OK:
            raise ValueError(f"skeleton: {DT_ERRORS.get(rc, rc)}")
        n = n_vb.value
        m = meta[:n]
        return {"parent_bit": m[:, 0].copy(), "start_bit": m[:, 1].copy(),
                "out_len": m[:, 2].copy(), "flags": m[:, 3].copy(),
                "span_bits": m[:, 4].copy(), "out_start": m[:, 5].copy(),
                "btype": m[:, 6].copy(), "hints": hints[:n].copy(),
                "total_out": total.value}


def rfc_tables(which: str):
    """The RFC 1951 constant tables as compiled into one native TU.

    which: "inflate" or "deflate".  Returns dict of numpy int32 arrays
    (len_base, len_extra, dist_base, dist_extra, cl_order) or None if the
    lib is unavailable.  Exists so tests can cross-check the three copies
    of these normative constants (utils/tables.py, inflate.cpp,
    deflate.cpp) against each other.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    lb = np.zeros(29, np.int32)
    le = np.zeros(29, np.int32)
    db = np.zeros(30, np.int32)
    de = np.zeros(30, np.int32)
    co = np.zeros(19, np.int32)
    fn = getattr(L, f"dt_rfc_tables_{which}")
    p = ctypes.POINTER(ctypes.c_int32)
    fn(lb.ctypes.data_as(p), le.ctypes.data_as(p), db.ctypes.data_as(p),
       de.ctypes.data_as(p), co.ctypes.data_as(p))
    return {"len_base": lb, "len_extra": le, "dist_base": db,
            "dist_extra": de, "cl_order": co}


def stitch(segments):
    """Bit-level concat of [(u32 numpy words, nbits), ...] -> (words, bits).

    Returns None if the native lib is unavailable.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    total = sum(int(nb) for _, nb in segments)
    segs = [np.ascontiguousarray(w[: (int(nb) + 31) // 32], dtype=np.uint32)
            for w, nb in segments]
    cat = (np.concatenate(segs) if segs
           else np.zeros(0, np.uint32))
    offsets = np.zeros(len(segs), np.uint64)
    o = 0
    for i, s in enumerate(segs):
        offsets[i] = o
        o += len(s)
    bits = np.asarray([int(nb) for _, nb in segments], np.uint64)
    out = np.zeros(total // 32 + 2, np.uint32)
    L.dt_stitch(cat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                len(segs),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out, total
