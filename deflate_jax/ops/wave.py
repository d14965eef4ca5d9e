"""Wavefront INFLATE: hint-assisted, fully-vectorized DEFLATE decode.

The reference decodes one bit at a time through a trie walk
(inflate.hpp:226-275, SURVEY.md Q7 — its #1 throughput lever).  Here every
per-bit stage is elementwise work plus statically shifted slices, which
XLA fuses; indexed operations appear only at chunk granularity (span/64)
or symbol granularity (<= 32K per block), and the one sequential stage,
the match fill, lives in ops/fill.py.

Pipeline (per batch of B independent blocks — encoder quirk-Q5 streams):

  host   : parse block headers -> per-block canonical-decode scalars
           (first/lim/base per code length, class boundaries, symbol
           membership bitmasks).  O(header) sequential work on CPU, the
           same split the reference uses for its table build.
  stage A: speculative decode at EVERY bit position p of the block body:
           compare-based canonical decode (15-step first/lim loop; no
           decode tables), symbol identity via bitmask rank-select,
           length/distance values by RFC closed forms -> advance[p],
           emit[p], class[p] ...                       [elementwise]
  stage B: 64-step within-chunk mark automaton.  The encoder records the
           entry PHASE of each 64-bit chunk (max symbol = 48 bits < 64,
           so every chunk contains a symbol start) in the manifest
           ("decode hints"); chunks therefore resolve independently —
           no pointer-chasing, no gathers.  Chain continuity across
           chunks is VERIFIED against the hints (corruption detection).
  stage C: per-chunk emit/symbol counts -> chunk-level exclusive sums
           (output offsets, symbol indices).      [cumsum at span/64]
  stage D: compact marked positions to dense symbol records via
           MONOTONE LOG-SHIFT ROUTING (see route_monotone below — the
           gather/scatter-free reformulation of stable compaction).
  stage E: literal byte values via 256-bit membership-mask rank-select
           at symbol granularity.
  stage F: route symbol records to output-byte slots (literal bytes
           land; match records land at their first covered byte).
  stage G: LZ match fill (ops/fill.py) — the only stage where a byte
           depends on earlier output bytes.

Streams must be self-contained per block (no cross-block references) —
the invariant this package's encoder guarantees (reference quirk Q5,
deflate.hpp:697).  Foreign streams without hints use models/decoder.py
or the host runtime.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from deflate_jax.utils import tables as T

I32 = jnp.int32
HINT_NONE = 255          # hint sentinel: no symbol starts in this chunk
MAXSYM_BITS = 48         # 15 (litlen) + 5 (len extra) + 15 (dist) + 13
NS = 33 * 1024           # symbol-domain slots per block (<=32768 emitters
                         # +1 EOB)
CCAP = 16                # symbol slots per 64-bit chunk after the within-
                         # chunk compaction (stage B output).  A chunk can
                         # only exceed CCAP starts when code lengths run
                         # 1-3 bits (wildly skewed codes on literal runs);
                         # wave_decode flags sum_cnt > CCAP as a per-block
                         # error and callers fall back to slower decoders.
ND = 32768               # output bytes per block
NM = 11264               # match-record slots (>= 32768/3 + 1)


# ====================== host-side metadata ================================
def _canon_meta(lengths: np.ndarray, nlit_split: bool):
    """Per-length canonical-decode scalars for one code.

    Returns dict of [16] int32 arrays:
      lim[l], first[l], base[l]  — compare-decode (c < lim -> length l;
                                   rank = base + c - first)
      meta[l]  — packed class boundaries: nlit(9) | has_eob(1)<<9
                 | nsym...(for dist codes meta is unused)
      mask[l]  — length-symbol membership bitmask (litlen: bit j =
                 symbol 257+j has this length; dist: bit j = symbol j)
      litmask[l] — [16, 8] int32, 256-bit literal membership per length
    plus 'err' bool (oversubscribed / unusable code).

    zlib's incomplete-code allowance (single code of length 1) is
    accepted; decode of the missing code flags invalid downstream.
    """
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    cnt = np.bincount(lengths, minlength=16)[:16].copy()
    cnt[0] = 0
    err = False
    kraft = int(np.sum(cnt[1:] * (1 << (15 - np.arange(1, 16)))))
    npresent = int(cnt.sum())
    if npresent and kraft > (1 << 15):
        err = True
    first = np.zeros(16, np.int64)
    code = 0
    for l in range(1, 16):
        code = (code + cnt[l - 1]) << 1
        first[l] = code
    lim = first + cnt
    base = np.cumsum(cnt) - cnt
    meta = np.zeros(16, np.int64)
    mask = np.zeros(16, np.int64)
    litmask = np.zeros((16, 8), np.int64)
    for l in range(1, 16):
        syms = np.nonzero(lengths == l)[0]
        if nlit_split:
            nlit = int((syms < 256).sum())
            has_eob = int((syms == 256).any())
            meta[l] = nlit | (has_eob << 9)
            for s in syms[syms > 256]:
                mask[l] |= 1 << (int(s) - 257)
            for s in syms[syms < 256]:
                litmask[l, int(s) >> 5] |= 1 << (int(s) & 31)
        else:
            for j, s in enumerate(syms):
                mask[l] |= 1 << int(s)
    return {
        "lim": lim.astype(np.int64), "first": first, "base": base,
        "meta": meta, "mask": mask, "litmask": litmask, "err": err,
    }


def _u32(a):
    return np.asarray(a, np.uint64).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=1)
def _fixed_meta():
    lit = _canon_meta(np.asarray(T.FIXED_LITLEN_LENGTHS), True)
    dst = _canon_meta(np.asarray(T.FIXED_DIST_LENGTHS[:30]), False)
    return lit, dst


class _HostBits:
    """Minimal LSB-first bit reader over bytes (header parse only)."""

    __slots__ = ("data", "pos")

    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos

    def read(self, n):
        p = self.pos
        acc = int.from_bytes(self.data[p >> 3:(p >> 3) + 6], "little")
        self.pos = p + n
        return (acc >> (p & 7)) & ((1 << n) - 1)


def parse_headers_host(stream: bytes, bit_offsets):
    """Parse B block headers; return stacked per-block metadata.

    Fast path: the native runtime walks the sequential header bits
    (dt_parse_headers) and the canonical-decode scalars are computed by
    _canon_meta_batch in vectorized numpy; the pure-Python per-block
    loop below is the fallback and the differential-test oracle.

    Mirrors the split the reference makes between its table build and
    its decode loop (inflate.hpp:136-224 vs 226-275).  Returns a dict of
    numpy arrays keyed for inflate_wave, including btype[B],
    data_start[B] (absolute bit of first symbol), and for stored blocks
    the byte-aligned payload location.
    """
    try:
        from deflate_jax import native as NAT
        raw = NAT.parse_headers(stream, bit_offsets)
    except Exception:
        raw = None
    if raw is not None:
        return _canon_meta_batch(raw)
    return _parse_headers_host_py(stream, bit_offsets)


def _canon_meta_batch(raw):
    """Vectorized _canon_meta over the native header walk's raw output.

    raw: dict from native.parse_headers (btype, data_start, stored_len,
    err, hlit, hdist, lens [B, 320] uint8).  Produces the exact
    parse_headers_host dict (property-tested against the Python path).
    """
    B = len(raw["btype"])
    lens = raw["lens"].astype(np.int64)          # [B, 320]
    hlit = raw["hlit"].astype(np.int64)
    hdist = raw["hdist"].astype(np.int64)
    is_fixed = raw["btype"] == 1
    if is_fixed.any():
        lens = lens.copy()
        lens[is_fixed, :288] = np.asarray(T.FIXED_LITLEN_LENGTHS,
                                          np.int64)
        lens[is_fixed, 288:318] = np.asarray(T.FIXED_DIST_LENGTHS[:30],
                                             np.int64)
        hlit = np.where(is_fixed, 288, hlit)
        hdist = np.where(is_fixed, 30, hdist)

    pos = np.arange(288)
    Ll = np.where(pos[None, :] < hlit[:, None], lens[:, :288], 0)
    dcols = hlit[:, None] + np.arange(32)[None, :]
    Ld = lens[np.arange(B)[:, None], np.minimum(dcols, 319)]
    Ld = np.where(np.arange(32)[None, :] < hdist[:, None], Ld, 0)
    Ld = Ld[:, :30]

    def canon(L, n_max):
        cnt = np.bincount(
            (L + 16 * np.arange(B)[:, None]).ravel(),
            minlength=16 * B).reshape(B, 16)[:, :16].astype(np.int64)
        cnt[:, 0] = 0
        kraft = (cnt[:, 1:] << (15 - np.arange(1, 16))[None, :]).sum(1)
        oversub = (cnt.sum(1) > 0) & (kraft > (1 << 15))
        first = np.zeros((B, 16), np.int64)
        code = np.zeros(B, np.int64)
        for l in range(1, 16):
            code = (code + cnt[:, l - 1]) << 1
            first[:, l] = code
        lim = first + cnt
        base = np.cumsum(cnt, axis=1) - cnt
        return cnt, first, lim, base, oversub

    _, l_first, l_lim, l_base, ov_l = canon(Ll, 288)
    _, d_first, d_lim, d_base, ov_d = canon(Ld, 30)

    # meta: nlit per length | has_eob<<9
    nlit = np.bincount(
        (Ll[:, :256] + 16 * np.arange(B)[:, None]).ravel(),
        minlength=16 * B).reshape(B, 16).astype(np.int64)
    nlit[:, 0] = 0
    eob_l = Ll[:, 256]
    meta = nlit | ((np.arange(16)[None, :] == eob_l[:, None])
                   .astype(np.int64) << 9)
    meta[:, 0] = 0

    def bitmask(M, nbits):
        """[B, 16] int64 masks: bit j of mask[:, l] = (M[:, j] == l)."""
        out = np.zeros((B, 16), np.int64)
        w = (1 << np.arange(nbits, dtype=np.int64))[None, :]
        for l in range(1, 16):
            out[:, l] = ((M == l) * w).sum(1)
        return out

    l_mask = bitmask(Ll[:, 257:288], 31)
    d_mask = bitmask(Ld, 30)

    litmask = np.zeros((B, 16, 8), np.int64)
    for l in range(1, 16):
        bits = np.ascontiguousarray(Ll[:, :256] == l)
        packed = np.packbits(bits, axis=1, bitorder="little")
        litmask[:, l, :] = packed.view("<u4").astype(np.int64)

    err = raw["err"].copy()
    is_huff = (raw["btype"] == 1) | (raw["btype"] == 2)
    err |= is_huff & (ov_l | ov_d)

    res = {"l_lim": _u32(l_lim), "l_first": _u32(l_first),
           "l_base": _u32(l_base), "l_meta": _u32(meta),
           "l_mask": _u32(l_mask), "l_litmask": _u32(litmask),
           "d_lim": _u32(d_lim), "d_first": _u32(d_first),
           "d_base": _u32(d_base), "d_mask": _u32(d_mask)}
    res["btype"] = raw["btype"].astype(np.int64)
    res["data_start"] = raw["data_start"].astype(np.int64)
    res["stored_len"] = raw["stored_len"].astype(np.int64)
    res["hdr_err"] = err.astype(bool)
    return res


def _parse_headers_host_py(stream: bytes, bit_offsets):
    """Pure-Python per-block fallback (and differential oracle) for
    parse_headers_host."""
    B = len(bit_offsets)
    btype = np.zeros(B, np.int64)
    dstart = np.zeros(B, np.int64)
    stored_len = np.zeros(B, np.int64)
    err = np.zeros(B, bool)
    keys = ("l_lim", "l_first", "l_base", "l_meta", "l_mask",
            "d_lim", "d_first", "d_base", "d_mask")
    out = {k: np.zeros((B, 16), np.int64) for k in keys}
    out["l_litmask"] = np.zeros((B, 16, 8), np.int64)
    fx_l, fx_d = _fixed_meta()

    for b, off in enumerate(bit_offsets):
        br = _HostBits(stream, int(off))
        br.read(1)                               # BFINAL
        bt = br.read(2)
        btype[b] = bt
        if bt == 0:
            p = (br.pos + 7) & ~7
            ln = _HostBits(stream, p).read(16)
            nlen = _HostBits(stream, p + 16).read(16)
            if ln ^ nlen != 0xFFFF or (p + 32 + 8 * ln) > 8 * len(stream):
                err[b] = True
            stored_len[b] = ln
            dstart[b] = p + 32                   # payload start (byte al.)
            continue
        if bt == 3:
            err[b] = True
            continue
        if bt == 1:
            lm, dm = fx_l, fx_d
            dstart[b] = br.pos
        else:
            lm, dm, end = _parse_dynamic_meta(stream, br.pos)
            if lm is None:
                err[b] = True
                continue
            dstart[b] = end
        for pre, m in (("l_", lm), ("d_", dm)):
            for k in ("lim", "first", "base", "mask"):
                out[pre + k][b] = m[k]
            if pre == "l_":
                out["l_meta"][b] = m["meta"]
                out["l_litmask"][b] = m["litmask"]
            err[b] |= m["err"]

    res = {k: _u32(v) for k, v in out.items()}
    res["l_litmask"] = _u32(out["l_litmask"])
    res["btype"] = btype.astype(np.int64)
    res["data_start"] = dstart.astype(np.int64)
    res["stored_len"] = stored_len.astype(np.int64)
    res["hdr_err"] = err
    return res


def _parse_dynamic_meta(stream: bytes, hdr_start_bit: int):
    """Re-parse a dynamic header's code lengths into _canon_meta form."""
    from deflate_jax.models.host_inflate import (InflateError, _BitReader,
                                                 _Canon)
    from deflate_jax.utils.tables import CL_ORDER

    br = _BitReader(stream)
    br.pos = hdr_start_bit
    try:
        hlit = br.read(5) + 257
        hdist = br.read(5) + 1
        hclen = br.read(4) + 4
        cl_lens = np.zeros(19, np.int64)
        for k in range(hclen):
            cl_lens[CL_ORDER[k]] = br.read(3)
        cl = _Canon(cl_lens)
        lens = np.zeros(hlit + hdist, np.int64)
        i = 0
        while i < hlit + hdist:
            s = cl.decode(br)
            if s < 16:
                lens[i] = s
                i += 1
            elif s == 16:
                if i == 0:
                    return None, None, 0
                rep = 3 + br.read(2)
                lens[i:i + rep] = lens[i - 1]
                i += rep
            elif s == 17:
                i += 3 + br.read(3)
            else:
                i += 11 + br.read(7)
        if i != hlit + hdist or lens[256] == 0:
            return None, None, 0
    except InflateError:
        return None, None, 0
    return (_canon_meta(lens[:hlit], True),
            _canon_meta(lens[hlit:hlit + hdist], False), br.pos)


# ====================== elementwise primitives ============================
def popcount32(x):
    """SWAR popcount (elementwise, no table)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def select_bit32(m, j):
    """Index of the j-th (0-based) set bit of m — branchless binary
    descent over halves.  Undefined (in-range garbage) if j >= popcount.
    """
    idx = jnp.zeros_like(j)
    for h in (16, 8, 4, 2, 1):
        low = m & ((1 << h) - 1)
        c = popcount32(low)
        go = (j >= c).astype(I32)
        j = j - go * c
        m = jnp.where(go > 0, m >> h, low)
        idx = idx + go * h
    return idx


def route_monotone_left(payloads, delta, rounds: int):
    """Stable monotone routing: element at slot i moves LEFT by delta[i].

    Requirements (caller-guaranteed): destinations i-delta[i] are strictly
    increasing over occupied slots, and delta is NON-DECREASING over
    occupied slots.  Processing displacement bits LSB-first is then
    collision-free: after rounds 0..k-1 positions are p = i - (d mod 2^k),
    and for occupied slots i1<i2 with d1<=d2,
    (d2 mod 2^k) - (d1 mod 2^k) <= d2-d1 (high bits are monotone in d)
    < i2-i1 (destinations distinct), so order is preserved strictly and
    no two elements ever share a slot.  (MSB-first is NOT safe: clearing
    high bits can reorder, e.g. d=7 vs 13.)

    delta < 0 marks an empty slot.  payloads: list of int32 arrays with
    the routed axis LAST.  Returns (payloads, delta_out) where delta_out
    is 0 at landed elements.
    """
    def sl(a, s):                       # a[..., j+s] with tail padding
        pad = jnp.full(a.shape[:-1] + (s,), -1, a.dtype)
        return jnp.concatenate([a[..., s:], pad], axis=-1)

    for k in range(rounds):
        s = 1 << k
        dsh = sl(delta, s)
        inc = (dsh >= 0) & (((dsh >> k) & 1) > 0)
        out = (delta >= 0) & (((delta >> k) & 1) > 0)
        payloads = [jnp.where(inc, sl(p, s), p) for p in payloads]
        delta = jnp.where(inc, dsh - s, jnp.where(out, -1, delta))
    return payloads, delta


def route_monotone_right(payloads, delta, rounds: int):
    """Mirror of route_monotone_left: element moves RIGHT by delta[i];
    destinations strictly increasing, delta NON-DECREASING.

    For rightward moves the safe bit order flips to MSB-first: after
    processing bits K..k the positions are p = i + hi_k(d), and hi_k is
    monotone in d, so p2-p1 >= i2-i1 > 0 — order and distinctness hold
    at every round.  (LSB-first is unsafe here, mirror-image of the
    leftward case.)"""
    def sr(a, s):                       # a[..., j-s] with head padding
        pad = jnp.full(a.shape[:-1] + (s,), -1, a.dtype)
        return jnp.concatenate([pad, a[..., :-s]], axis=-1)

    for k in reversed(range(rounds)):
        s = 1 << k
        dsh = sr(delta, s)
        inc = (dsh >= 0) & (((dsh >> k) & 1) > 0)
        out = (delta >= 0) & (((delta >> k) & 1) > 0)
        payloads = [jnp.where(inc, sr(p, s), p) for p in payloads]
        delta = jnp.where(inc, dsh - s, jnp.where(out, -1, delta))
    return payloads, delta


# ====================== stage A: per-position decode ======================
def _srl(x, n):
    return jax.lax.shift_right_logical(x, n)


def build_peeks(nwords, W64: int):
    """Phase-major peek windows from normalized block windows.

    nwords: [B, 2*W64 + 4] int32, block body bit i at bit (i&31) of word
    i>>5 (LSB-first).  Returns PK, PKH each [B, 64, W64]: PK[b,p,w] =
    32 bits from position 64w+p, PKH the following 32 bits.
    """
    we = nwords[:, 0:2 * W64:2]
    wo = nwords[:, 1:2 * W64 + 1:2]
    w2 = nwords[:, 2:2 * W64 + 2:2]
    w3 = nwords[:, 3:2 * W64 + 3:2]
    pk_rows, pkh_rows = [], []
    for p in range(64):
        if p == 0:
            pk_rows.append(we)
            pkh_rows.append(wo)
        elif p < 32:
            pk_rows.append(_srl(we, p) | (wo << (32 - p)))
            pkh_rows.append(_srl(wo, p) | (w2 << (32 - p)))
        elif p == 32:
            pk_rows.append(wo)
            pkh_rows.append(w2)
        else:
            q = p - 32
            pk_rows.append(_srl(wo, q) | (w2 << (32 - q)))
            pkh_rows.append(_srl(w2, q) | (w3 << (32 - q)))
    return (jnp.stack(pk_rows, axis=1), jnp.stack(pkh_rows, axis=1))


def _canon_decode(PK, g, lim_key, first_key, extra_keys, maxl=15):
    """Compare-based canonical decode at every position.

    PK: peek windows (code bits MSB-of-code-first per RFC 1951 §3.1.1).
    g(key, l): the per-block md scalar for code length l, broadcastable
    against PK (decode_positions supplies it).  extra_keys: md
    arrays whose length-l entry is selected where the code length
    resolves to l.  Returns (found, len_, r_rel, sels) with r_rel = rank
    within the length class.

    Op-count note (stage A is ~300 elementwise ops per bit position):
    the per-round `len` select is folded into the rank
    subtraction — rsel = c - (first[l] - (l << 10)) packs len(4) above
    rank(10) with ONE per-element subtract+select, the l<<10 adjustment
    riding the broadcast scalar for free (rank <= 285 < 1024, so the
    fields never carry into each other).
    """
    z = jnp.zeros(PK.shape, I32)
    c = z
    found = jnp.zeros(PK.shape, bool)
    rsel = z
    sels = [z for _ in extra_keys]

    for l in range(1, maxl + 1):
        c = (c << 1) | (_srl(PK, l - 1) & 1)
        hit = (~found) & (c < g(lim_key, l))
        rsel = jnp.where(hit, c - (g(first_key, l) - (l << 10)), rsel)
        for i, k in enumerate(extra_keys):
            sels[i] = jnp.where(hit, g(k, l), sels[i])
        found = found | hit
    return found, _srl(rsel, 10), rsel & 1023, sels


def decode_core(PK, PKH, g, maxl: int = 15, maxd: int = 15):
    """Stage-A math on peek windows — shape-polymorphic elementwise core
    (decode_positions applies it to [B, 64, W64] operands).

    maxl/maxd bound the canonical-decode compare rounds (litlen /
    distance code lengths).  Stage A is pure elementwise work, so
    skipping rounds no block needs is a direct saving: typical dynamic
    blocks top out at 9-12-bit codes (bench corpus: lit<=9, dist<=11)
    against the RFC's 15.  Callers pass the exact per-bucket maximum
    (ops host-parse the header anyway); a conservative 15 is always
    correct.

    Returns two packed int32 arrays shaped like PK:
      A0 = advance(6) | emit(9)<<6 | class(2)<<15 | X(9)<<17 | len(4)<<26
           where X = r_rel for literals (value resolve) and length-3
           for matches; class: 0=lit 1=match 2=EOB 3=invalid.
      P1 = dist(15).
    """
    found, len_, r_rel, (metasel, masksel) = _canon_decode(
        PK, g, "l_lim", "l_first", ["l_meta", "l_mask"], maxl)

    nlit = metasel & 0x1FF
    has_eob = _srl(metasel, 9) & 1
    is_lit = found & (r_rel < nlit)
    is_eob = found & (has_eob > 0) & (r_rel == nlit)
    is_m = found & ~is_lit & ~is_eob

    # length symbol identity + value (RFC 1951 §3.2.5 closed forms,
    # verified against utils/tables.py in tests)
    j_len = jnp.clip(r_rel - nlit - has_eob, 0, 28)
    li = select_bit32(masksel, j_len)                      # 0..28
    ebits = jnp.where((li < 8) | (li == 28), 0, _srl(li - 4, 2))
    lbase = jnp.where(li < 8, 3 + li,
                      jnp.where(li == 28, 258,
                                3 + ((4 + (li & 3)) << jnp.clip(
                                    _srl(li - 4, 2), 0, 5))))
    lextra = _srl(PK, len_) & ((1 << ebits) - 1)
    length = jnp.where(is_m, lbase + lextra, 1)

    # distance code decodes from the window after len code + extra
    adv1 = len_ + jnp.where(is_m, ebits, 0)
    a1c = jnp.clip(adv1, 1, 24)
    pk2 = _srl(PK, a1c) | (PKH << (32 - a1c))
    dfound, dlen, dr_rel, (dmasksel,) = _canon_decode(
        pk2, g, "d_lim", "d_first", ["d_mask"], maxd)
    dsym = select_bit32(dmasksel, dr_rel)                  # 0..29
    dh = jnp.clip(_srl(dsym, 1) - 1, 0, 13)
    debits = jnp.where(dsym < 4, 0, dh)
    dbase = jnp.where(dsym < 4, 1 + dsym, 1 + ((2 + (dsym & 1)) << dh))
    dextra = _srl(pk2, jnp.clip(dlen, 1, 28)) & ((1 << debits) - 1)
    dist = jnp.where(is_m, dbase + dextra, 0)

    invalid = (~found) | (is_m & ~dfound)
    advance = jnp.where(is_m, adv1 + dlen + debits, len_)
    advance = jnp.clip(advance, 1, 63)
    emit = jnp.where(is_lit, 1, jnp.where(is_m, length, 0))

    cls = jnp.where(invalid, 3,
                    jnp.where(is_eob, 2, jnp.where(is_m, 1, 0)))
    X = jnp.where(is_m, jnp.clip(length - 3, 0, 255), r_rel)
    A0 = (advance | (emit << 6) | (cls << 15) | (X << 17) | (len_ << 26))
    return A0, dist


def decode_positions(nwords, md, W64: int, maxl: int = 15,
                     maxd: int = 15):
    """Stage A, XLA backend: speculative decode at every bit position.

    Returns A0, P1 each [B, 64, W64] int32 (decode_core packing)."""
    PK, PKH = build_peeks(nwords, W64)
    B = PK.shape[0]

    def g(key, l):
        return md[key][:, l].astype(I32).reshape(B, 1, 1)

    return decode_core(PK, PKH, g, maxl, maxd)


# ====================== window prep =======================================
def prepare_windows(stream: bytes, data_starts, W64: int):
    """Extract + bit-normalize each block's body window on the host.

    Returns nwords [B, 2*W64+4] int32 with block b's body bit i at bit
    (i&31) of word i>>5.  numpy (one pass over ~B * window bytes).
    """
    data_starts = np.asarray(data_starts, np.int64)
    B = len(data_starts)
    W32 = 2 * W64 + 4
    pad = (-len(stream)) % 4
    words = np.frombuffer(stream + b"\x00" * pad, np.uint8).view(np.uint32)
    words = np.concatenate([words, np.zeros(W32 + 2, np.uint32)])
    w0 = (data_starts >> 5).astype(np.int64)
    sh = (data_starts & 31).astype(np.uint32)
    idx = w0[:, None] + np.arange(W32 + 1)[None, :]
    win = words[idx]                                   # [B, W32+1]
    shc = sh[:, None]
    lo = win[:, :W32] >> shc
    hi = np.where(shc == 0, 0,
                  win[:, 1:] << (32 - np.maximum(shc, 1)))
    return (lo | hi).view(np.int32)


# ====================== stage B: chunk automaton ==========================
def chunk_automaton(A0, hints, W64: int):
    """Stage B: within-chunk mark automaton — ONE unrolled 64-step pass.

    Seeded from the per-chunk entry-phase hints, marks every symbol
    start (bit t of a chunk can only be set by t' < t since advance
    >= 1, so each bit is final when visited).  The same pass
    accumulates per-chunk sums and emits the per-position within-chunk
    symbol rank (for stage D's routing displacement).  All reads are
    static row slices of the packed A0 — the loop touches [B, W64]
    state only, keeping it bandwidth-cheap.

    Returns (sums dict of [B, W64], rank_rows [B, 64, W64]).
    """
    B = A0.shape[0]
    z = jnp.zeros((B, W64), I32)
    h = hints
    Mlo = jnp.where(h < 32, 1 << jnp.clip(h, 0, 31), 0)
    Mhi = jnp.where((h >= 32) & (h < 64), 1 << jnp.clip(h - 32, 0, 31), 0)
    Clo = Chi = se = sc = sm = sb = si = z
    rank_rows = []
    for t in range(64):
        a = A0[:, t, :]
        bit = (_srl(Mlo, t) if t < 32 else _srl(Mhi, t - 32)) & 1
        adv_t = a & 63
        emit_t = _srl(a, 6) & 511
        cls_t = _srl(a, 15) & 3
        stop_t = cls_t >= 2
        rank_rows.append(sc)
        live = bit & (1 - stop_t.astype(I32))
        nt = t + adv_t
        if t < 31:
            Mlo = Mlo | jnp.where(nt < 32, live << jnp.clip(nt, 0, 31), 0)
        Mhi = Mhi | jnp.where((nt >= 32) & (nt < 64),
                              live << jnp.clip(nt - 32, 0, 31), 0)
        Clo = Clo | jnp.where((nt >= 64) & (nt < 96),
                              live << jnp.clip(nt - 64, 0, 31), 0)
        Chi = Chi | jnp.where(nt >= 96,
                              live << jnp.clip(nt - 96, 0, 31), 0)
        se = se + bit * emit_t
        sc = sc + bit
        sm = sm + bit * (cls_t == 1).astype(I32)
        sb = sb + bit * (cls_t == 2).astype(I32)
        si = si + bit * (cls_t == 3).astype(I32)
    sums = {"Mlo": Mlo, "Mhi": Mhi, "Clo": Clo, "Chi": Chi,
            "sum_emit": se, "sum_cnt": sc, "sum_match": sm,
            "sum_eob": sb, "sum_inv": si}
    return sums, jnp.stack(rank_rows, axis=1)


# ====================== stages C-F: assembly ==============================
def _exclusive(a):
    return jnp.cumsum(a, axis=1) - a


def chunk_compact(A0, P1, rank_rows, mk):
    """Within-chunk symbol compaction: chunk w's rank-j marked position
    lands at [b, j, w] of a [B, CCAP, W64] pair of arrays.

    Six monotone log-shift rounds along the PHASE axis (displacement
    t - rank <= 63; columns are independent chunks, and within a column
    rank increments by exactly 1 per mark while t increments by >= 1,
    so displacements are non-decreasing and destinations strictly
    increasing — the route_monotone_left invariant per column)."""
    B, _, W64 = A0.shape
    t_row = jnp.arange(64, dtype=I32)[None, :, None]
    d = jnp.where(mk, t_row - rank_rows, -1)
    a, p = A0, P1

    for k in range(6):
        s = 1 << k

        def sh(x, fill):
            pad = jnp.full((B, s, W64), fill, x.dtype)
            return jnp.concatenate([x[:, s:], pad], axis=1)

        ds = sh(d, -1)
        inc = (ds >= 0) & (((ds >> k) & 1) > 0)
        out = (d >= 0) & (((d >> k) & 1) > 0)
        a = jnp.where(inc, sh(a, 0), a)
        p = jnp.where(inc, sh(p, 0), p)
        d = jnp.where(inc, ds - s, jnp.where(out, -1, d))
    return a[:, :CCAP], p[:, :CCAP]


def _unpack_marks(Mlo, Mhi, W64: int):
    rows = [(_srl(Mlo, t) & 1) if t < 32 else (_srl(Mhi, t - 32) & 1)
            for t in range(64)]
    return jnp.stack(rows, axis=1)                    # [B, 64, W64]


def resolve_litval(len_, r_rel, litmask):
    """Literal byte value = r_rel-th set bit of the 256-bit literal
    membership mask for code length len_.  litmask: [B, 16, 8] int32.
    All elementwise (symbol domain)."""
    B = len_.shape[0]
    mw = [jnp.zeros(len_.shape, I32) for _ in range(8)]
    for l in range(1, 16):
        hit = len_ == l
        for q in range(8):
            col = litmask[:, l, q].reshape((B,) + (1,) * (len_.ndim - 1))
            mw[q] = jnp.where(hit, col, mw[q])
    j = r_rel
    acc = jnp.zeros_like(j)
    found = jnp.zeros(j.shape, bool)
    word = jnp.zeros_like(j)
    jrel = jnp.zeros_like(j)
    wq = jnp.zeros_like(j)
    for q in range(8):
        pc = popcount32(mw[q])
        sel = (~found) & (j < acc + pc)
        word = jnp.where(sel, mw[q], word)
        jrel = jnp.where(sel, j - acc, jrel)
        wq = jnp.where(sel, q, wq)
        found = found | sel
        acc = acc + pc
    return (wq << 5) + select_bit32(word, jrel)


def merge_match_runs(rec0, rec1):
    """Fuse adjacent same-distance match records into run records.

    A greedy parse of periodic or repetitive content emits long CHAINS
    of matches at one distance, back to back in output space (the
    509-byte-pattern corpus: ~127 len-258 records per block, all at
    dist 509).  The sequential fill pays a fixed cost per record, so
    chains are collapsed at the symbol domain first: eight halving rounds merge record pairs where the right
    record starts exactly where the left ends and distances agree
    (byte-sequential fill semantics are preserved — a single run at
    the same distance writes the identical bytes).  The len3 field of
    rec0 grows from 9 to up to 16 bits (opos(16) | len3(16) still fits
    int32; ops/fill.py reads 16 bits).  Merged-away records become
    holes; one monotone route re-compacts.  Rounds cost ~10 elementwise
    ops on [B, NM].

    Returns (rec0, rec1, nmatch) with nmatch the post-merge count.
    """
    B = rec0.shape[0]
    live = (rec0 >= 0).astype(I32)
    span = live                                   # records absorbed
    L0, D = rec0, rec1
    for lvl in range(8):
        w = 1 << lvl
        l0 = L0.reshape(B, -1, 2 * w)
        dd = D.reshape(B, -1, 2 * w)
        sp = span.reshape(B, -1, 2 * w)
        lef0, rig0 = l0[:, :, 0], l0[:, :, w]
        can = ((sp[:, :, 0] == w) & (sp[:, :, w] > 0)
               & (dd[:, :, 0] == dd[:, :, w]) & (dd[:, :, 0] > 0)
               & ((rig0 & 0xFFFF)
                  == (lef0 & 0xFFFF) + _srl(lef0, 16) + 3))
        mlen3 = _srl(lef0, 16) + _srl(rig0, 16) + 3
        l0 = l0.at[:, :, 0].set(jnp.where(
            can, (lef0 & 0xFFFF) | (mlen3 << 16), lef0))
        l0 = l0.at[:, :, w].set(jnp.where(can, -1, rig0))
        dd = dd.at[:, :, w].set(jnp.where(can, 0, dd[:, :, w]))
        sp = sp.at[:, :, 0].set(jnp.where(can, sp[:, :, 0] + sp[:, :, w],
                                          sp[:, :, 0]))
        sp = sp.at[:, :, w].set(jnp.where(can, 0, sp[:, :, w]))
        L0 = l0.reshape(B, -1)
        D = dd.reshape(B, -1)
        span = sp.reshape(B, -1)
    lv = (L0 >= 0).astype(I32)
    rank = jnp.cumsum(lv, axis=1) - lv
    lane = jnp.broadcast_to(jnp.arange(L0.shape[1], dtype=I32)[None],
                            L0.shape)
    dmv = jnp.where(lv > 0, lane - rank, -1)
    (L0, D), dmo = route_monotone_left(
        [L0, D], dmv, int(L0.shape[1] - 1).bit_length())
    L0 = jnp.where(dmo == 0, L0, -1)
    D = jnp.where(dmo == 0, D, 0)
    return L0, D, jnp.sum(lv, axis=1)


@functools.partial(jax.jit, static_argnames=("W64", "maxl", "maxd"))
def wave_decode(nwords, hints, out_expect, md, W64: int, stop_bit=None,
                maxl: int = 15, maxd: int = 15):
    """Stages A-F on device for one bucket of B huffman blocks.

    nwords [B, 2*W64+4] normalized windows; hints [B, W64] int32;
    out_expect [B] expected produced bytes (manifest); md: device dict
    from parse_headers_host.

    stop_bit [B] int32 (optional): per-block SYNTHETIC STOP — a virtual
    block cut at a symbol boundary (native skeleton walk, dt_skeleton)
    carries no EOB, so the decode chain is terminated by overriding the
    stage-A result at exactly that bit position with an EOB record
    (advance 1, emit 0, class 2).  -1 = none (block ends at its real
    EOB).  This is what lets FOREIGN streams' oversized blocks decode as
    <=32 KiB virtual blocks on the wavefront path.

    Returns (litwords [B, ND//4] int32 — literal bytes placed, match
    byte slots zero; rec0, rec1 [B, NM] match records (opos|len3<<16,
    dist); nmatch [B]; produced [B]; err [B] int32).
    """
    B = nwords.shape[0]
    A0, P1 = decode_positions(nwords, md, W64, maxl, maxd)
    if stop_bit is not None:
        # A0[:, t, w] holds bit position 64*w + t
        pos = (jnp.arange(W64, dtype=I32)[None, None, :] * 64
               + jnp.arange(64, dtype=I32)[None, :, None])
        hit = pos == stop_bit.astype(I32)[:, None, None]
        A0 = jnp.where(hit, 1 | (2 << 15), A0)
    sums, rank_rows = chunk_automaton(A0, hints, W64)
    mk0 = _unpack_marks(sums["Mlo"], sums["Mhi"], W64) > 0
    A0c, P1c = chunk_compact(A0, P1, rank_rows, mk0)
    sstart = _exclusive(sums["sum_cnt"])
    produced = jnp.sum(sums["sum_emit"], axis=1)
    nsym = sstart[:, -1] + sums["sum_cnt"][:, -1]
    nmatch = jnp.sum(sums["sum_match"], axis=1)

    # ---- chain validation: carry of chunk w-1 must equal hint of w ----
    h = hints
    elo = jnp.where(h < 32, 1 << jnp.clip(h, 0, 31), 0)
    ehi = jnp.where((h >= 32) & (h < 64), 1 << jnp.clip(h - 32, 0, 31), 0)
    cin_lo = jnp.concatenate(
        [jnp.zeros((B, 1), I32), sums["Clo"][:, :-1]], axis=1)
    cin_hi = jnp.concatenate(
        [jnp.zeros((B, 1), I32), sums["Chi"][:, :-1]], axis=1)
    mism = (cin_lo != elo) | (cin_hi != ehi)
    err = jnp.any(mism[:, 1:], axis=1).astype(I32)
    err = err | ((h[:, 0] != 0)).astype(I32)          # chain starts at 0
    err = err | (jnp.sum(sums["sum_inv"], axis=1) > 0).astype(I32)
    err = err | (jnp.sum(sums["sum_eob"], axis=1) != 1).astype(I32)
    err = err | (produced != out_expect).astype(I32)
    err = err | (nsym > NS).astype(I32)
    err = err | (nmatch > NM).astype(I32)
    err = err | jnp.any(sums["sum_cnt"] > CCAP, axis=1).astype(I32)

    # ---- stage D: route chunk-compact symbol groups to dense slots ---
    # After the within-chunk compaction (A0c/P1c [B, CCAP, W64]), chunk
    # w's cnt[w] symbols sit at lanes w*CCAP..w*CCAP+cnt-1 of the
    # flattened (w-major) view; the whole group moves LEFT by the same
    # displacement w*CCAP - sstart[w], which is non-negative and
    # non-decreasing while cnt <= CCAP (err'd above otherwise), so the
    # monotone route runs at W64*CCAP lanes — 4x fewer than the bit
    # domain 64*W64 it replaced.
    L = W64 * CCAP

    def flatc(a):
        return a.transpose(0, 2, 1).reshape(B, L)

    cnt_rep = jnp.repeat(sums["sum_cnt"], CCAP, axis=1)        # [B, L]
    dval = (jnp.arange(W64, dtype=I32) * CCAP)[None, :] - sstart
    delta = jnp.repeat(dval, CCAP, axis=1)
    j_lane = jnp.tile(jnp.arange(CCAP, dtype=I32), W64)[None, :]
    delta = jnp.where(j_lane < cnt_rep, delta, -1)
    rounds = int(L - 1).bit_length()
    (P0, P1f), dout = route_monotone_left(
        [flatc(A0c), flatc(P1c)], delta, rounds)
    if L < NS:
        pad = NS - L
        P0 = jnp.pad(P0, ((0, 0), (0, pad)))
        P1f = jnp.pad(P1f, ((0, 0), (0, pad)))
        dout = jnp.pad(dout, ((0, 0), (0, pad)), constant_values=-1)
    P0, P1f, dout = P0[:, :NS], P1f[:, :NS], dout[:, :NS]
    valid = dout == 0

    # ---- stage E: unpack + literal values at symbol domain -----------
    emit_s = jnp.where(valid, _srl(P0, 6) & 511, 0)
    cls = _srl(P0, 15) & 3
    X = _srl(P0, 17) & 511
    len_s = _srl(P0, 26) & 15
    is_lit_s = valid & (cls == 0)
    is_m_s = valid & (cls == 1)
    opos = _exclusive(emit_s)
    mcnt = is_m_s.astype(I32)
    mi = jnp.cumsum(mcnt, axis=1) - mcnt
    litval = resolve_litval(len_s, X, md["l_litmask"])

    # ---- match records: compact to [B, NM] ---------------------------
    j_sym = jnp.broadcast_to(jnp.arange(NS, dtype=I32)[None], (B, NS))
    d4 = jnp.where(is_m_s, j_sym - mi, -1)
    (rec0, rec1), d4o = route_monotone_left(
        [opos | (X << 16), P1f], d4, int(NS - 1).bit_length())
    rec0 = jnp.where(d4o[:, :NM] == 0, rec0[:, :NM], -1)
    rec1 = jnp.where(d4o[:, :NM] == 0, rec1[:, :NM], 0)
    rec0, rec1, nmatch = merge_match_runs(rec0, rec1)

    # ---- stage F: place literal bytes at output offsets --------------
    d2 = jnp.where(is_lit_s, opos - j_sym, -1)
    (vout,), d2o = route_monotone_right(
        [litval], d2, int(NS - 1).bit_length())
    lit_b = jnp.where(d2o == 0, vout, 0)[:, :ND]
    lb = lit_b.reshape(B, ND // 4, 4)
    litwords = (lb[:, :, 0] | (lb[:, :, 1] << 8)
                | (lb[:, :, 2] << 16) | (lb[:, :, 3] << 24))
    return litwords, rec0, rec1, nmatch, produced, err


# ====================== host reference hint walk ==========================
def hints_from_walk_host(stream: bytes, bit_offsets, W64cap: int = 4224):
    """Reference hint generator: sequentially walk each block's symbols
    on the host and record each 64-bit chunk's entry phase.

    The encoder emits these for free (models/encoder.py); this walk
    exists for foreign self-contained streams and as the test oracle.
    Returns (hints uint8 [B, W64cap], span_bits int64 [B] — body bits
    incl. EOB, for bucket selection; stored blocks get span 0).
    """
    from deflate_jax.models.host_inflate import _BitReader, _Canon
    from deflate_jax.utils.tables import (DIST_BASE, DIST_EXTRA,
                                          LENGTH_EXTRA)

    md = parse_headers_host(stream, bit_offsets)
    B = len(bit_offsets)
    hints = np.full((B, W64cap), HINT_NONE, np.uint8)
    span = np.zeros(B, np.int64)
    for b in range(B):
        if md["btype"][b] == 0 or md["hdr_err"][b]:
            continue
        ds = int(md["data_start"][b])
        br = _BitReader(stream)
        br.pos = ds
        if md["btype"][b] == 1:
            from deflate_jax.models.host_inflate import _fixed_tables
            lit, dist = _fixed_tables()
        else:
            from deflate_jax.models.host_inflate import \
                _read_dynamic_tables
            hb = _BitReader(stream)
            hb.pos = int(bit_offsets[b]) + 3
            lit, dist = _read_dynamic_tables(hb)
        while True:
            p = br.pos - ds
            w = p >> 6
            if w < W64cap and hints[b, w] == HINT_NONE:
                hints[b, w] = p & 63
            s = lit.decode(br)
            if s == 256:
                span[b] = br.pos - ds
                break
            if s > 256:
                br.read(int(LENGTH_EXTRA[s - 257]))
                d = dist.decode(br)
                br.read(int(DIST_EXTRA[d]))
    return hints, span
