"""Wavefront device decoder — batch driver for ops/wave.py.

Decodes B independent self-contained DEFLATE blocks (the encoder's
quirk-Q5 streams, reference deflate.hpp:697) on the device, using
per-chunk entry-phase hints carried by the manifest (or derived by a host
walk for hintless self-contained streams).

Responsibilities here: header parse (host), span bucketing (one compile
per bucket size), stored blocks (pure window copy — no wavefront needed),
the stage-G match fill (ops/fill.py), and reassembly to original block
order.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from deflate_jax.ops import fill as F
from deflate_jax.ops import wave as W


BUCKETS = (512, 1024, 1536, 2048, 2560, 3072, 3584, 4224)   # W64 sizes
# (span/64, lane-aligned; fine steps — stage cost scales with the bucket)

# ---- single-transfer call packing ----------------------------------------
# A bucket's 13 operand arrays (windows, hints, sizes, 10 metadata arrays)
# are packed into ONE int32 buffer on the host and sliced back apart inside
# the jit (static offsets), so a whole decode is one host-to-device copy.
# Whether that beats 13 separate copies on a GPU has not been measured.
MD_KEYS9 = ("l_lim", "l_first", "l_base", "l_meta", "l_mask",
            "d_lim", "d_first", "d_base", "d_mask")


def _bucket_words(W64: int, n: int) -> int:
    return n * (2 * W64 + 4) + n * (W64 // 4) + n + n * 272


def _pack_bucket(nw, hsel, sizes, md, sel):
    """One contiguous int32 buffer: nw | hint bytes | sizes | md | litmask."""
    n = len(sel)
    parts = [np.ascontiguousarray(nw, np.int32).ravel(),
             np.ascontiguousarray(hsel, np.uint8).view("<i4").ravel(),
             np.asarray(sizes, np.int32)]
    for k in MD_KEYS9:
        parts.append(np.ascontiguousarray(md[k][sel], np.int32).ravel())
    parts.append(np.ascontiguousarray(md["l_litmask"][sel],
                                      np.int32).ravel())
    return np.concatenate(parts)


def _unpack_bucket(packed, W64: int, n: int):
    c = 2 * W64 + 4
    o0 = n * c
    nw = packed[:o0].reshape(n, c)
    o1 = o0 + n * (W64 // 4)
    hw = packed[o0:o1].reshape(n, W64 // 4)
    hints = jnp.stack([(jax.lax.shift_right_logical(hw, 8 * k)) & 255
                       for k in range(4)], axis=2).reshape(n, W64)
    o2 = o1 + n
    sizes = packed[o1:o2]
    mdj = {}
    off = o2
    for k in MD_KEYS9:
        mdj[k] = packed[off:off + 16 * n].reshape(n, 16)
        off += 16 * n
    mdj["l_litmask"] = packed[off:off + 128 * n].reshape(n, 16, 8)
    return nw, hints, sizes, mdj


@functools.partial(jax.jit, static_argnames=("off", "W64", "n", "maxl",
                                             "maxd"))
def wave_decode_packed(packed, W64: int, n: int, off: int = 0,
                       maxl: int = 15, maxd: int = 15):
    """Stages A-F (ops/wave.wave_decode) over a packed single-transfer
    operand buffer.

    packed may be the shared all-buckets buffer; off is this bucket's
    static word offset within it.  maxl/maxd: the bucket's exact max
    litlen/dist code lengths (host-computed from the parsed headers) —
    stage A skips compare rounds past them.  Returns wave_decode's
    (litwords, rec0, rec1, nmatch, produced, err)."""
    if off:
        packed = jax.lax.slice_in_dim(packed, off,
                                      off + _bucket_words(W64, n))
    nw, hints, sizes, mdj = _unpack_bucket(packed, W64, n)
    return W.wave_decode(nw, hints, sizes, mdj, W64, maxl=maxl, maxd=maxd)


@jax.jit
def fill_packed(litwords, rec0, rec1, nmatch, prod, err):
    """Stage G (ops/fill.fill_matches) on one bucket's wave_decode_packed
    outputs.  Returns ONE [n, OW+2] int32 array (filled words | produced
    | err), so the caller copies one array to the host."""
    filled = F.fill_matches(litwords, rec0, rec1, nmatch)
    return jnp.concatenate(
        [filled, prod[:, None].astype(jnp.int32),
         err[:, None].astype(jnp.int32)], axis=1)


def _common_prep(stream: bytes, bit_offsets, out_sizes, hints):
    """Header parse + stored/huffman classification shared by the
    batched and pipelined paths.  Stored-block window extraction is
    DEFERRED (a lambda) so the pipelined caller can run it while the
    device crunches huffman buckets."""
    bit_offsets = np.asarray(bit_offsets, np.int64)
    out_sizes = np.asarray(out_sizes, np.int64)
    B = len(bit_offsets)
    md = W.parse_headers_host(stream, bit_offsets)
    if hints is None:
        hints, _ = W.hints_from_walk_host(stream, bit_offsets)
    hints = np.asarray(hints, np.uint8)

    # span upper bound from the next block's offset (blocks are dense)
    next_off = np.append(bit_offsets[1:], 8 * len(stream))
    span = np.maximum(next_off - md["data_start"], 0)

    err = np.asarray(md["hdr_err"]).astype(np.int64).copy()
    is_stored = md["btype"] == 0
    sidx = np.nonzero(is_stored & ~md["hdr_err"])[0]
    stored_fn = None
    if len(sidx):
        err[sidx] |= (md["stored_len"][sidx] != out_sizes[sidx])

        def stored_fn():
            nw = W.prepare_windows(stream, md["data_start"][sidx], 4096)
            return nw[:, :F.OW]

    hidx_all = np.nonzero(~is_stored & ~md["hdr_err"])[0]
    overflow = span[hidx_all] > 64 * BUCKETS[-1]
    err[hidx_all[overflow]] = 1
    hidx_all = hidx_all[~overflow]
    prep = {"B": B, "md": md, "err": err, "sidx": sidx,
            "stored_fn": stored_fn, "out_sizes": out_sizes,
            "hints": hints, "hidx_all": hidx_all,
            "need": -(-span[hidx_all] // 64), "stream": stream}
    return prep


def _iter_buckets(prep):
    """Yield (sel, packed_np, W64, n, (maxl, maxd)) per non-empty
    span bucket — window extraction happens lazily per bucket so a
    pipelined consumer can overlap it with device compute."""
    md = prep["md"]
    hints = prep["hints"]
    hidx_all, need = prep["hidx_all"], prep["need"]
    out_sizes, stream = prep["out_sizes"], prep["stream"]
    lens16 = np.arange(16)[None, :]
    cnt_l = (md["l_lim"].astype(np.int64)
             - md["l_first"].astype(np.int64))
    cnt_d = (md["d_lim"].astype(np.int64)
             - md["d_first"].astype(np.int64))
    for W64 in BUCKETS:
        sel = hidx_all[(need <= W64)
                       & (need > (BUCKETS[BUCKETS.index(W64) - 1]
                                  if W64 != BUCKETS[0] else 0))]
        if not len(sel):
            continue
        nw = W.prepare_windows(stream, md["data_start"][sel], W64)
        hsel = np.full((len(sel), W64), W.HINT_NONE, np.uint8)
        hav = min(W64, hints.shape[1])
        hsel[:, :hav] = hints[sel][:, :hav]
        n = len(sel)
        # per-bucket max code lengths: stage A skips compare rounds
        # past them (a code longer than the table's max can never
        # satisfy c < lim, so the skipped rounds are dead).  Quantized
        # to tiers: maxl/maxd are STATIC jit args, so
        # every distinct pair would compile a fresh program variant —
        # tiers bound the variants.
        maxl = int(min(15, max(1, np.max(
            np.where(cnt_l[sel] > 0, lens16, 0)))))
        maxd = int(min(15, max(1, np.max(
            np.where(cnt_d[sel] > 0, lens16, 0)))))
        maxl = next(t for t in (10, 12, 15) if maxl <= t)
        maxd = next(t for t in (13, 15) if maxd <= t)
        packed = _pack_bucket(nw, hsel, out_sizes[sel], md, sel)
        yield sel, packed, W64, n, (maxl, maxd)


def prepare_bucketed(stream: bytes, bit_offsets, out_sizes, hints=None):
    """Host prep shared by the driver and the benchmarks: header parse,
    stored/huffman split, span bucketing, window extraction.

    Returns (prep dict, calls) where each call is (sel, (buf, off),
    W64, n, (maxl, maxd)) ready for wave_decode_packed — buf is
    the shared single-h2d operand buffer (already on device), off the
    bucket's static word offset within it, and maxl/maxd the bucket's
    max litlen/dist code lengths."""
    prep = _common_prep(stream, bit_offsets, out_sizes, hints)
    calls = []
    bufs = []
    for sel, packed, W64, n, mm in _iter_buckets(prep):
        calls.append([sel, None, W64, n, mm])
        bufs.append(packed)
    if calls:
        # ONE h2d for every bucket: the shared buffer is sliced back
        # apart at static offsets inside each bucket's jit
        shared = jnp.asarray(np.concatenate(bufs))
        off = 0
        for c, buf in zip(calls, bufs):
            c[1] = (shared, off)
            off += buf.size
    calls = [tuple(c) for c in calls]
    prep["stored_words"] = (prep["stored_fn"]()
                            if prep["stored_fn"] is not None else None)
    return prep, calls


_cat = jax.jit(lambda xs: jnp.concatenate(xs, axis=0))


def inflate_wave_device(stream: bytes, bit_offsets, out_sizes,
                        hints=None):
    """Decode blocks on device; returns (words np[B, 8192] int32 in
    original block order, produced np[B], err np[B]).

    bit_offsets: absolute bit of each block's BFINAL bit (manifest).
    out_sizes:   expected decoded size per block (manifest).
    hints:       [B, >=W64] uint8 per-chunk entry phases (manifest v2);
                 derived by a host walk when absent.
    """
    # one host-to-device copy for all buckets (prepare_bucketed); the
    # bucket programs dispatch asynchronously, and the stored-block window
    # copy runs while they are in flight
    prep, calls = prepare_bucketed(stream, bit_offsets, out_sizes, hints)
    B, md, err = prep["B"], prep["md"], prep["err"]
    words = np.zeros((B, F.OW), np.int32)
    produced = np.zeros(B, np.int64)
    outs = []
    for sel, (buf, off), W64, n, (ml, mdx) in calls:
        outs.append(fill_packed(*wave_decode_packed(
            buf, W64, n, off=off, maxl=ml, maxd=mdx)))
    if prep["stored_words"] is not None:
        words[prep["sidx"]] = prep["stored_words"]
        produced[prep["sidx"]] = md["stored_len"][prep["sidx"]]
    # concatenate on device and copy to the host once
    if outs:
        big = np.asarray(outs[0] if len(outs) == 1 else _cat(outs))
        row = 0
        for sel, _, _, n, _ in calls:
            o = big[row:row + n]
            row += n
            words[sel] = o[:, :F.OW]
            produced[sel] = o[:, F.OW]
            err[sel] |= o[:, F.OW + 1].astype(np.int64)
    return words, produced, err


def inflate_wave(stream: bytes, bit_offsets, out_sizes, hints=None
                 ) -> tuple[bytes, np.ndarray]:
    """Host-assembled convenience wrapper; returns (bytes, err[B])."""
    words, produced, err = inflate_wave_device(
        stream, bit_offsets, out_sizes, hints)
    w = np.asarray(words).view(np.uint8).reshape(len(produced), -1)
    out = b"".join(w[b, :produced[b]].tobytes()
                   for b in range(len(produced)))
    return out, err


# ====================== skeleton-planned decode ============================
# The native skeleton walk (native/inflate.cpp dt_skeleton) cuts ANY
# conforming raw DEFLATE stream — including foreign zlib/gzip output whose
# blocks exceed 32 KiB or reference across block boundaries (reference
# analog: the sequential stream loop, inflate.hpp:277-322) — into <=32 KiB
# VIRTUAL BLOCKS with wavefront decode hints.  Stages A-F then run on all
# virtual blocks in parallel; the walk is sequential on the host, and the
# ordered match fill (fill_matches_hist) resolves cross-block references by
# pointer doubling over the whole stream's output.

GROUP = 64                    # virtual blocks per wave_decode invocation


def skeleton_plan(stream: bytes):
    """Virtual-block plan for a bare raw DEFLATE stream, or None when the
    native runtime is unavailable or the stream is malformed."""
    from deflate_jax import native as NAT

    try:
        return NAT.skeleton(bytes(stream))
    except ValueError:
        return None


@functools.partial(jax.jit, static_argnames=("W64",))
def _wave_group(nw, hints, sizes, mdj, stop_bit, stored, W64: int):
    """One GROUP of planned virtual blocks through stages A-F, with
    stored blocks passed through (their window IS their output) and
    synthetic stops applied to cut blocks."""
    litw, r0, r1, nm, prod, e = W.wave_decode(
        nw, hints, sizes, mdj, W64, stop_bit=stop_bit)
    win = nw[:, :2 * W64 + 4]
    if 2 * W64 + 4 < F.OW:
        win = jnp.pad(win, ((0, 0), (0, F.OW - (2 * W64 + 4))))
    litw = jnp.where(stored[:, None], win[:, :F.OW], litw)
    nm = jnp.where(stored, 0, nm)
    prod = jnp.where(stored, sizes, prod)
    e = jnp.where(stored, 0, e)
    return litw, r0, r1, nm, prod, e


_fill_hist = jax.jit(F.fill_matches_hist)


def inflate_wave_planned(stream: bytes, plan):
    """Decode a skeleton-planned stream on the wavefront path.

    Returns (bytes, err np[n_vb]).  Self-contained plans (every virtual
    block is a whole parent block, no history) take the bucketed fast
    path; anything else takes the ordered path: grouped A-F in parallel,
    one history-resolving match fill over all virtual blocks in stream
    order, one device-to-host copy.
    """
    flags = np.asarray(plan["flags"], np.int64)
    n = len(flags)
    if n == 0:
        return b"", np.zeros(0, np.int64)
    whole = (flags & 2) > 0
    needs_hist = (flags & 4) > 0
    if whole.all() and not needs_hist.any():
        return inflate_wave(stream, plan["parent_bit"], plan["out_len"],
                            plan["hints"])

    out_len = np.asarray(plan["out_len"], np.int64)
    span = np.asarray(plan["span_bits"], np.int64)
    stored = (flags & 1) > 0
    # window size: huffman vbs need the span (+1 bit for the synthetic
    # stop position); stored vbs need their payload bytes in-window
    need = np.where(stored, -(-out_len * 8 // 64), -(-(span + 1) // 64))
    W64 = next((b for b in BUCKETS if b >= int(need.max())), None)
    if W64 is None:
        return None, np.ones(n, np.int64)

    md = W.parse_headers_host(stream, plan["parent_bit"])
    nw = W.prepare_windows(stream, plan["start_bit"], W64)
    hints = np.full((n, W64), W.HINT_NONE, np.uint8)
    hav = min(W64, plan["hints"].shape[1])
    hints[:, :hav] = plan["hints"][:, :hav]
    stop = np.where(whole | stored, -1, span).astype(np.int32)

    npad = -(-n // GROUP) * GROUP

    def pad(a, fill=0):
        if len(a) == n and npad != n:
            return np.concatenate(
                [a, np.full((npad - n,) + a.shape[1:], fill, a.dtype)])
        return a

    nw_p = pad(nw)
    hints_p = pad(hints, W.HINT_NONE)
    sizes_p = pad(out_len.astype(np.int32))
    stop_p = pad(stop, -1)
    stored_p = pad(stored)
    stored_p[n:] = True                     # padding rows pass through
    mdj_keys = [k for k in md if k.startswith(("l_", "d_"))]

    parts = []
    for g0 in range(0, npad, GROUP):
        sl = slice(g0, g0 + GROUP)
        mdj = {k: jnp.asarray(pad(md[k])[sl]) for k in mdj_keys}
        parts.append(_wave_group(
            jnp.asarray(nw_p[sl]), jnp.asarray(hints_p[sl], jnp.int32),
            jnp.asarray(sizes_p[sl]), mdj, jnp.asarray(stop_p[sl]),
            jnp.asarray(stored_p[sl]), W64))
    litw, r0, r1, nm, prod, e = (p[0] if len(parts) == 1 else _cat(list(p))
                                 for p in zip(*parts))
    filled = _fill_hist(litw, r0, r1, nm, jnp.asarray(sizes_p))

    produced = np.asarray(prod)[:n]
    err = np.asarray(e)[:n].astype(np.int64)
    err |= (produced != out_len).astype(np.int64)
    out = np.asarray(filled).view(np.uint8)[:int(out_len.sum())].tobytes()
    return out, err
