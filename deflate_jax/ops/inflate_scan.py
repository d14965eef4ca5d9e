"""Massively-parallel INFLATE: speculative per-bit-offset token decode.

The reference decodes one bit at a time through a trie (inflate.hpp:226-275,
quirk Q7 — the #1 throughput lever).  This formulation decodes a complete
token *at every bit offset simultaneously*, then recovers the one true token
chain with pointer doubling (the self-synchronizing-stream idea from the
parallel-decompression literature, cf. PAPERS.md):

  phase 0: per-tree 2^15-entry LUT — one canonical-arithmetic pass over all
           15-bit windows, so phase 1 decodes a symbol with ONE gather
  phase 1: at every bit offset p: full token (litlen sym + extra + dist sym +
           extra) -> (nbits, out_adv, payload)      [embarrassingly parallel]
  phase 2: jump[p] = p + nbits; the real token chain = orbit of the start
           offset under jump, found by log2(SPAN) scatter/gather doubling
           rounds (EOB absorbs, invalid offsets fall off the end)
  phase 3: output offsets by prefix sum of out_adv over chain tokens;
           literals scatter directly; LZ back-references resolve with
           log2(32K) pointer-doubling rounds over the output block.

Everything here is shape-static, jittable, and vmaps over blocks.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from deflate_jax.ops import bitpack as BP
from deflate_jax.ops import huffman as H
from deflate_jax.utils import tables as T

# max compressed bits of one block body we scan in one shot; our encoder
# never emits a Huffman block larger than the stored alternative
# (3+7+32+8*32768 bits), so 2^18+64 covers any block we produce.  Foreign
# encoders may exceed this — the driver detects overflow and falls back.
SPAN = (1 << 18) + 64
LUT_BITS = 15
LUT_SIZE = 1 << LUT_BITS


def build_lut(lengths: jax.Array) -> jax.Array:
    """Decode LUT over all 15-bit LSB-first windows: (sym << 5) | code_len.

    code_len == 0 marks an invalid window.  128 KiB per tree in int32.
    """
    tbl = H.decode_tables(lengths)
    windows = jnp.arange(LUT_SIZE, dtype=jnp.uint32)
    sym, ln = H.decode_one(windows, tbl)
    return jnp.where(ln > 0, (sym << 5) | ln, 0)


def token_scan(words: jax.Array, lit_lut: jax.Array, dist_lut: jax.Array,
               start: jax.Array, max_dist=None, span: int = SPAN):
    """Decode a speculative token at every bit offset start + [0, span).

    Returns dict of [span] arrays: nbits, out_adv, is_lit, is_match, is_eob,
    invalid, lit (byte value), length, dist.
    """
    i = jnp.arange(span, dtype=jnp.int32)
    p = start + i
    w15 = BP.peek_bits(words, p, LUT_BITS)
    e = lit_lut[w15]
    sym = e >> 5
    ll = e & 31
    is_eob = sym == 256
    is_lit = sym < 256
    is_len = (sym > 256) & (sym < 286)

    lc = jnp.clip(sym - 257, 0, 28)
    leb = jnp.asarray(T.LENGTH_EXTRA)[lc]
    lext = BP.peek_bits(words, p + ll, 5).astype(jnp.int32) & ((1 << leb) - 1)
    length = jnp.asarray(T.LENGTH_BASE)[lc] + lext

    q = p + ll + leb
    de = dist_lut[BP.peek_bits(words, q, LUT_BITS)]
    dsym = de >> 5
    dl = de & 31
    dvalid = (dl > 0) & (dsym < 30)
    dc = jnp.clip(dsym, 0, 29)
    deb = jnp.asarray(T.DIST_EXTRA)[dc]
    dext = BP.peek_bits(words, q + dl, 13).astype(jnp.int32) & ((1 << deb) - 1)
    dist = jnp.asarray(T.DIST_BASE)[dc] + dext

    nbits = jnp.where(is_len, ll + leb + dl + deb, ll)
    invalid = (ll == 0) | (sym >= 286) & ~is_eob | (is_len & ~dvalid)
    if max_dist is not None:
        invalid = invalid | (is_len & (dist > max_dist))
    out_adv = jnp.where(is_lit, 1, jnp.where(is_len, length, 0))
    lit = jnp.where(is_lit, sym, 0)
    return {"nbits": nbits, "out_adv": out_adv, "is_lit": is_lit,
            "is_match": is_len, "is_eob": is_eob, "invalid": invalid,
            "lit": lit, "length": length, "dist": dist}


def find_chain(tok, span: int = SPAN):
    """Phase 2: mark the true token chain starting at local offset 0.

    Returns (reached bool [span] — true tokens, EOB excluded;
             eob_local int32 — offset of the EOB token or span;
             error bool — chain hit an invalid token).
    """
    i = jnp.arange(span, dtype=jnp.int32)
    nxt = i + jnp.maximum(tok["nbits"], 1)
    nxt = jnp.where(tok["is_eob"], i, nxt)                  # EOB absorbs
    nxt = jnp.where(tok["invalid"], span, nxt)              # invalid escapes
    nxt = jnp.minimum(nxt, span)

    g = jnp.concatenate([nxt, jnp.array([span], jnp.int32)])  # sentinel slot
    mark = jnp.zeros((span + 1,), jnp.int32).at[0].set(1)

    def round_(_, st):
        mark, g = st
        tgt = jnp.where(mark > 0, g, span)
        return mark.at[tgt].max(mark, mode="drop"), g[g]

    mark, _ = jax.lax.fori_loop(0, max(1, (span - 1).bit_length()),
                                round_, (mark, g))
    mark = mark[:span] > 0

    eobs = jnp.where(mark & tok["is_eob"], i, span)
    eob_local = jnp.min(eobs)
    error = jnp.any(mark & tok["invalid"] & ~tok["is_eob"])
    reached = mark & ~tok["is_eob"] & ~tok["invalid"]
    return reached, eob_local, error


def emit_block_output(tok, reached, out_len: int):
    """Phase 3 for one block whose output fits in out_len (static) bytes and
    whose back-references stay inside the block (our encoder's Q5 invariant).

    Returns (out uint8 [out_len], produced int32).
    """
    adv = jnp.where(reached, tok["out_adv"], 0)
    opos = jnp.cumsum(adv) - adv                           # token out offsets
    produced = jnp.sum(adv)

    idx = jnp.clip(opos, 0, out_len - 1)
    is_lit = reached & tok["is_lit"]
    is_m = reached & tok["is_match"]

    # per-output-byte token info via scatter + running max fill
    tstart = jnp.full((out_len,), -1, jnp.int32).at[idx].max(
        jnp.where(reached & (tok["out_adv"] > 0), opos, -1), mode="drop")
    tstart = jax.lax.cummax(tstart)  # fill forward

    litv = jnp.zeros((out_len,), jnp.int32).at[idx].max(
        jnp.where(is_lit, tok["lit"], 0), mode="drop")
    dstv = jnp.zeros((out_len,), jnp.int32).at[idx].max(
        jnp.where(is_m, tok["dist"], 0), mode="drop")
    lit_flag = jnp.zeros((out_len,), jnp.int32).at[idx].max(
        jnp.where(is_lit, 1, 0), mode="drop")

    o = jnp.arange(out_len, dtype=jnp.int32)
    ts = jnp.clip(tstart, 0, out_len - 1)
    known = lit_flag[ts] > 0                                # literal bytes
    val = litv[ts]
    src = jnp.where(known, o, o - dstv[ts])
    src = jnp.clip(src, 0, out_len - 1)

    def resolve(_, st):
        known, val, src = st
        ks = known[src]
        vs = val[src]
        val = jnp.where(~known & ks, vs, val)
        known = known | ks
        src = jnp.where(known, src, src[src])
        return known, val, src

    known, val, _ = jax.lax.fori_loop(0, 16, resolve, (known, val, src))
    return val.astype(jnp.uint8), produced
