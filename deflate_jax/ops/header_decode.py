"""Device-side dynamic-Huffman header parsing (RFC 1951 §3.2.7).

Reference analog: `decodeTree` + helpers (inflate.hpp:136-224), which decode
the code-length (CL) symbol stream bit by bit through a trie.  The serial
dependency — each CL op's width depends on the decoded symbol — is broken
with the same speculation trick as the body decode (ops/inflate_scan.py):

  1. decode a speculative CL op at EVERY bit offset of the header span
     (vectorized canonical decode, 7 compare/select rounds)
  2. recover the true op chain with pointer-doubling over the span
  3. op values (op16 repeats the previous emitted length) via a prefix
     "last defining value" scan; emit positions via a prefix sum of
     per-op emit counts
  4. scatter run starts into the combined litlen+dist length array and
     fill forward.

Everything is shape-static and vmaps over blocks.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from deflate_jax.ops import bitpack as BP
from deflate_jax.ops import huffman as H
from deflate_jax.utils import tables as T

# Worst-case dynamic header: 17 preamble + 19*3 CL lengths + 320 ops of
# (7-bit code + up to 7 extra bits).  4608 bits covers it with slack.
HSPAN = 4608
NLTOT = 320                       # hlit <= 288 combined with hdist <= 32


def parse_dynamic_header(words: jax.Array, start: jax.Array):
    """Parse one dynamic block header starting at bit offset `start`
    (the offset of the HLIT field, i.e. 3 bits past the block header).

    words: uint32 [W] — the compressed stream.
    Returns dict:
      litlen_lens int32 [288], dist_lens int32 [30],
      body_start  int32 — bit offset of the first symbol,
      error       bool  — malformed header (bad lengths, oversubscribed
                          CL code, run overflow, missing EOB code)
    """
    start = start.astype(jnp.int32)
    hlit = BP.peek_bits(words, start, 5).astype(jnp.int32) + 257
    hdist = BP.peek_bits(words, start + 5, 5).astype(jnp.int32) + 1
    hclen = BP.peek_bits(words, start + 10, 4).astype(jnp.int32) + 4

    # 3-bit CL code lengths, transmitted in the RFC permutation order
    slot = jnp.arange(19, dtype=jnp.int32)
    raw = BP.peek_bits(words, start + 14 + 3 * slot, 3).astype(jnp.int32)
    raw = jnp.where(slot < hclen, raw, 0)
    cl_lens = jnp.zeros((19,), jnp.int32).at[jnp.asarray(T.CL_ORDER)].set(raw)
    cl_tbl = H.decode_tables(cl_lens)
    # oversubscription check: Kraft sum in units of 2^-7
    counts = cl_tbl["count"][1:T.MAX_CL_CODE_LEN + 1]
    kraft = jnp.sum(counts * (1 << (T.MAX_CL_CODE_LEN
                                    - jnp.arange(1, T.MAX_CL_CODE_LEN + 1))))
    cl_oversub = kraft > (1 << T.MAX_CL_CODE_LEN)

    codes_start = start + 14 + 3 * hclen

    # --- phase 1: speculative CL op at every offset -----------------------
    i = jnp.arange(HSPAN, dtype=jnp.int32)
    p = codes_start + i
    w7 = BP.peek_bits(words, p, 7)
    sym, ln = H.decode_one(w7, cl_tbl)              # CL codes are <= 7 bits
    sym = jnp.where(ln > 0, sym, 19)                # 19 = invalid marker
    eb = jnp.where(sym == 16, 2,
         jnp.where(sym == 17, 3,
         jnp.where(sym == 18, 7, 0)))
    ev = BP.peek_bits(words, p + ln, 7).astype(jnp.int32) & ((1 << eb) - 1)
    nbits = ln + eb
    cnt = jnp.where(sym < 16, 1,
          jnp.where(sym == 16, 3 + ev,
          jnp.where(sym == 17, 3 + ev, 11 + ev)))
    cnt = jnp.where(sym >= 19, 0, cnt)
    invalid = sym >= 19

    # --- phase 2: true op chain via pointer doubling ----------------------
    nxt = i + jnp.maximum(nbits, 1)
    nxt = jnp.where(invalid, HSPAN, nxt)
    nxt = jnp.minimum(nxt, HSPAN)
    g = jnp.concatenate([nxt, jnp.array([HSPAN], jnp.int32)])
    mark = jnp.zeros((HSPAN + 1,), jnp.int32).at[0].set(1)

    def round_(_, st):
        mark, g = st
        tgt = jnp.where(mark > 0, g, HSPAN)
        return mark.at[tgt].max(mark, mode="drop"), g[g]

    mark, _ = jax.lax.fori_loop(0, 13, round_, (mark, g))
    reached = mark[:HSPAN] > 0

    # --- phase 3: emit offsets + the stop point ---------------------------
    target = hlit + hdist
    c = jnp.where(reached, cnt, 0)
    cum = jnp.cumsum(c) - c                          # emitted before this op
    real = reached & (cum < target)
    run_over = jnp.any(real & (cum + cnt > target))
    chain_err = jnp.any(real & invalid)
    # op16 with no previous length (first op) is malformed
    first16 = jnp.any(real & (sym == 16) & (cum == 0))

    # value per op: sym<16 -> sym, 17/18 -> 0, 16 -> last defining value.
    # pack (offset << 5 | value) and take a running max over real defining
    # ops; ops16 then read the latest defining value at or before them.
    defining = real & (sym < 19) & (sym != 16)
    dval = jnp.where(sym < 16, sym, 0)
    packed = jnp.where(defining, (i << 5) | dval, -1)
    lastdef = jax.lax.cummax(packed)
    v = jnp.where(sym == 16, jnp.maximum(lastdef, 0) & 31, dval)

    # --- phase 4: scatter run starts, fill forward ------------------------
    run_start = jnp.where(real, cum, NLTOT)
    owner = jnp.full((NLTOT,), -1, jnp.int32).at[run_start].max(
        jnp.where(real, (run_start << 5) | v, -1), mode="drop")
    owner = jax.lax.cummax(owner)
    lens = jnp.where(owner >= 0, owner & 31, 0)      # [NLTOT]

    j = jnp.arange(T.NUM_LITLEN, dtype=jnp.int32)
    litlen_lens = jnp.where(j < hlit, lens[jnp.minimum(j, NLTOT - 1)], 0)
    k = jnp.arange(30, dtype=jnp.int32)
    dist_lens = jnp.where(k < hdist,
                          lens[jnp.clip(hlit + k, 0, NLTOT - 1)], 0)

    # header end: the first real op that completes the emission
    done_at = jnp.where(real & (cum + cnt == target), i + nbits, -1)
    body_off = jnp.max(done_at)
    no_end = body_off < 0
    body_start = codes_start + jnp.maximum(body_off, 0)

    error = (cl_oversub | run_over | chain_err | first16 | no_end
             | (hlit > 286) | (hdist > 30) | (litlen_lens[256] == 0))
    return {"litlen_lens": litlen_lens, "dist_lens": dist_lens,
            "body_start": body_start, "error": error}
