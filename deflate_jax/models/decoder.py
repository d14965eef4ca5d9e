"""Device-side INFLATE: full-stream DEFLATE decode as one jitted program.

Reference analog: `realDecompress` + `decompressHuffmanBlock`
(inflate.hpp:226-322) — a per-bit trie walk (quirk Q7).  The device program
decodes each block in three massively-parallel phases (speculative token
scan, pointer-doubling chain recovery, parallel back-reference resolution;
see ops/inflate_scan.py and ops/header_decode.py), with a `lax.scan` over
blocks carrying only the two true serial dependencies of the format: the
bit position and the output position.

Cross-block back-references (RFC-legal; the reference supports them via its
persistent history buffer, inflate.hpp:284) are handled by resolving all
copies in *global* output coordinates after the scan.

Capacities are static: SPAN bits of compressed body and OUT_CAP output
bytes per block, MAX_BLOCKS blocks per program.  Conforming streams from
this package's encoder always fit (one block = 32 KiB input, Q1/Q5);
foreign streams that overflow set an error flag and the host driver
retries with larger capacities or falls back to the host decoder.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from deflate_jax.ops import bitpack as BP
from deflate_jax.ops import header_decode as HD
from deflate_jax.ops import huffman as H
from deflate_jax.ops import inflate_scan as IS
from deflate_jax.utils import tables as T

FIXED_LIT = np.asarray(T.FIXED_LITLEN_LENGTHS)
FIXED_DIST = np.asarray(T.FIXED_DIST_LENGTHS[:30])


def _byte_at(words, bytepos):
    """Gather bytes at arbitrary byte offsets from the u32 word array."""
    w = words[jnp.clip(bytepos >> 2, 0, words.shape[0] - 1)]
    return ((w >> (8 * (bytepos & 3)).astype(jnp.uint32))
            & jnp.uint32(0xFF)).astype(jnp.int32)


def decode_block(words, start, span: int, out_cap: int, nbits=None):
    """Decode one block starting at bit offset `start` (at BFINAL).

    Returns dict:
      bfinal, error: bool;  next_start: int32 (bit offset after the block)
      produced: int32 — output bytes
      lit_flag uint8 [out_cap] — 1 where the byte is a literal
      lit_val  int32 [out_cap] — literal byte value
      rel_src  int32 [out_cap] — for copy bytes, (local_pos - src) distance
                                 back from this block's base (>0)
    """
    bfinal = BP.peek_bits(words, start, 1).astype(jnp.int32)
    btype = BP.peek_bits(words, start + 1, 2).astype(jnp.int32)

    # ---- stored block ----------------------------------------------------
    data_pos = (start + 3 + 7) & ~7                 # byte aligned
    s_len = BP.peek_bits(words, data_pos, 16).astype(jnp.int32)
    s_nlen = BP.peek_bits(words, data_pos + 16, 16).astype(jnp.int32)
    stored_err = (s_len ^ s_nlen) != 0xFFFF
    if nbits is not None:
        stored_err = stored_err | (data_pos + 32 + 8 * s_len > nbits)
    o = jnp.arange(out_cap, dtype=jnp.int32)
    src_byte = (data_pos + 32) // 8
    stored_bytes = _byte_at(words, src_byte + o)
    stored_next = data_pos + 32 + 8 * s_len

    # ---- huffman blocks --------------------------------------------------
    hdr = HD.parse_dynamic_header(words, start + 3)
    is_dyn = btype == 2
    lit_lens = jnp.where(is_dyn, hdr["litlen_lens"], jnp.asarray(FIXED_LIT))
    dist_lens = jnp.where(is_dyn, hdr["dist_lens"], jnp.asarray(FIXED_DIST))
    body_start = jnp.where(is_dyn, hdr["body_start"], start + 3)
    hdr_err = is_dyn & hdr["error"]

    # litlen/dist oversubscription guard (a bad tree would mis-decode
    # silently through the LUT)
    def kraft_bad(lens):
        L = jnp.arange(1, T.MAX_CODE_LEN + 1, dtype=jnp.int32)
        cnt = jnp.sum((lens[:, None] == L[None, :]).astype(jnp.int32), 0)
        k = jnp.sum(cnt * (1 << (T.MAX_CODE_LEN - L)))
        return k > (1 << T.MAX_CODE_LEN)

    tree_err = kraft_bad(lit_lens) | kraft_bad(dist_lens)

    lit_lut = IS.build_lut(lit_lens)
    dist_lut = IS.build_lut(dist_lens)
    tok = IS.token_scan(words, lit_lut, dist_lut, body_start, span=span)
    reached, eob_local, chain_err = IS.find_chain(tok, span=span)

    adv = jnp.where(reached, tok["out_adv"], 0)
    opos = jnp.cumsum(adv) - adv
    produced_h = jnp.sum(adv)
    overflow = (produced_h > out_cap) | (eob_local >= span)

    idx = jnp.clip(opos, 0, out_cap - 1)
    is_lit = reached & tok["is_lit"]
    is_m = reached & tok["is_match"]

    # per-output-byte info: owning token start (fill forward), literal/copy
    tstart = jnp.full((out_cap,), -1, jnp.int32).at[idx].max(
        jnp.where(reached & (tok["out_adv"] > 0), opos, -1), mode="drop")
    tstart = jax.lax.cummax(tstart)
    litv = jnp.zeros((out_cap,), jnp.int32).at[idx].max(
        jnp.where(is_lit, tok["lit"], 0), mode="drop")
    dstv = jnp.zeros((out_cap,), jnp.int32).at[idx].max(
        jnp.where(is_m, tok["dist"], 0), mode="drop")
    litf = jnp.zeros((out_cap,), jnp.int32).at[idx].max(
        jnp.where(is_lit, 1, 0), mode="drop")

    ts = jnp.clip(tstart, 0, out_cap - 1)
    h_lit_flag = (litf[ts] > 0) & (tstart >= 0)
    h_lit_val = litv[ts]
    h_rel_src = dstv[ts]                            # distance back (global ok)
    huff_next = body_start + eob_local + tok["nbits"][
        jnp.clip(eob_local, 0, span - 1)]
    huff_err = chain_err | overflow | tree_err | hdr_err

    # ---- select by block type -------------------------------------------
    is_stored = btype == 0
    produced = jnp.where(is_stored, s_len, produced_h)
    error = jnp.where(is_stored, stored_err,
                      jnp.where(btype == 3, True, huff_err))
    next_start = jnp.where(is_stored, stored_next, huff_next)
    lit_flag = jnp.where(is_stored, 1, h_lit_flag.astype(jnp.int32))
    lit_val = jnp.where(is_stored, stored_bytes, h_lit_val)
    rel_src = jnp.where(is_stored, 0, h_rel_src)
    live = o < produced
    lit_flag = jnp.where(live, lit_flag, 0).astype(jnp.uint8)
    return {"bfinal": bfinal, "error": error, "next_start": next_start,
            "produced": produced, "lit_flag": lit_flag,
            "lit_val": lit_val.astype(jnp.int32),
            "rel_src": jnp.where(live, rel_src, 0)}


@partial(jax.jit, static_argnames=("span", "out_cap", "max_blocks"))
def decode_stream(words, nbits, span: int, out_cap: int, max_blocks: int):
    """Decode a whole raw-DEFLATE stream on device.

    Returns (out uint8 [max_blocks*out_cap], total int32, nblocks int32,
    error bool).  `out[:total]` is the decoded payload.
    """
    total_cap = max_blocks * out_cap

    def step(carry, _):
        pos, base, done, err = carry
        blk = decode_block(words, pos, span, out_cap, nbits)
        # next_start > nbits means the block body ran past the end of the
        # input: peek_bits zero-fill would otherwise decode garbage silently
        # (fixed-Huffman all-zero 7-bit code is EOB), so surface it as an
        # error even when the speculative chain terminated "cleanly".
        this_err = ~done & (blk["error"] | (pos >= nbits)
                            | (blk["next_start"] > nbits))
        produced = jnp.where(done | this_err, 0, blk["produced"])
        ys = {"lit_flag": blk["lit_flag"], "lit_val": blk["lit_val"],
              "rel_src": blk["rel_src"], "base": base, "produced": produced}
        now_done = done | this_err | ((blk["bfinal"] > 0) & ~done)
        pos = jnp.where(done | this_err, pos, blk["next_start"])
        base = base + produced
        return (pos, base, now_done, err | this_err), ys

    (pos, total, done, error), ys = jax.lax.scan(
        step, (jnp.int32(0), jnp.int32(0), jnp.bool_(False),
               jnp.bool_(False)), None, length=max_blocks)
    error = error | ~done                            # ran out of block slots

    # ---- assemble global arrays -----------------------------------------
    o = jnp.arange(out_cap, dtype=jnp.int32)[None, :]
    live = o < ys["produced"][:, None]
    tgt = jnp.where(live, ys["base"][:, None] + o, total_cap)
    flat_tgt = tgt.reshape(-1)
    known = jnp.zeros((total_cap,), jnp.int32).at[flat_tgt].max(
        ys["lit_flag"].astype(jnp.int32).reshape(-1), mode="drop")
    val = jnp.zeros((total_cap,), jnp.int32).at[flat_tgt].max(
        jnp.where(live, ys["lit_val"], 0).reshape(-1), mode="drop")
    rel = jnp.zeros((total_cap,), jnp.int32).at[flat_tgt].max(
        jnp.where(live, ys["rel_src"], 0).reshape(-1), mode="drop")

    g = jnp.arange(total_cap, dtype=jnp.int32)
    src = jnp.where(known > 0, g, g - rel)
    error = error | jnp.any((known == 0) & (g < total) & (src < 0))
    error = error | jnp.any((known == 0) & (g < total) & (src >= g))
    src = jnp.clip(src, 0, total_cap - 1)

    # ---- resolve copy chains by pointer doubling ------------------------
    def resolve(_, st):
        known, val, src = st
        ks = known[src]
        vs = val[src]
        val = jnp.where((known == 0) & (ks > 0), vs, val)
        known = jnp.maximum(known, ks)
        src = jnp.where(known > 0, src, src[src])
        return known, val, src

    rounds = max(1, (total_cap - 1).bit_length())
    known, val, src = jax.lax.fori_loop(0, rounds, resolve,
                                        (known, val, src))
    nblocks = jnp.sum(ys["produced"] > 0)
    return val.astype(jnp.uint8), total, nblocks, error


def decode_block_standalone(words, start, span: int, out_cap: int):
    """Decode ONE block whose back-references stay inside it (this
    encoder's Q5 invariant — every block it emits is self-contained).

    Used by the data-parallel manifest decoder (parallel/mesh.decode_mesh):
    with per-block bit offsets known, blocks decode with no cross-block
    dependency at all.  Returns (out uint8 [out_cap], produced, error).
    """
    blk = decode_block(words, start, span, out_cap)
    o = jnp.arange(out_cap, dtype=jnp.int32)
    known = blk["lit_flag"].astype(jnp.int32)
    val = blk["lit_val"]
    src = jnp.where(known > 0, o, o - blk["rel_src"])
    live = o < blk["produced"]
    error = blk["error"] | jnp.any(live & (known == 0) & (src < 0))
    src = jnp.clip(src, 0, out_cap - 1)

    def resolve(_, st):
        known, val, src = st
        ks = known[src]
        vs = val[src]
        val = jnp.where((known == 0) & (ks > 0), vs, val)
        known = jnp.maximum(known, ks)
        src = jnp.where(known > 0, src, src[src])
        return known, val, src

    known, val, _ = jax.lax.fori_loop(
        0, max(1, (out_cap - 1).bit_length()), resolve, (known, val, src))
    return val.astype(jnp.uint8), blk["produced"], error


def inflate_device(data: bytes, out_size_hint: int | None = None) -> bytes:
    """Host driver: decode a raw DEFLATE stream on the device, escalating
    capacities on overflow and falling back to the host decoder on error."""
    from deflate_jax.models import host_inflate as HI

    words_np, nbits = BP.bytes_to_words(data)
    words = jnp.asarray(words_np)

    def _pow2(n: int) -> int:
        return 1 << max(0, (n - 1)).bit_length()

    hint = out_size_hint if out_size_hint else max(4 * len(data), 1 << 16)
    # bucket max_blocks to powers of two so varying inputs reuse compiles
    configs = [
        (IS.SPAN, T.BLOCK_SIZE, _pow2(max(8, -(-hint // T.BLOCK_SIZE) + 2))),
        ((1 << 20) + 64, 1 << 20, _pow2(max(4, -(-hint // (1 << 20)) + 2))),
    ]
    for span, out_cap, max_blocks in configs:
        out, total, _, error = decode_stream(
            words, np.int32(nbits), span, out_cap, max_blocks)
        if not bool(error):
            return bytes(np.asarray(out[:int(total)]))
    return HI.inflate_raw(data, out_size_hint)
