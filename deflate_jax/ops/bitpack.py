"""Parallel bit-stream assembly and inspection.

The reference packs bits serially, one value at a time, through
``Bitstream::addBits`` (deflate.hpp:97-116) and concatenates streams with a
serial bit-offset copy (``copyBitstream`` deflate.hpp:143-150).  This
formulation removes every serial carry:

  * per-entry bit lengths -> exclusive prefix sum -> absolute bit offsets
  * each entry contributes to at most two u32 words -> scatter-add
    (disjoint bits, so add == or)
  * stream concatenation = the same trick one level up: per-block bit lengths
    -> prefix sum -> whole-block funnel shift -> scatter-add.

All functions are jit/vmap-friendly and run on any JAX backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

UINT32 = jnp.uint32


def pack_bits(values: jax.Array, lengths: jax.Array, num_words: int):
    """Pack LSB-first bit fields into a u32 word array.

    values:  int32/uint32 [N], each occupying the low `lengths[i]` bits
             (values wider than their length are masked). Max 16 bits/entry.
    lengths: int32 [N], 0 allowed (entry contributes nothing).
    num_words: static output capacity in 32-bit words.

    Returns (words uint32 [num_words], total_bits int32 scalar).
    """
    lengths = lengths.astype(jnp.int32)
    mask = jnp.where(lengths > 0, (jnp.int32(1) << lengths) - 1, 0)
    vals = (values.astype(jnp.int32) & mask).astype(UINT32)

    offs = jnp.cumsum(lengths) - lengths          # exclusive prefix sum
    total = jnp.where(lengths.shape[0] > 0, offs[-1] + lengths[-1], 0)

    widx = (offs >> 5).astype(jnp.int32)
    shift = (offs & 31).astype(UINT32)
    lo = vals << shift
    # hi bits spill into the next word; shift amount 32 is UB, guard it.
    hi = jnp.where(shift == 0, UINT32(0), vals >> (UINT32(32) - shift))

    words = jnp.zeros((num_words,), UINT32)
    words = words.at[widx].add(lo, mode="drop")
    words = words.at[widx + 1].add(hi, mode="drop")
    return words, total.astype(jnp.int32)


def concat_bitstreams(block_words: jax.Array, block_bits: jax.Array,
                      num_words: int):
    """Concatenate B bit streams at bit granularity.

    block_words: uint32 [B, W] — each block's packed words (bits beyond
                 block_bits[b] must be zero).
    block_bits:  int32 [B] — number of valid bits per block.
    num_words:   static output capacity.

    Returns (words uint32 [num_words], total_bits).
    """
    B, W = block_words.shape
    offs = jnp.cumsum(block_bits) - block_bits      # [B] absolute bit offsets
    total = offs[-1] + block_bits[-1]

    base = (offs >> 5).astype(jnp.int32)            # [B]
    s = (offs & 31).astype(UINT32)                  # [B]

    w = block_words
    prev = jnp.concatenate([jnp.zeros((B, 1), UINT32), w[:, :-1]], axis=1)
    sh = s[:, None]
    lo = w << sh
    carry = jnp.where(sh == 0, UINT32(0), prev >> (UINT32(32) - sh))
    shifted = lo | carry                            # [B, W]
    # the top bits of the last word spill into word W relative to the block
    tail = jnp.where(s == 0, UINT32(0), w[:, -1] >> (UINT32(32) - s))  # [B]

    tgt = base[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    out = jnp.zeros((num_words,), UINT32)
    out = out.at[tgt.reshape(-1)].add(shifted.reshape(-1), mode="drop")
    out = out.at[base + W].add(tail, mode="drop")
    return out, total.astype(jnp.int32)


def peek_bits(words: jax.Array, bitpos: jax.Array, n: int) -> jax.Array:
    """Read `n` (static, <=32) bits starting at bit offset `bitpos` (LSB-first).

    bitpos may be any shape; returns uint32 of the same shape. Reads past the
    end of `words` return zeros in the out-of-range positions.
    """
    bitpos = bitpos.astype(jnp.int32)
    w = bitpos >> 5
    s = (bitpos & 31).astype(UINT32)
    nw = words.shape[0]
    w0 = jnp.where(w < nw, w, 0)
    w1 = jnp.where(w + 1 < nw, w + 1, 0)
    a = jnp.where(w < nw, words[w0], UINT32(0))
    b = jnp.where(w + 1 < nw, words[w1], UINT32(0))
    lo = a >> s
    hi = jnp.where(s == 0, UINT32(0), b << (UINT32(32) - s))
    out = lo | hi
    if n < 32:
        out = out & UINT32((1 << n) - 1)
    return out


def words_to_bytes(words, total_bits):
    """Host helper: u32 word array -> bytes (numpy), trimmed to ceil(bits/8)."""
    import numpy as np
    nbytes = int((int(total_bits) + 7) // 8)
    raw = np.asarray(words, dtype=np.uint32).view(np.uint8)  # little-endian
    return raw[:nbytes].tobytes()


def bytes_to_words(data: bytes):
    """Host helper: bytes -> (u32 words numpy, nbits)."""
    import numpy as np
    pad = (-len(data)) % 4
    buf = np.frombuffer(data + b"\x00" * pad, dtype=np.uint8)
    return buf.view(np.uint32).copy(), len(data) * 8
