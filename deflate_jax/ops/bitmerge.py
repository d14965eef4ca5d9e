"""Binary merge-tree bitstream assembly — elementwise, no scatter or sort.

Reference analog: ``Bitstream::addBits`` + ``copyBitstream``
(deflate.hpp:97-116, 143-150) — the reference appends bits serially.

Offsets can be planned in parallel (cumsum) and bits PLACED with a
scatter (emit_block in models/encoder.py does that).  This module
replaces placement with a logarithmic merge:

  level 0: every leaf is a (value, width<=leaf_bits) packet;
  level k+1: concatenate adjacent level-k segments pairwise —
      out = A | (B <<bit bits(A))
  where segments are little-endian word arrays.  The variable shift is
  one funnel pass (bits(A) mod 32) plus a log-shift word roll
  (bits(A) >> 5, one select round per bit).  Everything is elementwise
  or a static pad/slice along the word axis: zero gathers, zero
  scatters, zero sorts.

Layout: [segments, words, B] with the *batch* as the minor dim.  Word
capacities per
level come from a density bound: a segment of m leaves holds at most
``density*m + slack`` bits (DEFLATE tokens: a literal is <=15 bits and
a match packet <=48 bits covering >=3 positions, so density=16 with
slack=32 for the boundary match; header RLE entries are <=16 bits flat).

A 256x32768-leaf token tree streams ~1.7M roll-round elements per block,
~3.5 GB of device-memory traffic in all.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_srl = jax.lax.shift_right_logical


def _cap_words(density: int, slack: int, m: int, cap_bits: int) -> int:
    """Word capacity of a segment of m leaves."""
    bits = min(density * m + slack, cap_bits)
    return -(-bits // 32)


def merge_bitstream(lo, hi, sh, *, leaf_bits: int, density: int,
                    slack: int, cap_bits: int):
    """Concatenate, per batch row, S variable-width bit fields.

    lo: int32 [B, S] — payload bits 0..31 (bits past sh must be 0)
    hi: int32 [B, S] or None — payload bits 32..63 (leaf_bits > 32)
    sh: int32 [B, S] — widths, 0 allowed; S must be a power of two
    leaf_bits: static max leaf width (<=32 means hi is ignored)
    density/slack: static bound — any m consecutive leaves hold at most
        density*m + slack bits (checked at leaf level vs leaf_bits)
    cap_bits: static whole-row bound (also bounds every segment)

    Returns (words int32 [B, W_top] little-endian LSB-first, bits [B]).
    """
    B, S = sh.shape
    assert S & (S - 1) == 0, S
    assert leaf_bits <= min(density + slack, 64)

    # Layout: [S, W, B] (batch minor) while W is small; once W
    # reaches LANE_W the word axis becomes the minor one ([S, B, W]),
    # so shifts along W never run along a short minor axis.
    LANE_W = 256
    if leaf_bits <= 32:
        arr = lo.T[:, None, :]
    else:
        arr = jnp.stack([lo.T, hi.T], axis=1)
    bits = sh.T.astype(jnp.int32)                   # [S, B]
    wlanes = False                                  # True once [S, B, W]

    k = 0
    while S > 1:
        S //= 2
        maxa = min(density * (1 << k) + slack, cap_bits)  # max bits of A
        if k == 0:
            maxa = min(maxa, leaf_bits)
        k += 1
        Wn = _cap_words(density, slack, 1 << k, cap_bits)
        W = arr.shape[2] if wlanes else arr.shape[1]

        if not wlanes and Wn >= LANE_W:
            arr = arr.transpose(0, 2, 1)            # -> [S, B, W]
            wlanes = True

        if wlanes:
            pair = arr.reshape(S, 2, B, W)
            A, Bv = pair[:, 0], pair[:, 1]
            bp = bits.reshape(S, 2, B)
            bA, bB = bp[:, 0], bp[:, 1]
            if Wn > W:
                Bv = jnp.pad(Bv, ((0, 0), (0, 0), (0, Wn - W)))
            r = (bA & 31)[:, :, None]
            prev = jnp.pad(Bv, ((0, 0), (0, 0), (1, 0)))[:, :, :Wn]
            sb = jnp.where(r == 0, Bv,
                           (Bv << r) | _srl(prev, 32 - jnp.maximum(r, 1)))
            q = (bA >> 5)[:, :, None]
            qmax = maxa >> 5
            for t in range(max(qmax.bit_length(), 1) if qmax else 0):
                s = 1 << t
                shifted = jnp.pad(sb, ((0, 0), (0, 0), (s, 0)))[:, :, :Wn]
                sb = jnp.where(((q >> t) & 1) == 1, shifted, sb)
            if Wn > W:
                A = jnp.pad(A, ((0, 0), (0, 0), (0, Wn - W)))
            arr = A | sb
            bits = bA + bB
            continue

        pair = arr.reshape(S, 2, W, B)
        A, Bv = pair[:, 0], pair[:, 1]
        bp = bits.reshape(S, 2, B)
        bA, bB = bp[:, 0], bp[:, 1]

        if Wn > W:
            Bv = jnp.pad(Bv, ((0, 0), (0, Wn - W), (0, 0)))
        # funnel shift B left by r = bA & 31 (within words)
        r = (bA & 31)[:, None, :]
        prev = jnp.pad(Bv, ((0, 0), (1, 0), (0, 0)))[:, :Wn]
        sb = jnp.where(r == 0, Bv,
                       (Bv << r) | _srl(prev, 32 - jnp.maximum(r, 1)))
        # word roll by q = bA >> 5: one select round per bit of q_max
        q = bA >> 5                                  # [S, B]
        qmax = maxa >> 5
        for t in range(max(qmax.bit_length(), 1) if qmax else 0):
            s = 1 << t
            shifted = jnp.pad(sb, ((0, 0), (s, 0), (0, 0)))[:, :Wn]
            sb = jnp.where((((q >> t) & 1) == 1)[:, None, :], shifted, sb)
        if Wn > W:
            A = jnp.pad(A, ((0, 0), (0, Wn - W), (0, 0)))
        arr = A | sb
        bits = bA + bB

    if wlanes:
        return arr[0], bits[0]                      # already [B, W_top]
    return arr[0].T, bits[0]                        # [B, W_top], [B]


def merge_words(words, bits, cap_words: int):
    """Concatenate B word-array segments at bit granularity (the cross-
    block stream concat — reference: copyBitstream, deflate.hpp:143-150).

    words: int32/uint32 [B, W0], bits beyond bits[b] zero; B power of 2.
    bits:  int32 [B]
    cap_words: static output capacity (>= total bits / 32).

    Same funnel + log-roll merge as merge_bitstream but with the word
    axis on lanes ([S, W] layout — W starts at 8k+ here, so lanes are
    wide without a batch dim).  Replaces a [B*W0]-lane scatter-add
    with ~2.2 GB of streamed elementwise passes.

    Returns (stream int32 [cap_words], total_bits).
    """
    dt = words.dtype
    arr = words.astype(jnp.int32) if dt != jnp.int32 else words
    S, W = arr.shape
    assert S & (S - 1) == 0, S
    bits = bits.astype(jnp.int32)

    while S > 1:
        S //= 2
        Wn = min(2 * W, cap_words)
        pair = arr.reshape(S, 2, W)
        A, Bv = pair[:, 0], pair[:, 1]
        bp = bits.reshape(S, 2)
        bA, bB = bp[:, 0], bp[:, 1]
        if Wn > W:
            Bv = jnp.pad(Bv, ((0, 0), (0, Wn - W)))
        r = (bA & 31)[:, None]
        prev = jnp.pad(Bv, ((0, 0), (1, 0)))[:, :Wn]
        sb = jnp.where(r == 0, Bv,
                       (Bv << r) | _srl(prev, 32 - jnp.maximum(r, 1)))
        q = (bA >> 5)[:, None]
        for t in range(max(W.bit_length(), 1)):
            s = 1 << t
            shifted = jnp.pad(sb, ((0, 0), (s, 0)))[:, :Wn]
            sb = jnp.where(((q >> t) & 1) == 1, shifted, sb)
        if Wn > W:
            A = jnp.pad(A, ((0, 0), (0, Wn - W)))
        arr = A | sb
        bits = bA + bB
        W = Wn

    out = arr[0]
    if W < cap_words:
        out = jnp.pad(out, (0, cap_words - W))
    if dt != jnp.int32:
        out = jax.lax.bitcast_convert_type(out, dt)
    return out, bits[0]


def place_at(words, bits_arr, seg_words, seg_off, *, max_off_bits: int):
    """OR segment arrays into `words` at per-row bit offsets.

    words: int32 [B, W] destination (modified copy returned)
    seg_words: int32 [B, Ws] little-endian segments (Ws <= W)
    seg_off: int32 [B] bit offsets; seg_off + segment bits must fit W*32
    max_off_bits: static bound on seg_off

    Same funnel + log-roll machinery as the tree levels, at [B, W].
    bits_arr is returned untouched (convenience for chained callers).
    """
    Bn, W = words.shape
    Ws = seg_words.shape[1]
    if Ws < W:
        seg_words = jnp.pad(seg_words, ((0, 0), (0, W - Ws)))
    r = (seg_off & 31)[:, None]
    prev = jnp.pad(seg_words, ((0, 0), (1, 0)))[:, :W]
    sb = jnp.where(r == 0, seg_words,
                   (seg_words << r) | _srl(prev, 32 - jnp.maximum(r, 1)))
    q = seg_off >> 5
    qmax = max_off_bits >> 5
    for t in range(max(qmax.bit_length(), 1) if qmax else 0):
        s = 1 << t
        shifted = jnp.pad(sb, ((0, 0), (s, 0)))[:, :W]
        sb = jnp.where((((q >> t) & 1) == 1)[:, None], shifted, sb)
    return words | sb, bits_arr
