"""Canonical Huffman codes as dense tables — no tries, no heaps at decode time.

The reference materializes a pointer-chasing binary trie (`FlatHuffmanTree`,
common.hpp:49-405) and walks it bit by bit.  This formulation keeps
only arrays:

  encode:  lengths[sym] -> canonical codes via length-count / next-code
           arithmetic (RFC 1951 §3.2.2), bit-reversed once so emission is a
           single gather per symbol.
  decode:  per-length (first_code, limit, base_index) vectors + a
           (length, symbol)-sorted symbol list; a symbol is decoded from a
           15-bit peek with 15 fused compare/selects — identical cost at every
           lane, so the whole stream decodes as one vector op.
  build:   length-limited Huffman code lengths from frequencies, fully
           jittable (vmaps over blocks); matches zlib's overflow-fixup
           semantics (reference analog: generateCodeLengths common.hpp:322-404
           including the fixup at 368-390).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from deflate_jax.utils.tables import MAX_CODE_LEN


def bit_reverse(value: jax.Array, nbits: jax.Array) -> jax.Array:
    """Reverse the low `nbits` (<=16) bits of each element (RFC 1951 §3.1.1)."""
    v = value.astype(jnp.uint32)
    v = ((v & 0x5555) << 1) | ((v >> 1) & 0x5555)
    v = ((v & 0x3333) << 2) | ((v >> 2) & 0x3333)
    v = ((v & 0x0F0F) << 4) | ((v >> 4) & 0x0F0F)
    v = ((v & 0x00FF) << 8) | ((v >> 8) & 0x00FF)
    n = nbits.astype(jnp.uint32)
    return jnp.where(n > 0, v >> (16 - jnp.minimum(n, 16)), 0).astype(jnp.int32)


def _next_codes(bl_count):
    """RFC 1951 §3.2.2 next_code recurrence. bl_count[l-1] = #codes of len l.

    Returns int32 [MAX_CODE_LEN + 1]; entry l is the first canonical code of
    length l (entry 0 unused).
    """
    codes = [jnp.int32(0)]
    code = jnp.int32(0)
    prev = jnp.int32(0)
    for l in range(1, MAX_CODE_LEN + 1):
        code = (code + prev) << 1
        codes.append(code)
        prev = bl_count[l - 1]
    return jnp.stack(codes)


def canonical_parts(lengths: jax.Array):
    """Canonical-code building blocks: (rank-within-length int32 [n],
    next_code int32 [16]).  code(sym) = next_code[len] + rank — kept
    apart so the encoder's sorted table-apply can propagate the compact
    (len, rank) pair and reconstruct codes arithmetically."""
    L = jnp.arange(1, MAX_CODE_LEN + 1, dtype=jnp.int32)
    onehot = (lengths[:, None] == L[None, :]).astype(jnp.int32)   # [n, 15]
    bl_count = onehot.sum(axis=0)                                  # [15]
    next_code = _next_codes(bl_count)                              # [16]
    rank = jnp.cumsum(onehot, axis=0) - onehot                     # [n, 15]
    li = jnp.clip(lengths - 1, 0, MAX_CODE_LEN - 1)
    rank_i = jnp.take_along_axis(rank, li[:, None], axis=1)[:, 0]
    return rank_i, next_code


def canonical_codes(lengths: jax.Array):
    """Canonical code assignment from code lengths.

    lengths: int32 [n] (0 = symbol unused).
    Returns (codes int32 [n] — already bit-reversed, ready for LSB-first
    emission; lengths passthrough).
    """
    rank_i, next_code = canonical_parts(lengths)
    code = next_code[jnp.clip(lengths, 0, MAX_CODE_LEN)] + rank_i
    code = jnp.where(lengths > 0, code, 0)
    return bit_reverse(code, lengths), lengths


def decode_tables(lengths: jax.Array):
    """Build canonical-decode vectors from code lengths.

    Returns dict of arrays:
      first[l]  — first canonical code of length l          int32 [16]
      lim[l]    — first + count (exclusive upper bound)     int32 [16]
      base[l]   — #symbols with 0 < length < l              int32 [16]
      syms      — symbols sorted by (length, symbol), used first  int32 [n]
    """
    n = lengths.shape[0]
    L = jnp.arange(1, MAX_CODE_LEN + 1, dtype=jnp.int32)
    counts = (lengths[:, None] == L[None, :]).astype(jnp.int32).sum(0)  # [15]
    first = _next_codes(counts)                                          # [16]
    cnt16 = jnp.concatenate([jnp.zeros((1,), jnp.int32), counts])        # [16]
    lim = first + cnt16
    base = jnp.cumsum(cnt16) - cnt16                                     # [16]
    # sort symbols by (length, symbol); unused symbols pushed to the back
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(lengths > 0, lengths * 1024 + idx, jnp.int32(1 << 30) + idx)
    syms = jnp.argsort(key).astype(jnp.int32)
    return {"first": first, "lim": lim, "base": base, "syms": syms,
            "count": cnt16}


def decode_one(bits15: jax.Array, tbl) -> tuple[jax.Array, jax.Array]:
    """Decode one canonical symbol from a 15-bit LSB-first peek.

    bits15: uint32 of any shape (the next 15 stream bits at each lane).
    Returns (symbol int32, length int32); length 0 marks an invalid code.
    Fully vectorized: 15 unrolled compare/select rounds.
    """
    first, lim, base, syms, count = (
        tbl["first"], tbl["lim"], tbl["base"], tbl["syms"], tbl["count"])
    nsyms = syms.shape[0]
    c = jnp.zeros(bits15.shape, jnp.int32)
    sym = jnp.full(bits15.shape, -1, jnp.int32)
    length = jnp.zeros(bits15.shape, jnp.int32)
    found = jnp.zeros(bits15.shape, jnp.bool_)
    for l in range(1, MAX_CODE_LEN + 1):
        c = (c << 1) | ((bits15 >> (l - 1)) & 1).astype(jnp.int32)
        hit = (~found) & (count[l] > 0) & (c >= first[l]) & (c < lim[l])
        pos = jnp.clip(base[l] + c - first[l], 0, nsyms - 1)
        s = syms[pos]
        sym = jnp.where(hit, s, sym)
        length = jnp.where(hit, l, length)
        found = found | hit
    return sym, length


def huffman_code_lengths(freq: jax.Array, max_len: int) -> jax.Array:
    """Length-limited Huffman code lengths from symbol frequencies. Jittable.

    freq: int32 [n] (n static, <= 512; total frequency < 2**26).
    max_len: static bound (15 for litlen/dist, 7 for the CL alphabet).

    Algorithm: pairwise-merge Huffman on a flat parent array (the reference
    uses a std::priority_queue + recursive depth search, common.hpp:322-404),
    depth recovery by a reverse sweep (parents always have larger indices),
    then zlib's bl_count overflow fixup and shortest-codes-to-most-frequent
    reassignment.  Degenerate cases: 0 used symbols -> all zero; 1 used
    symbol -> that symbol gets length 1 (the reference instead throws and
    falls back to fixed blocks — SURVEY.md B2; we handle it properly).
    """
    lw, sperm, nz = _sort_leaves(freq)
    sorted_leaf_depth, idepth = _depths_two_queue(lw, nz)
    return _finish_lengths(freq, max_len, nz, sperm, sorted_leaf_depth,
                           idepth)


def huffman_lengths_batch(freqs: jax.Array, max_len: int) -> jax.Array:
    """huffman_code_lengths over a batch [B, n]."""
    return jax.vmap(lambda f: huffman_code_lengths(f, max_len))(freqs)


_INF = 1 << 28


def _sort_leaves(freq):
    """Sort leaves ascending by (frequency, symbol); unused -> INF tail.

    Returns (lw sorted weights int32 [n], sperm symbol order int32 [n],
    nz used-symbol count)."""
    n = freq.shape[0]
    idx0 = jnp.arange(n, dtype=jnp.int32)
    wkey = jnp.where(freq > 0, freq, jnp.int32(_INF))
    lw, sperm = jax.lax.sort([wkey, idx0], dimension=0, num_keys=2,
                             is_stable=False)
    return lw, sperm, jnp.sum(freq > 0)


def _depths_two_queue(lw, nz):
    """Two-queue Huffman merge over PRE-SORTED leaf weights: internal
    nodes are created with nondecreasing weights, so both queues stay
    sorted and each merge step touches O(1) elements (ties prefer the
    leaf queue on equal weights).

    Returns (sorted_leaf_depth int32 [n] — depth of the i-th SORTED leaf,
    valid for i < nz; idepth int32 [n] — internal node depths, valid for
    k < nz - 1)."""
    n = lw.shape[0]
    INF = jnp.int32(_INF)

    iw = jnp.full((n,), INF, jnp.int32)             # internal weights
    lpar = jnp.zeros((n,), jnp.int32)               # leaf -> internal k
    ipar = jnp.zeros((n,), jnp.int32)               # internal -> internal

    def pick(st):
        li, ii, lpar, ipar, iw, k = st
        wl = jnp.where(li < n, lw[jnp.minimum(li, n - 1)], INF)
        wi = iw[jnp.minimum(ii, n - 1)]
        take_leaf = wl <= wi
        w = jnp.where(take_leaf, wl, wi)
        lpar = lpar.at[li].set(jnp.where(take_leaf & (w < INF), k,
                                         lpar[li]), mode="drop")
        ipar = ipar.at[ii].set(jnp.where(~take_leaf & (w < INF), k,
                                         ipar[ii]), mode="drop")
        li = li + jnp.where(take_leaf & (w < INF), 1, 0)
        ii = ii + jnp.where(~take_leaf & (w < INF), 1, 0)
        return (li, ii, lpar, ipar, iw, k), w

    def merge_body(k, st):
        li, ii, lpar, ipar, iw = st
        st1, w1 = pick((li, ii, lpar, ipar, iw, k))
        li, ii, lpar, ipar, iw, _ = st1
        st2, w2 = pick((li, ii, lpar, ipar, iw, k))
        li2, ii2, lpar2, ipar2, iw, _ = st2
        do = w2 < INF                   # at least two active nodes remain
        li = jnp.where(do, li2, li)
        ii = jnp.where(do, ii2, ii)
        lpar = jnp.where(do, lpar2, lpar)
        ipar = jnp.where(do, ipar2, ipar)
        iw = iw.at[k].set(jnp.where(do, w1 + w2, INF))
        return li, ii, lpar, ipar, iw

    li, ii, lpar, ipar, iw = jax.lax.fori_loop(
        0, n - 1, merge_body,
        (jnp.int32(0), jnp.int32(0), lpar, ipar, iw))

    # internal-node depths by reverse creation order (parents are always
    # created later); then every leaf depth is one vectorized gather
    nint = jnp.maximum(nz - 1, 1)                   # created internal nodes

    def depth_body(j, idepth):
        k = n - 2 - j
        root = k == nint - 1
        d = jnp.where(root, 0, idepth[jnp.clip(ipar[k], 0, n - 1)] + 1)
        return idepth.at[k].set(jnp.where(k < nint, d, 0))

    idepth = jax.lax.fori_loop(0, n - 1, depth_body,
                               jnp.zeros((n,), jnp.int32))
    sorted_leaf_depth = idepth[jnp.clip(lpar, 0, n - 1)] + 1
    return sorted_leaf_depth, idepth


def _finish_lengths(freq, max_len, nz, sperm, sorted_leaf_depth, idepth):
    """Unpermute depths, apply zlib's overflow fixup, reassign lengths."""
    n = freq.shape[0]
    INF = jnp.int32(_INF)
    nint = jnp.maximum(nz - 1, 1)
    rank = jnp.arange(n, dtype=jnp.int32)
    leaf_depth = jnp.zeros((n,), jnp.int32).at[sperm].set(
        jnp.where(rank < nz, sorted_leaf_depth, 0))
    depth = jnp.concatenate(
        [leaf_depth,
         jnp.where(jnp.arange(n, dtype=jnp.int32) < nint, idepth, 0)])
    m = 2 * n

    # zlib-style overflow fixup on the length histogram.  overflow counts
    # ALL tree nodes (leaves AND internal) deeper than max_len — zlib's
    # gen_bitlen counts clamped-propagation events on every node, and that
    # count is exactly what makes the fixup land on Kraft == 1
    # (verified: exact on 3000 random trees).
    used = freq > 0
    clamped = jnp.minimum(leaf_depth, max_len)
    node_idx = jnp.arange(m, dtype=jnp.int32)
    real = jnp.concatenate([used, node_idx[n:] - n < nz - 1])
    overflow = jnp.sum(jnp.where(real & (depth > max_len), 1, 0))
    lrange = jnp.arange(max_len + 1, dtype=jnp.int32)
    bl = jnp.sum(jnp.where(used[None, :] & (clamped[None, :] == lrange[:, None]),
                           1, 0), axis=1)                      # [max_len+1]

    def fix_cond(st):
        ov, _ = st
        return ov > 0

    def fix_body(st):
        ov, bl = st
        cand = jnp.where((lrange < max_len) & (bl > 0), lrange, -1)
        bits = jnp.max(cand)
        bl = bl.at[bits].add(-1).at[bits + 1].add(2).at[max_len].add(-1)
        return ov - 2, bl

    _, bl = jax.lax.while_loop(fix_cond, fix_body, (overflow, bl))
    bl = bl.at[0].set(0)

    # reassign: rank symbols by frequency (desc, stable), hand out lengths
    # in nondecreasing order driven by the fixed-up histogram
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(used, -freq * 512 + idx, INF + idx)
    order = jnp.argsort(key)
    cum = jnp.cumsum(bl)                                        # [max_len+1]
    r = jnp.arange(n, dtype=jnp.int32)
    len_by_rank = jnp.searchsorted(cum[1:], r, side="right").astype(jnp.int32) + 1
    len_by_rank = jnp.where(r < nz, len_by_rank, 0)
    lengths = jnp.zeros((n,), jnp.int32).at[order].set(len_by_rank)

    # degenerate single-symbol tree: one code of length 1
    lengths = jnp.where(nz == 1, jnp.where(used, 1, 0), lengths)
    return lengths
