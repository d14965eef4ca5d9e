"""Vectorized LZ77 match finding and parsing for one 32 KiB block.

Reference analog: `class LZ77` (deflate.hpp:190-385).  Its fast path walks a
mutable hash-chain table position by position and is *incorrect* (emits stale
offsets — SURVEY.md B1); its best path is an O(n^2) scalar scan.

Design: the matcher uses NO data-dependent gathers — only elementwise ops,
array shifts and `lax.sort`.  (This shape was chosen for a machine whose
gathers were far slower than its sorts; whether a plain hash-head gather
is faster on a GPU is an open measurement, ROADMAP 3f.)

  1. candidates: co-sort (hash<<15|pos) keys with eight 32-byte window
     words; each position's K most recent same-hash predecessors are then
     *adjacent lanes* (array shifts), exactly the reference's hash-chain
     candidate set produced by one sort.
  2. extension: compare the co-sorted window words at lag k — elementwise;
     gives exact match lengths up to 32 bytes.
  3. restore: one more co-sort by position (the keys are a permutation).
  4. merge-extension: a 32-byte match whose continuation at i+32 chose the
     same distance composes into a longer PROVEN match; three doubling
     rounds over shift-by-32 arrays extend to the full 258 cap.
  5. parse: greedy within 512-byte tiles via one `lax.scan` (sequential in
     the tile-step dimension, vectorized over tiles x blocks); matches
     truncate at tile ends so tiles stay independent.

Everything is jittable and vmaps over blocks.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from deflate_jax.utils.tables import BLOCK_SIZE, MAX_MATCH, MIN_MATCH

HASH_BITS = 15
WIN_WORDS = 8                    # 32-byte comparison window
TILE = 512                       # parse tile size


def _hash15(tri: jax.Array) -> jax.Array:
    """24-bit window -> 15-bit bucket, multiply-free.

    Shift/xor/add mixing instead of the classic `x * 0x9E3779B1`
    Fibonacci hash: the multiply form lowered badly on the machine this
    was first written for.  The output bucket function is part of the
    encoder's stream format only through the matches it finds.
    """
    t = tri
    t = t ^ (t >> 13)
    t = t + (t << 7)
    t = t ^ (t >> 9)
    return (t & jnp.uint32(0x7FFF)).astype(jnp.int32)


def _aligned_words(block: jax.Array) -> jax.Array:
    """u32 little-endian words at byte positions 0,4,8,... ([n/4])."""
    b4 = block.astype(jnp.uint32).reshape(-1, 4)
    return b4[:, 0] | (b4[:, 1] << 8) | (b4[:, 2] << 16) | (b4[:, 3] << 24)


def _le_u32(block: jax.Array) -> jax.Array:
    """u32 little-endian load at every byte position (tail zero-padded).

    Kept for the decoder tests; phase-major internals below avoid the
    byte interleave entirely (it lowers to a pathological relayout).
    """
    w = _aligned_words(block)
    wn = jnp.concatenate([w[1:], jnp.zeros((1,), jnp.uint32)])
    phases = [w]
    for s in (8, 16, 24):
        phases.append((w >> s) | (wn << (32 - s)))
    return jnp.stack(phases, axis=1).reshape(-1)


def _shift_back(a: jax.Array, k: int, fill):
    """a[i-k] with `fill` for i<k (array shift — elementwise)."""
    return jnp.concatenate([jnp.full((k,), fill, a.dtype), a[:-k]])


def _shift_fwd(a: jax.Array, k: int, fill):
    """a[i+k] with `fill` past the end."""
    return jnp.concatenate([a[k:], jnp.full((k,), fill, a.dtype)])


def _xor_bytes_eq(x: jax.Array) -> jax.Array:
    """bytes equal in a u32 xor: 4 if x==0 else index of lowest set byte."""
    lsb = x & (jnp.uint32(0) - x)
    return jnp.where(x == 0, 4,
           jnp.where(lsb & jnp.uint32(0xFF), 0,
           jnp.where(lsb & jnp.uint32(0xFF00), 1,
           jnp.where(lsb & jnp.uint32(0xFF0000), 2, 3)))).astype(jnp.int32)


def find_matches(block: jax.Array, blen: jax.Array, num_cands: int,
                 win_words: int = WIN_WORDS, tiers: tuple = (),
                 toofar3: int = 4096):
    """Best match (length, distance) at every position of one block.

    block: uint8 [n] (n = BLOCK_SIZE, zero padding past blen)
    blen:  int32 scalar — valid bytes
    num_cands: static chain depth K (4 for fast, 16+ for best)
    win_words: comparison window in u32 words (8 = 32 bytes for the fast
               level, 16 = 64 bytes for best — longer windows mean fewer
               cap-blind candidate choices)
    toofar3:   drop length-3 matches beyond this distance (zlib's
               TOO_FAR idea).  A far len-3 match costs ~16-20 bits
               (len code + long dist code + extras) vs ~14-16 bits for
               3 text literals, AND costs the wavefront decoder a
               scalar fill record — on the bench corpus tightening
               4096 -> 256 IMPROVES the fast level's ratio 0.6029 ->
               0.5942 while cutting match records.  Bitmap-like data
               (low literal entropy, row-stride distances) goes the
               other way: test.bmp L3 needs the full 4096 (2976 B vs
               3018 at 256), so the best level keeps zlib's value.
    """
    n = block.shape[0]
    nw = n // 4
    w = _aligned_words(block)                       # [n/4]
    # word shifts w[i+j] for the window payloads
    wsh = [w]
    for j in range(1, win_words + 2):
        wsh.append(_shift_fwd(w, j, jnp.uint32(0)))

    # phase-major window words: win[j] at byte position 4i+p is
    # (w[i+j] >> 8p) | (w[i+j+1] << (32-8p)); concatenation of the four
    # phase arrays — never interleaved (that relayout is pathological)
    wins = []
    for j in range(win_words):
        phases = []
        for p in range(4):
            if p == 0:
                phases.append(wsh[j])
            else:
                phases.append((wsh[j] >> (8 * p))
                              | (wsh[j + 1] << (32 - 8 * p)))
        wins.append(jnp.concatenate(phases))        # [n] phase-major

    iw = jnp.arange(nw, dtype=jnp.int32)
    pos_pm = jnp.concatenate([4 * iw + p for p in range(4)])
    valid = pos_pm < blen - (MIN_MATCH - 1)
    K = num_cands

    def tier_pass(h):
        """One hash-chain pass: co-sort by (h, pos), compare K lagged
        windows, restore position order.  Returns (length, dist) [n]."""
        key = jnp.where(valid, (h << 15) | pos_pm, (1 << 30) + pos_pm)
        # the barrier stops XLA fusing the window construction into the
        # sort comparator (re-computing operands per compare); keys embed
        # pos -> unique -> is_stable=False (a stable sort carries a
        # hidden iota operand and tie-break compares).  Both ONLY for the
        # fast level's shallow config: with 33 operands (win_words=32,
        # best level) the unstable lowering compiled for tens of minutes
        # on the machine this was first written for.
        if win_words <= 8:
            sorted_ops = jax.lax.sort(
                list(jax.lax.optimization_barrier([key] + wins)),
                dimension=0, num_keys=1, is_stable=False)
        else:
            sorted_ops = jax.lax.sort([key] + wins, dimension=0,
                                      num_keys=1)
        skey, swins = sorted_ops[0], sorted_ops[1:]
        spos = skey & 0x7FFF
        shash = skey >> 15
        svalid = (skey < (1 << 30)).astype(jnp.int32)
        slimit = jnp.minimum(MAX_MATCH, blen - spos)

        def lag_body(shift_k, carry):
            best_l, best_d = carry
            same = ((shash == shift_k(shash, -1)).astype(jnp.int32)
                    * svalid * shift_k(svalid, 0))
            dist = spos - shift_k(spos, 0)
            # match length: count equal whole words, CAPTURE the first
            # differing word, resolve its partial bytes once at the end
            # (one _xor_bytes_eq per (lag, word) costs ~6 extra
            # materialized passes each; capture+resolve is ~2)
            Lw = jnp.zeros((n,), jnp.int32)
            run = jnp.ones((n,), jnp.bool_)
            xw = jnp.zeros((n,), jnp.uint32)
            for j in range(win_words):
                x = swins[j] ^ shift_k(swins[j], jnp.uint32(0))
                eq = x == 0
                xw = jnp.where(run & ~eq, x, xw)
                run = run & eq
                Lw = Lw + run
            lsb = xw & (jnp.uint32(0) - xw)
            part = jnp.where(xw == 0, 0,
                   jnp.where(lsb & jnp.uint32(0xFF), 0,
                   jnp.where(lsb & jnp.uint32(0xFF00), 1,
                   jnp.where(lsb & jnp.uint32(0xFF0000), 2, 3))))
            L = 4 * Lw + part.astype(jnp.int32)
            L = jnp.minimum(L, slimit) * same
            L = jnp.where((L == MIN_MATCH) & (dist > toofar3), 0, L)
            better = L > best_l
            return (jnp.where(better, L, best_l),
                    jnp.where(better, dist, best_d))

        init = (jnp.zeros((n,), jnp.int32), jnp.zeros((n,), jnp.int32))
        if K <= 8:
            # small chain depth: unroll with static shifts
            best = init
            for k in range(1, K + 1):
                best = lag_body(
                    lambda a, fill, k=k: _shift_back(a, k, fill), best)
        else:
            # deep chains (best level): one rolled loop keeps the graph
            # small (K=48 x 32 words unrolled costs minutes of compile)
            def body(k, best):
                def shift_k(a, fill):
                    pad = jnp.concatenate(
                        [jnp.full((K,), fill, a.dtype), a])
                    return jax.lax.dynamic_slice(pad, (K - k,), (n,))
                return lag_body(shift_k, best)

            best = jax.lax.fori_loop(1, K + 1, body, init)
        best_l, best_d = best
        # restore position order: spos is a permutation of 0..n-1.
        # L(<=128, 8 bits) packs above dist(<=32768, 16 bits) so the
        # restore carries ONE payload operand.
        packed = (best_l << 16) | best_d
        if win_words <= 8:
            _, pk = jax.lax.sort(
                list(jax.lax.optimization_barrier([spos, packed])),
                dimension=0, num_keys=1, is_stable=False)
        else:
            _, pk = jax.lax.sort([spos, packed], dimension=0, num_keys=1)
        return pk >> 16, pk & 0xFFFF

    # tiered hash chains (zlib walks one 3-byte chain thousands of
    # candidates deep; with K sorted-adjacent candidates per chain we
    # instead hash LONGER grams so long matches are near neighbors in
    # their own chain — the fix for repetitive text, where a 3-byte
    # chain's K nearest candidates are all short matches)
    length, dist = tier_pass(_hash15(wins[0] & jnp.uint32(0x00FFFFFF)))
    for g in tiers:
        m = wins[0]
        for j in range(1, g):
            m = m ^ ((wins[j] << (5 * j)) | (wins[j] >> (32 - 5 * j)))
        tl, td = tier_pass(_hash15(m))
        better = (tl > length) | ((tl == length) & (td > 0)
                                  & ((dist == 0) | (td < dist)))
        length = jnp.where(better, tl, length)
        dist = jnp.where(better, td, dist)

    # ---- merge-extension: compose verified window-sized pieces --------
    # linked[i]: the match at i fills its window AND i+cap continues at the
    # same distance — then [i, i+2*cap) provably matches at that distance.
    cap = 4 * win_words
    limit = jnp.maximum(jnp.minimum(MAX_MATCH, blen -
                                    jnp.arange(n, dtype=jnp.int32)), 0)
    nxt_d = _shift_fwd(dist, cap, 0)
    nxt_l = _shift_fwd(length, cap, 0)
    linked = ((length == cap) & (dist > 0) & (nxt_d == dist)
              & (nxt_l > 0)).astype(jnp.int32)
    # chain length via 3 doubling rounds (8 hops cover 258)
    c = linked
    alll = linked
    for r in range(3):
        s = cap * (1 << r)
        c = c + alll * _shift_fwd(c, s, 0)
        alll = alll * _shift_fwd(alll, s, 0)
    c = jnp.minimum(c, 8)
    # tail length at node i + 32*c  (c <= 8: 9-way select of shifted arrays)
    tail = jnp.zeros((n,), jnp.int32)
    for hops in range(9):
        sel = c == hops
        tl = length if hops == 0 else _shift_fwd(length, cap * hops, 0)
        td = dist if hops == 0 else _shift_fwd(dist, cap * hops, 0)
        tl = jnp.where((hops == 0) | (td == dist), tl, 0)
        tail = jnp.where(sel, tl, tail)
    merged = jnp.where(length == cap, cap * c + tail, length)
    length = jnp.minimum(jnp.maximum(length, merged), limit)

    # (A separate small-lag run-extension pass — _small_lag_runs — was
    # measured redundant: merge-extension already chains run/periodic
    # matches to 258, and the pass cost ~25 ms per 64-block batch for a
    # <=2-byte ratio difference on run-heavy corpora.)

    usable = length >= MIN_MATCH
    return (jnp.where(usable, length, 0), jnp.where(usable, dist, 0))


def lazy_filter(length: jax.Array, dist: jax.Array):
    """One-step lazy matching: defer to i+1 when it has a strictly longer
    match (zlib-style; done *correctly*, unlike reference B1/Q4)."""
    nxt = jnp.concatenate([length[1:], jnp.zeros((1,), length.dtype)])
    keep = length >= nxt
    return jnp.where(keep, length, 0), jnp.where(keep, dist, 0)


def greedy_parse(length: jax.Array, blen: jax.Array, lazy: bool = True,
                 tile: int = TILE):
    """Greedy tokenization, tile-local (TILE bytes) via one lax.scan.

    Sequential only in the tile-step dimension; vectorized across tiles
    (and blocks under vmap).  Matches truncate at tile boundaries so each
    tile parses independently — worth ~1-2% ratio vs an unbounded greedy
    chain, and removes every gather/scatter from the parse.

    With `lazy`, deferral happens *inside* the parse: at a token start,
    take a literal instead when the next position's match is strictly
    longer (reference quirk Q4 semantics, but correct — evaluating the
    rule only at token starts avoids the cascade of pre-zeroing matches
    globally, which measurably hurts ratio with window-capped lengths).

    (A two-position lookahead — "lazy2" — was measured and removed: on
    zipf-vocabulary text it recovers <0.5% while costing 3% on
    test.bmp/tiny.bmp.  The apparent "repetitive text gap" vs zlib-9 is
    the quirk-Q5 independent-block tax, not parse quality: zlib-9
    restricted to the same independent 32 KiB blocks is within 0.4% of
    this parse, tests/test_ratio_gates.py.)

    Returns (mark bool [n] — token starts; len_adj int32 [n] — the match
    length actually used at marked positions, 0 for literals).
    """
    n = length.shape[0]
    nt = n // tile
    nxt = jnp.concatenate([length[1:], jnp.zeros((1,), length.dtype)])
    Lt = length.reshape(nt, tile).T                 # [tile, nt] scan steps
    Nx = nxt.reshape(nt, tile).T
    base = jnp.arange(nt, dtype=jnp.int32) * tile

    def step(p, xs):
        t, lt, nx = xs
        pos = base + t
        emit = (p == pos) & (pos < blen)
        ml = jnp.minimum(lt, tile - t)
        ml = jnp.minimum(ml, blen - pos)
        use = emit & (ml >= MIN_MATCH)
        if lazy:
            nx_t = jnp.minimum(jnp.minimum(nx, tile - t - 1), blen - pos - 1)
            use = use & ~(nx_t > ml)
        adv = jnp.where(emit, jnp.where(use, ml, 1), 0)
        return p + adv, (emit, jnp.where(use, ml, 0))

    ts = jnp.arange(tile, dtype=jnp.int32)
    # each sequential lax.scan step has a fixed cost regardless of body
    # size; unrolling folds 8 steps into one loop iteration
    _, (mark_t, len_t) = jax.lax.scan(step, base, (ts, Lt, Nx),
                                      unroll=8)
    mark = mark_t.T.reshape(n)                      # [TILE,nt] -> [n]
    len_adj = len_t.T.reshape(n)
    return mark, len_adj
