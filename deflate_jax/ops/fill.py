"""Stage G of the wavefront decoder: LZ77 match fill.

After ops/wave.py places each block's literal bytes and compacts its match
records (rec0 = opos | (len - 3) << 16, rec1 = dist; len - 3 is 16 bits
because merge_match_runs fuses same-distance chains), every match byte is
a copy of an earlier output byte, possibly one that an earlier match
wrote (reference analog: the back-reference copy loop, inflate.hpp:284-305).

fill_matches is pointer doubling in plain XLA.  Every output byte starts
pointing at itself (literal) or at pos - dist (inside a match); src =
src[src] until nothing changes.  Every pointer then names a literal, and
out = lit[src]: at most ceil(log2(32768)) = 15 rounds of full-width
gathers, with no sequential loop over records.  (A CUDA kernel that kept
each block in shared memory and copied records in order with one warp was
measured against it on an H100 and lost end to end; PERF.md has the
numbers.)

fill_matches_hist is the ordered fill for foreign streams cut into
virtual blocks, whose matches reach back across block boundaries: the
same pointer doubling over the whole stream's output positions.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from deflate_jax.ops.wave import ND

I32 = jnp.int32
OW = ND // 4                 # output words per block


def _srl(x, n):
    return jax.lax.shift_right_logical(x, n)


def _records(rec0, rec1, nmatch):
    """(opos, mlen, dist) of each record; mlen is 0 for holes and for
    slots at or past nmatch."""
    slot = jnp.arange(rec0.shape[-1], dtype=I32)
    live = (rec0 >= 0) & (slot < nmatch[..., None])
    mlen = jnp.where(live, (_srl(rec0, 16) & 0xFFFF) + 3, 0)
    return rec0 & 0xFFFF, mlen, rec1


def _sources(n: int, opos, mlen, dist):
    """Per-position copy source over n output positions.

    opos/mlen/dist: 1-D records in position order (mlen 0 = no record).
    Returns src with src[g] = g for literals and g - dist inside a match,
    clamped to [0, g] so that malformed records cannot point forward or
    out of range (the decoder flags such blocks; the fill only has to
    stay in bounds and terminate)."""
    idx = jnp.where(mlen > 0, opos, n)
    start = jnp.full((n,), -1, I32).at[idx].set(opos, mode="drop")
    end = jnp.zeros((n,), I32).at[idx].set(opos + mlen, mode="drop")
    dd = jnp.zeros((n,), I32).at[idx].set(dist, mode="drop")
    s = jax.lax.cummax(start)
    e = jax.lax.cummax(end)
    g = jnp.arange(n, dtype=I32)
    d = dd[jnp.maximum(s, 0)]
    return jnp.where((s >= 0) & (g < e), jnp.clip(g - d, 0, g), g)


def _resolve(src):
    """Pointer doubling along the last axis until every pointer is a
    fixed point (a literal).  Pointers never increase, so at most
    ceil(log2(n)) rounds change anything."""
    rounds = src.shape[-1].bit_length()

    def body(c):
        s, _, k = c
        s2 = jnp.take_along_axis(s, s, axis=-1)
        return s2, jnp.any(s2 != s), k + 1

    s, _, _ = jax.lax.while_loop(lambda c: c[1] & (c[2] < rounds), body,
                                 (src, jnp.bool_(True), jnp.int32(0)))
    return s


def _to_bytes(words):
    """int32 [..., W] little-endian words -> int32 byte values [..., 4W]."""
    b = jnp.stack([_srl(words, 8 * k) & 255 for k in range(4)], axis=-1)
    return b.reshape(words.shape[:-1] + (4 * words.shape[-1],))


def _to_words(byts):
    b = byts.reshape(byts.shape[:-1] + (-1, 4))
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
            | (b[..., 3] << 24))


def fill_matches(litwords, rec0, rec1, nmatch):
    """Own-stream fill (pointer doubling per block).

    litwords [B, OW] int32 (literal bytes placed, match bytes zero);
    rec0, rec1 [B, NM] match records; nmatch [B].  Returns [B, OW]."""
    opos, mlen, dist = _records(rec0, rec1, nmatch)
    src = jax.vmap(functools.partial(_sources, ND))(opos, mlen, dist)
    src = _resolve(src)
    return _to_words(jnp.take_along_axis(_to_bytes(litwords), src, axis=1))


def fill_matches_hist(litwords, rec0, rec1, nmatch, sizes):
    """Ordered fill with cross-block history (foreign-stream plans).

    litwords [n, OW], rec0/rec1 [n, NM], nmatch [n]: n virtual blocks in
    stream order, each holding sizes[b] output bytes; match distances may
    reach into earlier virtual blocks.  The blocks' bytes are first packed
    densely in stream order, so a back-reference is pos - dist in one
    global address space, then filled by the same pointer doubling.
    Returns int32 [n * OW] words holding the stream's output bytes densely
    (valid up to sum(sizes))."""
    n = litwords.shape[0]
    L = n * ND
    sizes = sizes.astype(I32)
    start = jnp.cumsum(sizes) - sizes
    # block owning each dense position: seed each block's start, fill
    # forward (empty blocks share a start with the next; max keeps it)
    seed = jnp.full((L,), -1, I32).at[start].max(
        jnp.arange(n, dtype=I32), mode="drop")
    blk = jnp.maximum(jax.lax.cummax(seed), 0)
    j = jnp.clip(jnp.arange(L, dtype=I32) - start[blk], 0, ND - 1)
    lit = _to_bytes(litwords).reshape(-1)[blk * ND + j]

    opos, mlen, dist = _records(rec0, rec1, nmatch)
    gpos = (start[:, None] + opos).reshape(-1)
    src = _sources(L, jnp.minimum(gpos, L), mlen.reshape(-1),
                   dist.reshape(-1))
    return _to_words(lit[_resolve(src)])
