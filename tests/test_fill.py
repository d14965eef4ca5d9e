"""Stage G, the match fill (ops/fill.py): the per-block fill and the
ordered history fill against byte-sequential host oracles, on the CPU and
(marked gpu) on the card."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deflate_jax.ops import fill as F
from deflate_jax.ops import wave as W


def _host_fill(lit, rec0, rec1, nmatch):
    """Byte-sequential oracle: each block's records in order."""
    B = lit.shape[0]
    out = lit.view(np.uint8).reshape(B, -1).copy()
    for b in range(B):
        for m in range(int(nmatch[b])):
            r0, d = int(rec0[b, m]), int(rec1[b, m])
            o, ln = r0 & 0xFFFF, ((r0 >> 16) & 0xFFFF) + 3
            for j in range(ln):
                out[b, o + j] = out[b, o - d + j]
    return out


def _records(blocks):
    """blocks: list of [(opos, len, dist), ...] -> (rec0, rec1, nmatch)."""
    B = len(blocks)
    rec0 = np.full((B, W.NM), -1, np.int32)
    rec1 = np.zeros((B, W.NM), np.int32)
    nmatch = np.zeros(B, np.int32)
    for b, recs in enumerate(blocks):
        for m, (o, ln, d) in enumerate(recs):
            rec0[b, m] = o | ((ln - 3) << 16)
            rec1[b, m] = d
        nmatch[b] = len(recs)
    return rec0, rec1, nmatch


def _lit(B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (B, F.OW)).astype(np.int32)


def _check(lit, rec0, rec1, nmatch):
    got = np.asarray(jax.jit(F.fill_matches)(
        jnp.asarray(lit), jnp.asarray(rec0), jnp.asarray(rec1),
        jnp.asarray(nmatch)))
    want = _host_fill(lit, rec0, rec1, nmatch)
    np.testing.assert_array_equal(got.view(np.uint8).reshape(want.shape),
                                  want)


DISTS = [1, 2, 3, 4, 5, 6, 7, 8, 16, 31, 32, 33, 258, 1000]


@pytest.mark.parametrize("dist", DISTS)
def test_fill_matches_oracle(dist):
    """Back-to-back records at one distance, every length class and byte
    phase, including copies of bytes an earlier record wrote."""
    recs, o = [], max(dist, 5)
    for ln in (3, 4, 5, 8, 9, 31, 32, 33, 100, 258):
        for phase in range(4):
            recs.append((o + phase, ln, dist))
            o += phase + ln
    _check(_lit(1, dist), *_records([recs]))


def test_fill_merged_run_records():
    """Run records longer than 258 (merge_match_runs output), overlapping
    and not, up to a whole-block run at distance 1."""
    blocks = [[(509, 20000, 509)], [(1, 32767, 1)],
              [(3, 700, 3), (900, 5000, 897)]]
    _check(_lit(3, 1), *_records(blocks))


def test_fill_zero_records():
    lit = _lit(2, 2)
    rec0, rec1, nmatch = _records([[], []])
    _check(lit, rec0, rec1, nmatch)


def test_fill_record_ending_at_last_byte():
    _check(_lit(1, 3), *_records([[(32768 - 258, 258, 4000),
                                       (100, 10, 1)][::-1]]))


def test_fill_ignores_slots_past_nmatch():
    lit = _lit(1, 4)
    rec0, rec1, nmatch = _records([[(100, 50, 10), (200, 50, 20)]])
    nmatch[0] = 1                       # second record is stale
    _check(lit, rec0, rec1, nmatch)


def _host_fill_hist(lit, rec0, rec1, nmatch, sizes):
    """Oracle for the ordered fill: one output stream, records resolve
    against everything decoded before them."""
    lb = lit.view(np.uint8).reshape(len(sizes), -1)
    out = bytearray()
    for b, sz in enumerate(sizes):
        base = len(out)
        out += lb[b, :sz].tobytes()
        for m in range(int(nmatch[b])):
            r0, d = int(rec0[b, m]), int(rec1[b, m])
            o, ln = base + (r0 & 0xFFFF), ((r0 >> 16) & 0xFFFF) + 3
            for j in range(ln):
                out[o + j] = out[o - d + j]
    return bytes(out)


def _check_hist(lit, rec0, rec1, nmatch, sizes):
    sizes = np.asarray(sizes, np.int32)
    got = np.asarray(jax.jit(F.fill_matches_hist)(
        jnp.asarray(lit), jnp.asarray(rec0), jnp.asarray(rec1),
        jnp.asarray(nmatch), jnp.asarray(sizes)))
    want = _host_fill_hist(lit, rec0, rec1, nmatch, sizes)
    assert got.view(np.uint8)[:len(want)].tobytes() == want


def test_hist_fill_across_blocks_at_32768():
    """Matches at the RFC's farthest distance land in the previous
    virtual block; a chained copy crosses two block boundaries."""
    blocks = [[], [(0, 258, 32768), (300, 40, 32768)],
              [(5, 100, 32000), (200, 258, 1)]]
    _check_hist(_lit(3, 5), *_records(blocks), [32768, 32768, 30000])


def test_hist_fill_from_stored_and_short_blocks():
    """Short and empty virtual blocks (cut points, stored pieces): the
    dense layout shifts later blocks, and references reach back over
    them into a stored block's bytes."""
    blocks = [[], [], [(10, 50, 12)], [(0, 258, 1000), (300, 3, 1)]]
    _check_hist(_lit(4, 6), *_records(blocks), [1000, 0, 70, 600])


def _all_cases():
    blocks = []
    for dist in DISTS:
        recs, o = [], max(dist, 5)
        for ln in (3, 4, 5, 8, 9, 31, 32, 33, 100, 258):
            for phase in range(4):
                recs.append((o + phase, ln, dist))
                o += phase + ln
        blocks.append(recs)
    return blocks + [[], [(509, 20000, 509)], [(1, 32767, 1)]]


@pytest.mark.gpu
def test_fills_on_the_card(gpu):
    """Both fills as the card's XLA compiles them, against the oracles."""
    blocks = _all_cases()
    lit = _lit(len(blocks), 7)
    _check(lit, *_records(blocks))
    sizes = [32768] * len(blocks)
    _check_hist(lit, *_records(blocks), sizes)
