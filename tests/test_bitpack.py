import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deflate_jax.ops import bitpack as BP


def _read_bits(words, off, n):
    got = 0
    for b in range(n):
        p = off + b
        got |= ((int(words[p >> 5]) >> (p & 31)) & 1) << b
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_bits_roundtrip(seed):
    rng = np.random.default_rng(seed)
    N = 1000
    vals = rng.integers(0, 1 << 15, N).astype(np.int32)
    lens = rng.integers(0, 16, N).astype(np.int32)
    words, total = BP.pack_bits(jnp.array(vals), jnp.array(lens), N)
    words, total = np.asarray(words), int(total)
    assert total == lens.sum()
    offs = np.cumsum(lens) - lens
    for i in range(N):
        if lens[i]:
            expect = vals[i] & ((1 << lens[i]) - 1)
            assert _read_bits(words, offs[i], int(lens[i])) == expect


def test_pack_bits_zero_length_entries():
    vals = jnp.array([5, 99, 3], jnp.int32)
    lens = jnp.array([3, 0, 2], jnp.int32)
    words, total = BP.pack_bits(vals, lens, 4)
    assert int(total) == 5
    assert int(np.asarray(words)[0]) == (5 | (3 << 3))


def test_peek_bits_matches_pack():
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 1 << 15, 500).astype(np.int32)
    lens = rng.integers(1, 16, 500).astype(np.int32)
    words, _ = BP.pack_bits(jnp.array(vals), jnp.array(lens), 500)
    offs = np.cumsum(lens) - lens
    pk = np.asarray(BP.peek_bits(words, jnp.array(offs), 16))
    for i in range(500):
        m = (1 << lens[i]) - 1
        assert (pk[i] & m) == (vals[i] & m)


def test_concat_bitstreams():
    rng = np.random.default_rng(3)
    bw, bb = [], []
    for _ in range(7):
        v = rng.integers(0, 1 << 15, 50).astype(np.int32)
        l = rng.integers(0, 16, 50).astype(np.int32)
        w, t = BP.pack_bits(jnp.array(v), jnp.array(l), 40)
        bw.append(np.asarray(w))
        bb.append(int(t))
    W, T = BP.concat_bitstreams(jnp.array(np.stack(bw)), jnp.array(bb, np.int32), 300)
    W = np.asarray(W)
    assert int(T) == sum(bb)
    expect, got = [], []
    for w, t in zip(bw, bb):
        expect += [_read_bits(w, p, 1) for p in range(t)]
    got = [_read_bits(W, p, 1) for p in range(int(T))]
    assert got == expect


def test_bytes_words_helpers():
    data = bytes(range(256)) * 3 + b"xy"
    words, nbits = BP.bytes_to_words(data)
    assert BP.words_to_bytes(words, nbits) == data
