import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deflate_jax.ops import huffman as H
from deflate_jax.utils import tables as T


def _rev(c, n):
    return int(bin(c)[2:].zfill(n)[::-1], 2) if n else 0


def test_fixed_litlen_canonical_codes():
    """RFC 1951 §3.2.6 fixed code table, bit-reversed for LSB-first emission."""
    codes, _ = H.canonical_codes(jnp.array(T.FIXED_LITLEN_LENGTHS))
    codes = np.asarray(codes)
    assert codes[0] == _rev(0x30, 8)
    assert codes[143] == _rev(0xBF, 8)
    assert codes[144] == _rev(0x190, 9)
    assert codes[255] == _rev(0x1FF, 9)
    assert codes[256] == _rev(0, 7)
    assert codes[279] == _rev(0x17, 7)
    assert codes[280] == _rev(0xC0, 8)
    assert codes[287] == _rev(0xC7, 8)


def test_fixed_dist_codes():
    codes, _ = H.canonical_codes(jnp.array(T.FIXED_DIST_LENGTHS))
    codes = np.asarray(codes)
    for i in range(32):
        assert codes[i] == _rev(i, 5)


def test_decode_inverts_encode_fixed():
    for lens in (T.FIXED_LITLEN_LENGTHS, T.FIXED_DIST_LENGTHS):
        lens_j = jnp.array(lens)
        codes, _ = H.canonical_codes(lens_j)
        tbl = H.decode_tables(lens_j)
        sym, ln = H.decode_one(codes.astype(jnp.uint32), tbl)
        assert (np.asarray(sym) == np.arange(len(lens))).all()
        assert (np.asarray(ln) == lens).all()


@pytest.mark.parametrize("seed", range(4))
def test_code_lengths_kraft_exact(seed):
    rng = np.random.default_rng(seed)
    freq = rng.integers(0, 1000, 288).astype(np.int32)
    freq[rng.random(288) < rng.random()] = 0
    freq[256] = 1
    L = np.asarray(H.huffman_code_lengths(jnp.array(freq), 15))
    used = freq > 0
    assert (L[~used] == 0).all()
    assert (L[used] > 0).all() and (L[used] <= 15).all()
    assert abs(np.sum(2.0 ** -L[used]) - 1.0) < 1e-12


def test_code_lengths_respects_limit():
    # exponential frequencies force deep trees -> exercises the overflow fixup
    freq = np.array([2 ** min(i, 25) for i in range(30)], dtype=np.int32)
    L = np.asarray(H.huffman_code_lengths(jnp.array(freq), 7))
    assert (L > 0).all() and (L <= 7).all()
    assert abs(np.sum(2.0 ** -L) - 1.0) < 1e-12


def test_code_lengths_near_optimal():
    # entropy bound: expected code length within ~2% + 1 bit of entropy
    rng = np.random.default_rng(7)
    freq = (rng.zipf(1.3, 5000).clip(0, 287)).astype(np.int32)
    hist = np.bincount(freq, minlength=288).astype(np.int32)
    L = np.asarray(H.huffman_code_lengths(jnp.array(hist), 15))
    p = hist[hist > 0] / hist.sum()
    entropy = -(p * np.log2(p)).sum()
    avg = (hist * L).sum() / hist.sum()
    assert avg <= entropy + 1.0


def test_degenerate_trees():
    # zero symbols
    L = np.asarray(H.huffman_code_lengths(jnp.zeros(30, jnp.int32), 15))
    assert (L == 0).all()
    # one symbol -> single 1-bit code (reference throws instead, SURVEY.md B2)
    f = np.zeros(30, np.int32)
    f[17] = 5
    L = np.asarray(H.huffman_code_lengths(jnp.array(f), 15))
    assert L[17] == 1 and L.sum() == 1
    # two symbols
    f[3] = 1
    L = np.asarray(H.huffman_code_lengths(jnp.array(f), 15))
    assert L[17] == 1 and L[3] == 1 and L.sum() == 2


def test_vmapped_tree_build():
    rng = np.random.default_rng(11)
    freqs = rng.integers(0, 50, (8, 288)).astype(np.int32)
    freqs[:, 256] = 1
    batched = jax.vmap(lambda f: H.huffman_code_lengths(f, 15))(jnp.array(freqs))
    single = [np.asarray(H.huffman_code_lengths(jnp.array(f), 15)) for f in freqs]
    assert (np.asarray(batched) == np.stack(single)).all()
