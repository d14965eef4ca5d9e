"""Device (parallel) INFLATE vs python-zlib oracle.

Mirrors the reference's differential strategy (SURVEY.md §4) with hard
assertions: foreign streams (zlib at several levels), our own encoder's
streams, the reference corpus, and corruption probes.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

import deflate_jax
from deflate_jax.models import decoder as D
from deflate_jax.ops import bitpack as BP

SPAN = (1 << 18) + 64


def _decode(raw, span=SPAN, out_cap=1 << 18, max_blocks=8):
    words, nbits = BP.bytes_to_words(raw)
    out, total, nb, err = D.decode_stream(
        jnp.asarray(words), np.int32(nbits), span, out_cap, max_blocks)
    return bytes(np.asarray(out[:int(total)])), bool(err)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_foreign_zlib_streams(level):
    rng = np.random.default_rng(level)
    data = bytes(rng.integers(97, 117, 30000, dtype=np.uint8))
    out, err = _decode(zlib.compress(data, level)[2:-4])
    assert not err and out == data


def test_stored_blocks():
    data = b"\x00\x01\x02" * 5000
    out, err = _decode(zlib.compress(data, 0)[2:-4])
    assert not err and out == data


def test_cross_block_backrefs():
    data = b"the quick brown fox jumps over the lazy dog. " * 3000
    assert D.inflate_device(zlib.compress(data, 6)[2:-4]) == data


def test_own_encoder_streams():
    rng = np.random.default_rng(3)
    pat = rng.integers(0, 200, 401, dtype=np.uint8)
    data = np.tile(pat, 300).tobytes()
    enc = deflate_jax.compress(data, 2)
    assert D.inflate_device(enc) == data


def test_long_run_chains():
    data = b"a" * 100000
    assert D.inflate_device(zlib.compress(data, 6)[2:-4]) == data


def test_incompressible():
    data = bytes(np.random.default_rng(4).integers(0, 256, 80000,
                                                   dtype=np.uint8))
    assert D.inflate_device(zlib.compress(data, 9)[2:-4]) == data


def test_empty_stream():
    assert D.inflate_device(zlib.compress(b"", 6)[2:-4]) == b""


def test_corruption_detected():
    rng = np.random.default_rng(5)
    data = bytes(rng.integers(97, 110, 20000, dtype=np.uint8))
    raw = bytearray(zlib.compress(data, 9)[2:-4])
    raw[5] ^= 0xFF
    out, err = _decode(bytes(raw))
    assert err or out != data


@pytest.mark.slow
def test_reference_corpus_zlib_containers():
    import corpus

    for level in (1, 9):
        z = zlib.compress(corpus.picture_bitmap(), level)
        assert deflate_jax.decompress_zlib(
            z, device=True, force_device=True) == zlib.decompress(z)


def test_public_api_device_flag():
    data = b"device flag round trip " * 999
    enc = deflate_jax.compress(data, 2)
    # hint-less device=True now redirects to host by default (r5);
    # the device path itself stays covered via force_device
    st = {}
    assert deflate_jax.decompress(enc, device=True, stats=st) == data
    assert st["redirected"] == "device_to_host_default"
    assert deflate_jax.decompress(enc, device=True,
                                  force_device=True) == data
