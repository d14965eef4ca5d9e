"""End-to-end differential tests: our encoder vs python zlib (independent
oracle) and our host decoder, per the reference's three-leg scheme
(test/libdeflate.cpp:100-173) but with hard assertions."""
import zlib

import numpy as np
import pytest

import corpus
import deflate_jax


def _corpus():
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "one": b"Z",
        "tiny_text": b"hello hello hello world",
        "text": (b"the quick brown fox jumps over the lazy dog. " * 800),
        "runs": b"a" * 70000,
        "random": bytes(rng.integers(0, 256, 40000).astype(np.uint8)),
        "binary_cycle": bytes(np.tile(np.arange(256, dtype=np.uint8), 150)),
    }


CORPUS = _corpus()


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("name", list(CORPUS))
def test_compress_decodes_with_zlib(name, level):
    data = CORPUS[name]
    enc = deflate_jax.compress(data, level)
    assert zlib.decompress(enc, wbits=-15) == data


@pytest.mark.parametrize("level", [0, 2, 3])
@pytest.mark.parametrize("name", ["text", "random", "runs"])
def test_self_roundtrip(name, level):
    data = CORPUS[name]
    enc = deflate_jax.compress(data, level)
    assert deflate_jax.decompress(enc, len(data)) == data


@pytest.mark.parametrize("zlevel", [1, 6, 9])
def test_decompress_zlib_streams(zlevel):
    for name in ("text", "random", "binary_cycle"):
        data = CORPUS[name]
        ref = zlib.compress(data, zlevel)[2:-4]     # raw deflate
        assert deflate_jax.decompress(ref, len(data)) == data


def test_zlib_container_roundtrip():
    data = CORPUS["text"]
    wrapped = deflate_jax.compress_zlib(data, 2)
    # their decoder accepts our container
    assert zlib.decompress(wrapped) == data
    # our decoder accepts their container (with checksum verification)
    assert deflate_jax.decompress_zlib(zlib.compress(data, 6)) == data
    # corrupted checksum is detected
    bad = wrapped[:-1] + bytes([wrapped[-1] ^ 1])
    with pytest.raises(deflate_jax.InflateError):
        deflate_jax.decompress_zlib(bad)


def test_multiblock_boundaries():
    # sizes around the 32 KiB block boundary (quirk Q1)
    rng = np.random.default_rng(5)
    base = bytes(rng.integers(0, 200, 70000).astype(np.uint8))
    for size in (32767, 32768, 32769, 65536, 65537):
        data = base[:size]
        enc = deflate_jax.compress(data, 2)
        assert zlib.decompress(enc, wbits=-15) == data


def test_reference_corpus_zlib_containers():
    """zlib containers (SURVEY.md §2.5) written by python zlib at several
    levels and window sizes, over the bitmap fixtures."""
    import zlib as Z
    for data in (corpus.picture_bitmap(), corpus.tiny_bitmap() * 50):
        for level, wbits in ((1, 15), (6, 15), (9, 9), (9, 15)):
            co = Z.compressobj(level, Z.DEFLATED, wbits)
            raw = co.compress(data) + co.flush()
            assert deflate_jax.decompress_zlib(raw) == Z.decompress(raw)


def test_incompressible_goes_stored():
    data = CORPUS["random"]
    enc = deflate_jax.compress(data, 3)
    # 2 blocks -> at most 5 bytes overhead each + container slack
    assert len(enc) <= len(data) + 12


def test_level_validation():
    with pytest.raises(ValueError):
        deflate_jax.compress(b"x", 4)
    with pytest.raises(ValueError):
        deflate_jax.compress(b"x", -1)
