"""gzip container + batched multi-stream API."""
import gzip as _gzip
import zlib

import numpy as np
import pytest

import deflate_jax


CASES = {
    "text": b"the gzip container test " * 400,
    "random": bytes(np.random.default_rng(0).integers(0, 256, 50000,
                                                      dtype=np.uint8)),
    "empty": b"",
}


@pytest.mark.parametrize("name", CASES)
def test_gzip_roundtrip_and_stdlib_interop(name):
    data = CASES[name]
    g = deflate_jax.compress_gzip(data, 2)
    assert _gzip.decompress(g) == data            # stdlib reads ours
    assert deflate_jax.decompress_gzip(g) == data
    theirs = _gzip.compress(data, 6)
    assert deflate_jax.decompress_gzip(theirs) == data  # we read stdlib's


def test_gzip_crc_detected():
    g = bytearray(deflate_jax.compress_gzip(b"hello world" * 100, 2))
    g[-6] ^= 0xFF                                 # corrupt CRC
    with pytest.raises(deflate_jax.InflateError):
        deflate_jax.decompress_gzip(bytes(g))


def test_gzip_multi_member():
    """RFC 1952 §2.2: concatenated members decode as concatenated output
    (`gzip -c a b > ab.gz`; the stdlib handles this and so must we)."""
    a, b, c = b"first member " * 200, b"", b"third member! " * 150
    cat = (deflate_jax.compress_gzip(a, 2) + deflate_jax.compress_gzip(b, 1)
           + _gzip.compress(c, 6))
    assert deflate_jax.decompress_gzip(cat) == a + b + c
    assert _gzip.decompress(cat) == a + b + c     # stdlib agrees on the file


def test_gzip_optional_header_fields():
    import zlib as _z

    data = b"payload with fancy header " * 64
    raw = deflate_jax.compress(data, 2)
    # FLG: FTEXT|FHCRC|FEXTRA|FNAME|FCOMMENT = 0x1F
    hdr = bytearray([0x1F, 0x8B, 8, 0x1F, 0, 0, 0, 0, 0, 255])
    hdr += (4).to_bytes(2, "little") + b"XTRA"    # FEXTRA
    hdr += b"name.txt\x00"                        # FNAME
    hdr += b"a comment\x00"                       # FCOMMENT
    hdr += (_z.crc32(bytes(hdr)) & 0xFFFF).to_bytes(2, "little")  # FHCRC
    g = (bytes(hdr) + raw + (_z.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
         + (len(data) & 0xFFFFFFFF).to_bytes(4, "little"))
    assert _gzip.decompress(g) == data
    assert deflate_jax.decompress_gzip(g) == data
    # corrupt the header CRC16 -> must be detected
    bad = bytearray(g)
    bad[len(hdr) - 2] ^= 0xFF
    with pytest.raises(deflate_jax.InflateError):
        deflate_jax.decompress_gzip(bytes(bad))


def test_gzip_malformed_header_is_inflate_error():
    """Regression: malformed FNAME (no NUL) used to raise bare ValueError."""
    data = b"x" * 100
    raw = deflate_jax.compress(data, 2)
    g = bytearray([0x1F, 0x8B, 8, 0x08, 0, 0, 0, 0, 0, 255])  # FNAME set
    g += b"unterminated-name-no-nul" + raw       # NUL never appears... or
    # may appear inside the payload; either way the parse must not crash
    with pytest.raises(deflate_jax.InflateError):
        deflate_jax.decompress_gzip(bytes(g))


def test_compress_many_matches_singles():
    rng = np.random.default_rng(3)
    bufs = [
        b"stream zero " * 300,
        bytes(rng.integers(0, 256, 70000, dtype=np.uint8)),    # 3 blocks
        b"x",
        bytes(rng.integers(97, 123, 40000, dtype=np.uint8)),   # 2 blocks
    ]
    outs = deflate_jax.compress_many(bufs, 2)
    assert len(outs) == len(bufs)
    for buf, enc in zip(bufs, outs):
        assert zlib.decompress(enc, -15) == buf
    # batched output must equal the single-stream encoder's
    for buf, enc in zip(bufs, outs):
        assert enc == deflate_jax.compress(buf, 2)
    assert deflate_jax.decompress_many(outs) == bufs
