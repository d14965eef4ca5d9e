"""File and streaming-file APIs (split from test_runtime.py so the
xdist per-file workers stay under the quick-tier wall-time budget)."""
import numpy as np
import pytest

import deflate_jax


def test_compress_file_streaming(tmp_path):
    import zlib

    rng = np.random.default_rng(17)
    pat = rng.integers(0, 230, 1013, dtype=np.uint8)
    data = np.tile(pat, 150)[: 4 * 32768 + 7777].tobytes()
    src = tmp_path / "in.bin"
    dst = tmp_path / "out.deflate"
    src.write_bytes(data)
    # small chunks force multiple segments and bit-tail carries
    deflate_jax.compress_file(str(src), str(dst), level=2, chunk_blocks=2)
    enc = dst.read_bytes()
    assert zlib.decompress(enc, -15) == data
    # streaming output must equal the one-shot encoder's
    assert enc == deflate_jax.compress(data, 2)


def test_decompress_file_roundtrip(tmp_path):
    data = b"file roundtrip " * 9000
    src = tmp_path / "a.bin"
    mid = tmp_path / "a.deflate"
    out = tmp_path / "a.out"
    src.write_bytes(data)
    deflate_jax.compress_file(str(src), str(mid), level=3)
    deflate_jax.decompress_file(str(mid), str(out))
    assert out.read_bytes() == data


class TestStreamingDecompressFile:
    """decompress_file streams in bounded memory (reference B5 analog: a
    block spanning a read boundary must work)."""

    def test_block_spans_read_boundary(self, tmp_path):
        import zlib

        import deflate_jax as D
        rng = __import__("numpy").random.default_rng(11)
        data = (b"boundary " * 20000
                + rng.integers(0, 256, 100000, dtype=__import__("numpy")
                               .uint8).tobytes()) * 3
        src = tmp_path / "in.z"
        dst = tmp_path / "out.bin"
        src.write_bytes(zlib.compress(data, 6)[2:-4])   # foreign stream
        # tiny window forces many refills and boundary-spanning blocks
        D.decompress_file(str(src), str(dst), chunk_bytes=4096)
        assert dst.read_bytes() == data

    def test_own_stream_and_cross_block_history(self, tmp_path):
        import deflate_jax as D
        # foreign stream with matches crossing 32 KiB block boundaries
        import zlib
        data = bytes(range(256)) * 600                  # 153600 B periodic
        src = tmp_path / "in.z"
        dst = tmp_path / "out.bin"
        src.write_bytes(zlib.compress(data, 9)[2:-4])
        D.decompress_file(str(src), str(dst), chunk_bytes=8192)
        assert dst.read_bytes() == data

    def test_truncated_raises(self, tmp_path):
        import zlib

        import deflate_jax as D
        import pytest as _p
        data = b"will be cut" * 5000
        st = zlib.compress(data, 6)[2:-4]
        src = tmp_path / "in.z"
        src.write_bytes(st[: len(st) // 2])
        with _p.raises(D.InflateError):
            D.decompress_file(str(src), str(tmp_path / "o"), chunk_bytes=2048)


