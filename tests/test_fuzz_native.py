"""Native (C++) runtime fuzz — split from test_fuzz.py so its xdist
worker runs (almost) no JAX compiles: the long-session jaxlib abort
(CLAUDE.md "Build / test / bench") cannot take the native coverage down
with it, and the pure-C tests finish in seconds."""
import zlib

import numpy as np
import pytest

import deflate_jax
from deflate_jax import native as N

from test_fuzz import KINDS, _gen


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_native_path_fuzz(kind, seed):
    if N.lib() is None:
        pytest.skip("no native lib")
    rng = np.random.default_rng(seed * 100 + KINDS.index(kind))
    size = int(rng.integers(1, 400000))
    data = _gen(rng, kind, size)
    for level in (0, 1, 2, 3):
        enc = N.deflate(data, level)
        assert zlib.decompress(enc, -15) == data, (kind, seed, level)
        assert N.inflate(enc, max(1024, len(data))) == data
    # cross: native stream through the device decoder path (CPU
    # backend).  Seed 3 only — every distinct input size compiles a
    # fresh skeleton/wave program shape on the cache-less test backend
    # (~100 s each); one seed exercises the cross-path per corpus kind,
    # the rest stay pure C.
    if seed == 3:
        enc = N.deflate(data, 2)
        assert deflate_jax.decompress(enc, device=True,
                                      force_device=True) == data


def test_native_garbage_fuzz_seeds():
    """Random garbage fed to the native inflate must error cleanly —
    DT_OK on garbage would mean the truncation/validity checks leak."""
    if N.lib() is None:
        pytest.skip("no native lib")
    for seed in (7, 8):
        rng = np.random.default_rng(seed)
        ok = 0
        for _ in range(500):
            n = int(rng.integers(1, 2048))
            garbage = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            try:
                out = N.inflate(garbage, 1 << 16)
                ok += 1            # rare: garbage can be a valid stream
                # if it "decoded", zlib must agree it is a valid prefix
                d = zlib.decompressobj(-15)
                ref = d.decompress(garbage)
                assert out == ref
            except ValueError:
                pass
        assert ok < 50             # overwhelming majority must error


def test_native_truncated_is_error_not_zero_fill():
    """Regression: truncated fixed-Huffman streams used to return DT_OK
    with zero-filled garbage; they must error."""
    if N.lib() is None:
        pytest.skip("no native lib")
    data = b"abcdefgh" * 300
    enc = N.deflate(data, 2)
    for cut in range(1, min(len(enc), 40)):
        with pytest.raises(ValueError):
            N.inflate(enc[:-cut], len(data) * 2)


def test_native_empty_input_no_trailing_garbage():
    """Regression: empty input used to emit two BFINAL blocks."""
    if N.lib() is None:
        pytest.skip("no native lib")
    for level in (0, 1, 2, 3):
        enc = N.deflate(b"", level)
        d = zlib.decompressobj(-15)
        assert d.decompress(enc) == b""
        d.flush()
        assert d.unused_data == b"", (level, enc.hex())
        assert N.inflate(enc, 64) == b""


def test_native_out_size_hard_cap():
    """Regression: an explicit out_size is a hard cap, not a growth hint."""
    if N.lib() is None:
        pytest.skip("no native lib")
    data = b"x" * 10000
    enc = N.deflate(data, 2)
    with pytest.raises(deflate_jax.InflateError):
        deflate_jax.decompress(enc, out_size=100)
    assert deflate_jax.decompress(enc, out_size=10000) == data
