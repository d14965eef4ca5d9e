"""Property/fuzz round trips: random structures, all levels, both codecs."""
import zlib

import numpy as np
import pytest

import deflate_jax
from deflate_jax import native as N


def _gen(rng, kind, size):
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "lowent":
        return rng.integers(0, 4, size, dtype=np.uint8).tobytes()
    if kind == "runs":
        out = []
        n = 0
        while n < size:
            r = int(rng.integers(1, 400))
            out.append(bytes([int(rng.integers(0, 256))]) * r)
            n += r
        return b"".join(out)[:size]
    if kind == "periodic":
        p = int(rng.integers(1, 300))
        pat = rng.integers(0, 256, p, dtype=np.uint8)
        return np.tile(pat, size // p + 1)[:size].tobytes()
    if kind == "mixed":
        parts = [_gen(rng, k, size // 4)
                 for k in ("random", "lowent", "runs", "periodic")]
        return b"".join(parts)[:size]
    raise AssertionError(kind)


KINDS = ["random", "lowent", "runs", "periodic", "mixed"]


@pytest.mark.parametrize(
    "kind", ["random", "runs", "mixed",
             pytest.param("lowent", marks=pytest.mark.slow),
             pytest.param("periodic", marks=pytest.mark.slow)])
@pytest.mark.parametrize(
    "seed", [1, pytest.param(2, marks=pytest.mark.slow)])
def test_device_path_fuzz(kind, seed):
    rng = np.random.default_rng(seed * 100 + KINDS.index(kind))
    size = int(rng.integers(1, 90000))
    data = _gen(rng, kind, size)
    for level in (1, 2):
        enc = deflate_jax.compress(data, level)
        assert zlib.decompress(enc, -15) == data, (kind, seed, level)
        assert deflate_jax.decompress(enc) == data


def test_truncated_streams_error_not_crash():
    """A truncated stream MUST surface as an error — never as silently
    wrong or short output (the reference zero-fills past EOF; we don't)."""
    data = b"truncation probe " * 500
    enc = deflate_jax.compress(data, 2)
    for cut in (1, len(enc) // 2, len(enc) - 1):
        with pytest.raises((deflate_jax.InflateError, ValueError)):
            deflate_jax.decompress(enc[:cut])


def test_truncated_streams_error_device_path():
    data = b"device truncation probe " * 400
    enc = deflate_jax.compress(data, 2)
    for cut in (len(enc) // 3, len(enc) - 2):
        with pytest.raises((deflate_jax.InflateError, ValueError)):
            from deflate_jax.models import decoder as D
            from deflate_jax.models import host_inflate as HI
            from deflate_jax.ops import bitpack as BP
            import jax.numpy as jnp
            # call the device decoder directly (no host fallback) so the
            # on-device truncation detection itself is what's under test
            words_np, nbits = BP.bytes_to_words(enc[:cut])
            out, total, _, err = D.decode_stream(
                jnp.asarray(words_np), np.int32(nbits),
                (1 << 18) + 64, 1 << 15, 8)
            if bool(err):
                raise deflate_jax.InflateError("device decoder flagged error")
            raise AssertionError("device decoder accepted truncated stream")

