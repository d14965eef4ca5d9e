"""Native (C++) host runtime vs zlib and the JAX path."""
import zlib

import numpy as np
import pytest

import corpus
import deflate_jax
from deflate_jax import native as N

pytestmark = pytest.mark.skipif(N.lib() is None,
                                reason="native toolchain unavailable")

CASES = {
    "text": bytes(np.random.default_rng(0).integers(97, 117, 90000,
                                                    dtype=np.uint8)),
    "repeat": b"hello world! " * 7000,
    "random": bytes(np.random.default_rng(1).integers(0, 256, 70000,
                                                      dtype=np.uint8)),
    "runs": b"a" * 120000,
    "empty": b"",
    "one": b"Q",
}


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("zlevel", [0, 1, 6, 9])
def test_inflate_foreign(name, zlevel):
    data = CASES[name]
    raw = zlib.compress(data, zlevel)[2:-4]
    assert N.inflate(raw, max(1024, len(data))) == data


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_deflate_roundtrip(name, level):
    data = CASES[name]
    enc = N.deflate(data, level)
    assert zlib.decompress(enc, -15) == data
    assert N.inflate(enc, max(1024, len(data))) == data


def test_beats_reference_sizes():
    """Native L3 on the bitmap fixtures, gated against zlib -9 (the
    reference's own L3 came within 7.4% of zlib -9 on its test image)."""
    tb = corpus.picture_bitmap()
    z9 = len(zlib.compress(tb, 9)) - 6
    assert len(N.deflate(tb, 3)) <= 1.045 * z9
    tiny = corpus.tiny_bitmap()
    assert len(N.deflate(tiny, 3)) <= len(zlib.compress(tiny, 9)) - 6 + 2


def test_adler32_matches_zlib():
    for data in CASES.values():
        assert N.adler32(data) == zlib.adler32(data)


def test_corrupt_stream_raises():
    raw = bytearray(zlib.compress(CASES["text"], 9)[2:-4])
    raw[10] ^= 0x55
    with pytest.raises(ValueError):
        out = N.inflate(bytes(raw), len(CASES["text"]) * 2)
        assert out != CASES["text"]


def test_public_api_backends():
    data = b"backend test " * 500
    for backend in ("native", "auto"):
        enc = deflate_jax.compress(data, 2, backend=backend)
        assert zlib.decompress(enc, -15) == data
    assert deflate_jax.decompress(zlib.compress(data, 9)[2:-4]) == data


class TestSanitizers:
    """SURVEY.md §5.2: real ASan/UBSan coverage for the C++ runtime that
    parses untrusted input (the reference's ASan wiring is commented out,
    CMakeLists.txt:11-20, and never ran)."""

    def test_asan_ubsan_fuzz_binary(self):
        """Build the sanitizer-instrumented fuzz driver and run it: 1500
        random-garbage inputs + 120 round-trips with truncation and
        corruption sweeps.  Any ASan/UBSan finding aborts -> nonzero."""
        import os
        import subprocess

        d = os.path.join(os.path.dirname(__file__), "..",
                         "deflate_jax", "native")
        r = subprocess.run(["make", "-s", "-C", d, "asan_fuzz"],
                           capture_output=True, timeout=180, text=True)
        assert r.returncode == 0, r.stderr
        r = subprocess.run([os.path.join(d, "asan_fuzz")],
                           capture_output=True, timeout=120, text=True)
        assert r.returncode == 0, f"sanitizer findings:\n{r.stderr[-3000:]}"
        assert "asan_fuzz ok=" in r.stdout

    def test_random_garbage_is_error_clean(self):
        """1000 random-garbage buffers through the production (non-ASan)
        dt_inflate binding: every case must return cleanly (decoded bytes
        or a DT error), never crash or hang."""
        import numpy as np

        from deflate_jax import native as N
        if N.lib() is None:
            import pytest as _p
            _p.skip("native toolchain unavailable")
        rng = np.random.default_rng(99)
        for i in range(1000):
            n = int(rng.integers(0, 2048))
            buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            try:
                N.inflate(buf, 1 << 16)
            except ValueError:
                pass


class TestRfcTableCrossCheck:
    """Drift guard for the three copies of the RFC 1951 normative
    constants: utils/tables.py, native/inflate.cpp, native/deflate.cpp
    (the duplication is unavoidable, divergence
    is not)."""

    def test_native_tables_match_python(self):
        import numpy as np

        from deflate_jax import native as N
        from deflate_jax.utils import tables as T
        if N.lib() is None:
            import pytest as _p
            _p.skip("native toolchain unavailable")
        for which in ("inflate", "deflate"):
            t = N.rfc_tables(which)
            assert t is not None
            np.testing.assert_array_equal(t["len_base"], T.LENGTH_BASE,
                                          err_msg=which)
            np.testing.assert_array_equal(t["len_extra"], T.LENGTH_EXTRA,
                                          err_msg=which)
            np.testing.assert_array_equal(t["dist_base"], T.DIST_BASE,
                                          err_msg=which)
            np.testing.assert_array_equal(t["dist_extra"], T.DIST_EXTRA,
                                          err_msg=which)
            np.testing.assert_array_equal(t["cl_order"], T.CL_ORDER,
                                          err_msg=which)
