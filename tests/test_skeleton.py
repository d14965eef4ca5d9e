"""Skeleton-planned wavefront decode: FOREIGN streams on the device path.

The native skeleton walk (native/inflate.cpp dt_skeleton) cuts any
conforming raw DEFLATE stream into <=32 KiB virtual blocks with decode
hints; ops/wave.py decodes them in parallel (synthetic stops for cut
blocks) and ops/fill.fill_matches_hist resolves matches across block
boundaries — the reference's persistent-window semantics
(inflate.hpp:284-305) on the device path.
"""
import zlib

import numpy as np
import pytest

import deflate_jax
from deflate_jax import native as N
from deflate_jax.models import wave_decoder as WD


def _planned(data: bytes, enc: bytes):
    plan = WD.skeleton_plan(enc)
    assert plan is not None
    out, err = WD.inflate_wave_planned(enc, plan)
    assert out is not None and not err.any(), np.nonzero(err)
    assert out == data
    return plan


class TestSkeletonWalk:
    def test_hints_match_host_walk_on_own_stream(self):
        rng = np.random.default_rng(3)
        data = (rng.integers(97, 110, 50000, dtype=np.uint8).tobytes()
                + b"hello world " * 2000)
        enc = deflate_jax.compress(data, level=2)
        sk = N.skeleton(enc)
        assert sk is not None and sk["total_out"] == len(data)
        from deflate_jax.ops import wave as W
        hints_ref, span_ref = W.hints_from_walk_host(enc, sk["parent_bit"])
        for b in range(len(sk["out_len"])):
            if sk["btype"][b] == 0:
                continue
            nch = -(-int(sk["span_bits"][b]) // 64)
            np.testing.assert_array_equal(sk["hints"][b, :nch],
                                          hints_ref[b, :nch])
            assert int(sk["span_bits"][b]) == int(span_ref[b])
            assert sk["flags"][b] & 2 and not (sk["flags"][b] & 4)

    def test_accounting_on_foreign_stream(self):
        big = b"The quick brown fox jumps over the lazy dog. " * 20000
        sk = N.skeleton(zlib.compress(big, 9)[2:-4])
        assert sk["total_out"] == len(big)
        assert (sk["out_len"] <= 32768).all()
        assert (np.cumsum(sk["out_len"]) - sk["out_len"]
                == sk["out_start"]).all()

    def test_garbage_errors_cleanly(self):
        rng = np.random.default_rng(99)
        for i in range(300):
            n = int(rng.integers(1, 700))
            buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            try:
                N.skeleton(buf)
            except ValueError:
                pass


class TestPlannedDecode:
    def test_foreign_text_with_history(self):
        data = b"The quick brown fox jumps over the lazy dog. " * 4000
        plan = _planned(data, zlib.compress(data, 9)[2:-4])
        assert ((np.asarray(plan["flags"]) & 4) > 0).any()   # used history

    def test_foreign_overlap_matches(self):
        rng = np.random.default_rng(5)
        data = (b"a" * 100000 + b"ab" * 30000 + b"abc" * 20000
                + bytes(rng.integers(97, 100, 50000, dtype=np.uint8)))
        _planned(data, zlib.compress(data, 9)[2:-4])

    def test_foreign_stored_blocks(self):
        rng = np.random.default_rng(6)
        data = rng.integers(0, 256, 150000, dtype=np.uint8).tobytes()
        plan = _planned(data, zlib.compress(data, 1)[2:-4])
        assert ((np.asarray(plan["flags"]) & 1) > 0).any()

    def test_match_referencing_stored_bytes(self):
        # huffman block matches reaching back into a stored block's output
        rng = np.random.default_rng(7)
        rnd = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
        data = rnd + rnd[:20000] + b"x" * 5000
        _planned(data, zlib.compress(data, 6)[2:-4])

    @pytest.mark.slow
    def test_tiny_inputs(self):
        for d in (b"", b"x", b"hello world"):
            _planned(d, zlib.compress(d, 9)[2:-4])

    def test_own_stream_fast_path(self):
        data = b"The quick brown fox jumps over the lazy dog. " * 2000
        enc = deflate_jax.compress(data, level=2)
        plan = _planned(data, enc)
        f = np.asarray(plan["flags"])
        assert ((f & 2) > 0).all() and not ((f & 4) > 0).any()

    def test_corruption_never_crashes(self):
        data = b"The quick brown fox jumps over the lazy dog. " * 1500
        enc = bytearray(zlib.compress(data, 9)[2:-4])
        rng = np.random.default_rng(11)
        for _ in range(12):
            pos = int(rng.integers(0, len(enc)))
            bit = 1 << int(rng.integers(0, 8))
            bad = bytes(enc[:pos]) + bytes([enc[pos] ^ bit]) \
                + bytes(enc[pos + 1:])
            try:
                plan = WD.skeleton_plan(bad)
                if plan is None:
                    continue
                WD.inflate_wave_planned(bad, plan)
            except (ValueError, Exception):
                pass


class TestDecompressDeviceWave:
    def test_device_decompress_serves_via_wave(self):
        """decompress(device=True) must reach the wavefront decoder for a
        bare self-contained stream."""
        data = b"The quick brown fox jumps over the lazy dog. " * 2000
        enc = deflate_jax.compress(data, level=2)
        st = {}
        out = deflate_jax.decompress(enc, len(data), device=True,
                                     force_device=True, stats=st)
        assert out == data
        assert st["device_path"] == "wave", st

    def test_device_decompress_foreign_via_wave(self):
        data = b"zlib made this stream, not us. " * 6000
        ref = zlib.compress(data, 9)[2:-4]
        st = {}
        out = deflate_jax.decompress(ref, len(data), device=True,
                                     force_device=True, stats=st)
        assert out == data
        assert st["device_path"] == "wave", st
