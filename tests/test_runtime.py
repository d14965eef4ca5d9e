"""Manifest (seek/resume), config, metrics subsystems."""
import json

import numpy as np
import pytest

import deflate_jax
from deflate_jax.runtime import manifest as M
from deflate_jax.utils.config import CodecConfig
from deflate_jax.utils.metrics import RunReport


def _data():
    rng = np.random.default_rng(9)
    parts = [
        rng.integers(97, 123, 40000, dtype=np.uint8).tobytes(),
        (b"seekable! " * 4000),
        rng.integers(0, 256, 50000, dtype=np.uint8).tobytes(),
    ]
    return b"".join(parts)


@pytest.fixture(scope="module")
def stream_and_manifest():
    data = _data()
    stream, man = M.compress_with_manifest(data, level=2)
    return data, stream, man


def test_manifest_roundtrip_json(stream_and_manifest):
    _, _, man = stream_and_manifest
    man2 = M.Manifest.from_json(man.to_json())
    assert man2.blocks == man.blocks
    assert man2.out_size == man.out_size


def test_manifest_matches_stream(stream_and_manifest):
    data, stream, man = stream_and_manifest
    assert man.out_size == len(data)
    assert (man.total_bits + 7) // 8 == len(stream)
    assert deflate_jax.decompress(stream) == data


@pytest.mark.parametrize("rng", [(0, 100), (32760, 32800), (65536, 98304),
                                 (100000, 130000), (0, 10**9)])
def test_decode_range(stream_and_manifest, rng):
    data, stream, man = stream_and_manifest
    start, end = rng
    got = M.decode_range(stream, man, start, end)
    assert got == data[start:min(end, len(data))]


def test_block_level_resume(stream_and_manifest):
    """Every block decodes standalone at its recorded offset (Q5)."""
    data, stream, man = stream_and_manifest
    from deflate_jax.models import host_inflate as HI

    pos = 0
    for (bit_off, _, out_len) in man.blocks:
        blk = HI.inflate_raw(stream, start_bit=bit_off, single_block=True)
        assert blk == data[pos:pos + out_len]
        pos += out_len


def test_config_validation():
    CodecConfig(level=3, container="zlib", backend="auto")
    with pytest.raises(ValueError):
        CodecConfig(level=7)
    with pytest.raises(ValueError):
        CodecConfig(container="gzip")
    with pytest.raises(ValueError):
        CodecConfig(backend="gpu")


def test_run_report():
    r = RunReport("encode")
    r.bytes_in = 1000
    r.bytes_out = 300
    r.add_blocks([0, 2, 2, 1])
    d = json.loads(r.emit())
    assert d["ratio"] == 0.3
    assert d["block_types"] == {"stored": 1, "fixed": 1, "dynamic": 2}


class TestConfigAndStats:
    """SURVEY.md §5.5/§5.6: the typed config and the structured run
    report are wired through the public API."""

    def test_config_roundtrip_raw(self):
        import zlib

        import deflate_jax as D
        cfg = D.CodecConfig(level=3, backend="device")
        data = b"config wired " * 400
        enc = D.compress(data, config=cfg)
        assert zlib.decompress(enc, -15) == data
        assert D.decompress(enc, config=D.CodecConfig()) == data

    def test_config_zlib_container(self):
        import zlib

        import deflate_jax as D
        cfg = D.CodecConfig(level=2, container="zlib")
        data = b"zlib container via config" * 100
        enc = D.compress(data, config=cfg)
        assert zlib.decompress(enc) == data
        assert D.decompress(enc, config=cfg) == data

    @pytest.mark.slow
    def test_stats_report(self):
        import deflate_jax as D
        data = b"statistics " * 3000 + bytes(range(256)) * 16
        stats = {}
        enc = D.compress(data, level=2, stats=stats)
        assert stats["op"] == "compress"
        assert stats["bytes_in"] == len(data)
        assert stats["bytes_out"] == len(enc)
        assert 0 < stats["ratio"] <= 1.1
        assert sum(stats["block_types"].values()) >= 1
        dstats = {}
        out = D.decompress(enc, stats=dstats)
        assert out == data
        assert dstats["bytes_out"] == len(data)

    def test_config_validation(self):
        import pytest as _pytest

        import deflate_jax as D
        with _pytest.raises(ValueError):
            D.CodecConfig(level=7)
        with _pytest.raises(ValueError):
            D.CodecConfig(container="7z")


class TestWaveFallbackSurfacing:
    """An error inside the wave path must surface (never be served
    silently by a slower decoder); a stream the wave path declines for
    its data is counted."""

    def test_synthetic_wave_failure_warns_and_falls_back(self, monkeypatch):
        import deflate_jax as D
        from deflate_jax.models import wave_decoder as WD

        data = b"surface the failure " * 2000
        stream = D.compress(data, 2)

        def boom(raw):
            raise RuntimeError("synthetic lowering failure")

        monkeypatch.setattr(WD, "skeleton_plan", boom)
        before = D.wave_fallback_count
        with pytest.raises(RuntimeError, match="synthetic lowering"):
            D.decompress(stream, device=True, force_device=True)
        assert D.wave_fallback_count == before

    def test_unsupported_stream_returns_none_without_warning(self):
        import warnings

        import deflate_jax as D

        data = b"clean path " * 3000
        stream = D.compress(data, 2)
        before = D.wave_fallback_count
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            stats = {}
            out = D.decompress(stream, device=True, force_device=True,
                               stats=stats)
        assert out == data
        assert stats["device_path"] == "wave"
        assert D.wave_fallback_count == before


class TestCompileCache:
    def test_cache_dir_in_checkout_without_env(self):
        import os

        import deflate_jax as D

        root = os.path.dirname(os.path.dirname(os.path.abspath(D.__file__)))
        assert D.compile_cache_dir({}) == os.path.join(root, ".cache", "jax")

    def test_env_cache_dir_wins(self):
        import deflate_jax as D

        assert D.compile_cache_dir(
            {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None


def test_decode_all_device_v1_manifest():
    """A hint-less (v1) manifest decodes on the device path, with hints
    from a host walk, and no block falls back to the host."""
    rng = np.random.default_rng(12)
    data = (rng.integers(97, 105, 20000, dtype=np.uint8).tobytes()
            + b"v1 manifest " * 1500)
    stream, man = M.compress_with_manifest(data, level=2, hints=False)
    assert man.hints is None
    stats = {}
    assert M.decode_all(stream, man, device=True, stats=stats) == data
    assert stats == {"path": "wave", "fallback_blocks": 0}
