"""Data-parallel encode over an 8-virtual-device CPU mesh."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deflate_jax.models import encoder as E
from deflate_jax.ops.bitpack import words_to_bytes
from deflate_jax.parallel import mesh as M
from deflate_jax.utils.tables import BLOCK_SIZE


def _mk_blocks(B, rng, fill=1.0):
    blocks = np.zeros((B, BLOCK_SIZE), np.uint8)
    blens = np.zeros((B,), np.int32)
    for i in range(B):
        k = max(1, int(BLOCK_SIZE * fill) - 17 * i)
        if i % 3 == 0:
            blocks[i, :k] = rng.integers(97, 105, k, dtype=np.uint8)
        elif i % 3 == 1:
            blocks[i, :k] = rng.integers(0, 256, k, dtype=np.uint8)
        else:
            pat = rng.integers(0, 256, 97, dtype=np.uint8)
            blocks[i, :k] = np.tile(pat, k // 97 + 1)[:k]
        blens[i] = k
    return blocks, blens


@pytest.mark.parametrize("level", [0, 2])
def test_mesh_matches_single_program(level):
    assert len(jax.devices()) >= 8
    mesh = M.make_mesh(jax.devices()[:8])
    rng = np.random.default_rng(7)
    B = 8
    blocks, blens = _mk_blocks(B, rng)
    live = np.ones((B,), bool)

    wm, tm = M.encode_mesh(jnp.asarray(blocks), jnp.asarray(blens),
                           jnp.asarray(live), jnp.int32(B - 1), level, mesh)
    w1, t1 = E.encode_batch(jnp.asarray(blocks), jnp.asarray(blens),
                            jnp.asarray(live), jnp.int32(B - 1), level)
    assert int(tm) == int(t1)
    assert words_to_bytes(np.asarray(wm), int(tm)) == \
        words_to_bytes(np.asarray(w1), int(t1))


def test_compress_mesh_roundtrip():
    mesh = M.make_mesh(jax.devices()[:8])
    rng = np.random.default_rng(11)
    pat = rng.integers(0, 200, 311, dtype=np.uint8)
    data = np.tile(pat, 700)[: 3 * BLOCK_SIZE + 12345].tobytes()
    out = M.compress_mesh(data, level=2, mesh=mesh)
    assert zlib.decompress(out, -15) == data


@pytest.mark.slow
def test_dryrun_multichip():
    import __graft_entry__ as GE

    GE.dryrun_multichip(8)


def test_decode_mesh_roundtrip():
    from deflate_jax.parallel import mesh as M2
    from deflate_jax.runtime import manifest as MF

    mesh = M2.make_mesh(jax.devices()[:8])
    rng = np.random.default_rng(21)
    parts = [rng.integers(97, 123, 60000, dtype=np.uint8).tobytes(),
             b"mesh decode! " * 5000,
             rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()]
    data = b"".join(parts)
    stream, man = MF.compress_with_manifest(data, level=2)
    got = M2.decompress_mesh(stream, man, mesh)
    assert got == data


class TestFaultInjection:
    """SURVEY.md §5.3 failure detection on the mesh path: corruption in
    any shard's blocks must surface as an error (never wrong bytes), and
    recovery = per-block retry using the manifest's independence
    guarantee (quirk Q5)."""

    def test_corrupt_block_surfaces_error(self):
        import numpy as np
        import pytest as _p

        import deflate_jax
        from deflate_jax.parallel import mesh as M
        from deflate_jax.runtime import manifest as MAN

        rng = np.random.default_rng(21)
        data = (rng.integers(97, 123, 8 * 32768, dtype=np.uint8)
                .tobytes())
        stream, man = MAN.compress_with_manifest(data, level=2)
        # flip bits inside block 3's span (body, past the header)
        bad = bytearray(stream)
        off = man.blocks[3][0] // 8 + 40
        for i in range(8):
            bad[off + i] ^= 0xA5
        with _p.raises(ValueError):
            M.decompress_mesh(bytes(bad), man)

    def test_per_block_retry_recovers(self):
        """Drop one shard's output (simulated worker failure) and recover
        by re-decoding just the affected blocks via the manifest."""
        import numpy as np

        import deflate_jax
        from deflate_jax.runtime import manifest as MAN

        rng = np.random.default_rng(22)
        data = (rng.integers(97, 123, 6 * 32768, dtype=np.uint8)
                .tobytes())
        stream, man = MAN.compress_with_manifest(data, level=2)
        # decode all blocks; pretend blocks 2..3 (one worker's shard) died
        parts = []
        pos = 0
        for i, (_, _, olen) in enumerate(man.blocks):
            if i in (2, 3):
                parts.append(None)           # lost shard
            else:
                parts.append(MAN.decode_range(stream, man, pos, pos + olen))
            pos += olen
        # recovery: blocks are independent, so re-decode only the lost ones
        pos = 0
        for i, (_, _, olen) in enumerate(man.blocks):
            if parts[i] is None:
                parts[i] = MAN.decode_range(stream, man, pos, pos + olen)
            pos += olen
        assert b"".join(parts) == data


def test_decompress_mesh_routes_v2_manifests_to_wave(monkeypatch):
    """The mesh decode entry point must run the
    wavefront decoder for hint-carrying manifests (and it must produce
    the right bytes)."""
    import numpy as np

    from deflate_jax.parallel import mesh as M
    from deflate_jax.runtime import manifest as MF

    rng = np.random.default_rng(31)
    data = (rng.integers(97, 123, 3 * 32768, dtype=np.uint8).tobytes()
            + b"wave on the mesh " * 4000
            + rng.integers(0, 256, 32768, dtype=np.uint8).tobytes())
    stream, man = MF.compress_with_manifest(data, level=2)
    assert man.hints is not None

    hit = {}
    real = M.decompress_mesh_wave

    def spy(*a, **k):
        hit["wave"] = True
        return real(*a, **k)

    monkeypatch.setattr(M, "decompress_mesh_wave", spy)
    got = M.decompress_mesh(stream, man)
    assert got == data
    assert hit.get("wave"), "mesh decode did not take the wave path"
