"""Ratio and size gates vs zlib-9 and the reference sizes (split from
test_roundtrip.py: these compile the L3 encoder at several shapes and
dominated that file's xdist worker wall time)."""
import zlib

import numpy as np

import corpus
import deflate_jax


def test_compression_beats_reference_sizes():
    """Device L3 on the bitmap fixtures, gated against zlib -9: within 6%
    on the row-stride bitmap, and at most 2 bytes over on the icon."""
    tiny = corpus.tiny_bitmap()
    enc3 = deflate_jax.compress(tiny, 3)
    assert len(enc3) <= len(zlib.compress(tiny, 9)) - 6 + 2
    test_bmp = corpus.picture_bitmap()
    enc3 = deflate_jax.compress(test_bmp, 3)
    assert len(enc3) <= 1.06 * (len(zlib.compress(test_bmp, 9)) - 6)
    # far row-stride matches (L3's adaptive TOO_FAR) beat the fast level
    assert len(enc3) < len(deflate_jax.compress(test_bmp, 2))
    assert zlib.decompress(enc3, wbits=-15) == test_bmp


def test_text_ratio_within_2pct_of_zlib9():
    """100 KB synthetic text within 2% of zlib-9."""
    rng = np.random.default_rng(0)
    words = rng.integers(32, 127, (100000 // 8, 6), dtype=np.uint8)
    text = np.concatenate(
        [np.concatenate([w, np.array([32, 32], np.uint8)])
         for w in words])[:100000].tobytes()
    z9 = len(zlib.compress(text, 9)) - 6
    l3 = len(deflate_jax.compress(text, 3))
    assert zlib.decompress(deflate_jax.compress(text, 3), -15) == text
    assert l3 <= z9 * 1.02, (l3, z9)


def test_zipf_text_parse_matches_blockwise_zlib9():
    """Parse quality on natural-text-like (zipf-weighted
    vocabulary) repetitive text.  The honest oracle is zlib-9 compressing
    the SAME independent 32 KiB blocks our format mandates (quirk Q5,
    reference deflate.hpp:697): against it this parse measures +0.4%
    (gated at 2%).  Against whole-stream zlib-9 the corpus shows ~+10%,
    of which ~10 points is the Q5 independent-block tax itself (zlib-9
    per-block pays the same +10.0%) — a format property the mesh
    parallelism and manifest seek/resume depend on, not a parse defect;
    gated at 12% so a parse regression still trips it."""
    rng = np.random.default_rng(7)
    vocab = [bytes(rng.integers(97, 123, rng.integers(3, 9))
                   .astype(np.uint8)) for _ in range(200)]
    w = 1.0 / np.arange(1, 201)
    w /= w.sum()
    text = b" ".join(vocab[i]
                     for i in rng.choice(200, 20000, p=w))[:100000]
    z9_whole = len(zlib.compress(text, 9)) - 6
    z9_blk = sum(len(zlib.compress(text[i:i + 32768], 9)) - 6
                 for i in range(0, len(text), 32768))
    enc = deflate_jax.compress(text, 3)
    assert zlib.decompress(enc, -15) == text
    assert len(enc) <= z9_blk * 1.02, (len(enc), z9_blk)
    assert len(enc) <= z9_whole * 1.12, (len(enc), z9_whole)



def test_l2_mixed_corpus_ratio():
    """Round-4 TOO_FAR tuning: the fast level must stay at-or-below
    0.600 on a bench-like mixed corpus (text/repeats/words/random
    quarters) — it measured 0.5942 after dropping far len-3 matches,
    down from 0.6029.  A parse regression (or a too-loose TOO_FAR)
    trips this before it reaches the driver bench."""
    rng = np.random.default_rng(42)
    per = 8 * 32768
    segs = [rng.integers(97, 123, per, dtype=np.uint8)]
    pat = rng.integers(0, 256, 509, dtype=np.uint8)
    segs.append(np.tile(pat, per // 509 + 1)[:per])
    words = rng.integers(32, 127, (per // 8, 6), dtype=np.uint8)
    segs.append(np.concatenate(
        [np.concatenate([w, np.array([32, 32], np.uint8)])
         for w in words])[:per])
    segs.append(rng.integers(0, 256, per, dtype=np.uint8))
    data = np.concatenate(segs).tobytes()
    enc = deflate_jax.compress(data, 2)
    assert zlib.decompress(enc, -15) == data
    assert len(enc) / len(data) <= 0.600, len(enc) / len(data)


def test_total_footprint_ratio_gate():
    """The device decoder's side channel (manifest v3,
    6-bit packed hints) must stay cheap — stream + binary manifest
    within 10.5% of the bare stream (v2's 1-byte/chunk hints were
    ~12.5%; v3 packs phases at 6 bits and trims no-symbol tails)."""
    from deflate_jax.runtime import manifest as MF

    rng = np.random.default_rng(42)
    per = 4 * 32768
    segs = [rng.integers(97, 123, per, dtype=np.uint8),
            rng.integers(0, 256, per, dtype=np.uint8)]
    data = np.concatenate(segs).tobytes()
    stream, man = MF.compress_with_manifest(data, 2)
    blob = man.to_bytes()
    # binary manifest round trip is exact
    man2 = MF.Manifest.from_bytes(blob)
    assert man2.blocks == man.blocks
    assert man2.hints == man.hints
    assert man2.total_bits == man.total_bits
    # decode via the manifest still round-trips
    assert MF.decode_all(stream, man2) == data
    assert len(blob) <= len(stream) * 0.105 + 64, (len(blob), len(stream))
