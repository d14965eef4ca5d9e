"""CCAP-overflow coverage: a conforming stream with more
symbol starts per 64-bit chunk than the wave decoder's within-chunk
compaction capacity (CCAP=16) must be FLAGGED by the wave path — never
silently mis-decoded — and the public API must still return correct
bytes through the fallback ladder.

The stream is hand-crafted: a dynamic-Huffman block whose dominant
literal has a 1-bit code, giving 64 symbol starts per chunk (>> CCAP).
zlib is the conformance oracle.
"""
import zlib

import numpy as np
import pytest

import deflate_jax


class _W:
    """LSB-first bit writer (RFC 1951 §3.1.1)."""

    def __init__(self):
        self.bits = []

    def put(self, v, n):
        for i in range(n):
            self.bits.append((v >> i) & 1)

    def put_code(self, code, n):
        """Huffman code: MSB-first into the LSB-first stream."""
        for i in reversed(range(n)):
            self.bits.append((code >> i) & 1)

    def bytes(self):
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for j, bit in enumerate(self.bits[i:i + 8]):
                b |= bit << j
            out.append(b)
        return bytes(out)


def _craft_stream(n_a: int = 12000):
    """One dynamic block: lit codes A(65)->1 bit, B(66)->2, EOB->2."""
    w = _W()
    w.put(1, 1)                      # BFINAL
    w.put(2, 2)                      # BTYPE=10 dynamic
    w.put(0, 5)                      # HLIT  = 257 codes
    w.put(0, 5)                      # HDIST = 1 code (length 0 -> unused)
    # CL alphabet: lengths 2 for symbols {0, 1, 2, 18}; permutation
    # order is 16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15 — symbol
    # 1 sits at index 17, so HCLEN+4 = 18
    w.put(14, 4)                     # HCLEN
    perm = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
            15]
    cl_len = {0: 2, 1: 2, 2: 2, 18: 2}
    for s in perm[:18]:
        w.put(cl_len.get(s, 0), 3)
    # canonical CL codes (all len 2, by symbol): 0->00, 1->01, 2->10,
    # 18->11
    cl_code = {0: 0b00, 1: 0b01, 2: 0b10, 18: 0b11}

    def cl(sym, extra=None, ebits=0):
        w.put_code(cl_code[sym], 2)
        if extra is not None:
            w.put(extra, ebits)

    # literal lengths: 65 zeros, len1(A), len2(B), 189 zeros (67..255),
    # len2 (EOB) — 189 needs two op-18s (138 + 51)
    cl(18, 65 - 11, 7)
    cl(1)
    cl(2)
    cl(18, 138 - 11, 7)
    cl(18, 51 - 11, 7)
    cl(2)
    # distance lengths: one zero
    cl(0)
    # payload: canonical lit codes  A(len1)->0,  B(len2)->10, EOB->11
    for i in range(n_a):
        if i % 97 == 96:
            w.put_code(0b10, 2)      # B
        else:
            w.put_code(0b0, 1)       # A
    w.put_code(0b11, 2)              # EOB
    stream = w.bytes()
    data = bytes(66 if i % 97 == 96 else 65 for i in range(n_a))
    return stream, data


def test_crafted_stream_is_conforming():
    stream, data = _craft_stream()
    assert zlib.decompress(stream, -15) == data


def test_wave_flags_ccap_overflow_per_block():
    """The wave decoder must set the block error (ops/wave.py chain
    validation) — not return wrong bytes — when a chunk holds more than
    CCAP symbol starts."""
    from deflate_jax.models import wave_decoder as WD

    stream, data = _craft_stream()
    out, err = WD.inflate_wave(stream, [0], [len(data)], hints=None)
    err = np.asarray(err)
    if not err.any():
        # flagging is the contract; equality would also be acceptable
        # only if the decode is actually right
        assert out == data
        pytest.fail("CCAP overflow neither flagged nor decoded wrong — "
                    "unexpected silent success; inspect CCAP handling")


def test_public_api_returns_correct_bytes_via_fallback():
    stream, data = _craft_stream()
    assert deflate_jax.decompress(stream, len(data)) == data
    # forced device path: wave flags the block, the ladder still
    # produces exact bytes
    assert deflate_jax.decompress(stream, len(data), device=True,
                                  force_device=True) == data


def test_declined_stream_is_counted():
    """The wave path declines the stream for its data: the speculative
    decoder serves it, and the decline is counted."""
    stream, data = _craft_stream()
    before = deflate_jax.wave_fallback_count
    stats = {}
    out = deflate_jax.decompress(stream, len(data), device=True,
                                 force_device=True, stats=stats)
    assert out == data
    assert stats["device_path"] == "speculative"
    assert deflate_jax.wave_fallback_count == before + 1
