"""Block-index manifest: seekable, restartable, parallel-decodable streams.

Reference analog: none — the closest thing is the 32 KiB-chunk callback
seam (deflate.hpp:680, 762-772); SURVEY.md §5.4 mandates a manifest so huge
streams can be resumed and decoded per shard.  Because this encoder keeps
blocks independent (quirk Q5 — matches never cross block boundaries), any
block can be decoded knowing only its bit span, which makes random access
and distributed decode trivial.

Formats:
  * JSON (debug/interop): {version, block_size, total_bits, blocks:
    [[bit_off, bit_len, out_len], ...], hints?: base64, hint_lens?}.
  * binary (production, `to_bytes`/`from_bytes`): magic "DTM3", varint
    block table, hints bit-packed at 6 bits per chunk.

v2 added optional per-block DECODE HINTS — each 64-bit chunk's symbol
entry phase — which the encoder derives for free from its emit prefix
sums and the wavefront device decoder (models/wave_decoder.py)
consumes to decode every chunk of every block independently.  v3 packs them: phases are 0..63 (6 bits), trailing no-symbol
chunks (stored blocks, post-EOB tails) are trimmed, so the hint
overhead is ~9.4% of the compressed stream instead of v2's ~12.5%
(the reference needs no side channel at all —
inflate.hpp:277-322 — so the bench reports a total_footprint_ratio
that counts this).
"""
from __future__ import annotations

import base64
import dataclasses
import json
import struct

import numpy as np

from deflate_jax.utils.tables import BLOCK_SIZE

VERSION = 3

_MAGIC = b"DTM3"


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return


def _read_varint(buf: bytes, p: int):
    v = s = 0
    while True:
        b = buf[p]
        p += 1
        v |= (b & 0x7F) << s
        if not b & 0x80:
            return v, p
        s += 7


def _pack6(vals: bytes) -> bytes:
    """Pack byte values < 64 at 6 bits each, LSB-first."""
    a = np.frombuffer(vals, np.uint8).astype(np.uint32)
    assert (a < 64).all(), "hint phase out of 6-bit range"
    n = len(a)
    bits = np.zeros(n * 6, np.uint8)
    for i in range(6):
        bits[i::6] = (a >> i) & 1
    pad = (-len(bits)) % 8
    bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits.reshape(-1, 8)[:, ::-1]).tobytes()


def _unpack6(data: bytes, n: int) -> bytes:
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    bits = bits.reshape(-1, 8)[:, ::-1].reshape(-1)[:n * 6]
    a = np.zeros(n, np.uint8)
    for i in range(6):
        a |= (bits[i::6] << i).astype(np.uint8)
    return a.tobytes()


@dataclasses.dataclass
class Manifest:
    block_size: int
    total_bits: int
    blocks: list[tuple[int, int, int]]     # (bit_offset, bit_len, out_len)
    hints: list[bytes] | None = None       # per-block chunk entry phases

    def to_json(self) -> str:
        d = {"version": VERSION, "block_size": self.block_size,
             "total_bits": self.total_bits,
             "blocks": [list(b) for b in self.blocks]}
        if self.hints is not None:
            d["hints"] = base64.b64encode(b"".join(self.hints)).decode()
            d["hint_lens"] = [len(h) for h in self.hints]
        return json.dumps(d)

    def to_bytes(self) -> bytes:
        """Binary form: magic, counts, varint block table (bit_len and
        out_len delta-free; bit_off implicit as a running sum), then
        per-block varint hint lengths and one 6-bit-packed hint blob."""
        out = bytearray(_MAGIC)
        _write_varint(out, self.block_size)
        _write_varint(out, self.total_bits)
        _write_varint(out, len(self.blocks))
        prev = 0
        for off, bl, ol in self.blocks:
            assert off == prev, "blocks must be contiguous"
            _write_varint(out, bl)
            _write_varint(out, ol)
            prev = off + bl
        if self.hints is None:
            out.append(0)
        else:
            out.append(1)
            blob = b"".join(self.hints)
            for h in self.hints:
                _write_varint(out, len(h))
            packed = _pack6(blob)
            _write_varint(out, len(blob))
            out += packed
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Manifest":
        if data[:4] != _MAGIC:
            raise ValueError("bad manifest magic")
        p = 4
        bs, p = _read_varint(data, p)
        tb, p = _read_varint(data, p)
        nb, p = _read_varint(data, p)
        blocks = []
        off = 0
        for _ in range(nb):
            bl, p = _read_varint(data, p)
            ol, p = _read_varint(data, p)
            blocks.append((off, bl, ol))
            off += bl
        hints = None
        if data[p]:
            p += 1
            lens = []
            for _ in range(nb):
                n, p = _read_varint(data, p)
                lens.append(n)
            total, p = _read_varint(data, p)
            blob = _unpack6(data[p:], total)
            hints, q = [], 0
            for n in lens:
                hints.append(blob[q:q + n])
                q += n
        return cls(bs, tb, blocks, hints)

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        d = json.loads(s)
        if d.get("version") not in (1, 2, 3):
            raise ValueError(f"unsupported manifest version {d.get('version')}")
        hints = None
        if d.get("hints") is not None:
            blob = base64.b64decode(d["hints"])
            hints, p = [], 0
            for n in d["hint_lens"]:
                hints.append(blob[p:p + n])
                p += n
        return cls(d["block_size"], d["total_bits"],
                   [tuple(b) for b in d["blocks"]], hints)

    def hint_array(self):
        """[B, maxchunks] uint8 hints padded with HINT_NONE, or None."""
        if self.hints is None:
            return None
        from deflate_jax.ops.wave import HINT_NONE
        cap = max((len(h) for h in self.hints), default=1)
        out = np.full((len(self.hints), cap), HINT_NONE, np.uint8)
        for i, h in enumerate(self.hints):
            out[i, :len(h)] = np.frombuffer(h, np.uint8)
        return out

    @property
    def out_size(self) -> int:
        return sum(b[2] for b in self.blocks)

    def blocks_for_range(self, start: int, end: int):
        """Indices of blocks covering output bytes [start, end)."""
        out = []
        pos = 0
        for i, (_, _, olen) in enumerate(self.blocks):
            if pos < end and pos + olen > start:
                out.append(i)
            pos += olen
            if pos >= end:
                break
        return out


def compress_with_manifest(data, level: int = 2, hints: bool = True):
    """Compress on the device encoder and return (stream bytes, Manifest).

    ONE encode produces the stream, the per-block spans, and (v2) the
    wavefront decode hints — no separate plan_sizes pass (the encoder
    already computes offsets/bits).
    """
    import jax
    import jax.numpy as jnp

    import deflate_jax
    from deflate_jax.models import encoder as E
    from deflate_jax.runtime import stitch as S

    buf = deflate_jax._as_u8(data)
    nblocks = max(1, -(-len(buf) // BLOCK_SIZE))
    blocks = np.zeros((nblocks, BLOCK_SIZE), np.uint8)
    blens = np.zeros((nblocks,), np.int32)
    for i in range(nblocks):
        chunk = buf[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE]
        blocks[i, :len(chunk)] = chunk
        blens[i] = len(chunk)
    live = np.ones((nblocks,), bool)
    fn = E.encode_batch_with_hints if hints else E.encode_batch_with_offsets
    res = jax.jit(fn, static_argnums=(4,))(
        jnp.asarray(blocks), jnp.asarray(blens), jnp.asarray(live),
        np.int32(nblocks - 1), level, 0)
    words, total, offset, bits = res[:4]
    stream = S.words_to_bytes(np.asarray(words), int(total))
    offset = np.asarray(offset)
    bits = np.asarray(bits)
    hlist = None
    if hints:
        from deflate_jax.ops.wave import HINT_NONE

        harr = np.asarray(res[4], np.uint8)
        hlist = []
        for i in range(nblocks):
            h = harr[i, :int(-(-bits[i] // 64))]
            # trim trailing no-symbol chunks (stored blocks -> empty;
            # post-EOB tail chunks) so every kept phase fits 6 bits
            keep = np.nonzero(h != HINT_NONE)[0]
            hlist.append(h[:keep[-1] + 1].tobytes() if len(keep) else b"")
    man = Manifest(BLOCK_SIZE, int(offset[-1] + bits[-1]),
                   [(int(offset[i]), int(bits[i]), int(blens[i]))
                    for i in range(nblocks)], hlist)
    return stream, man


def decode_all(stream: bytes, man: Manifest, device: bool = False,
               stats: dict | None = None) -> bytes:
    """Decode an entire manifest-indexed stream.

    device=True runs the wavefront device decoder (models/wave_decoder.py)
    on every block, with the manifest's hints (v2+) or, for hint-less
    manifests, hints from a host walk.  A block the device path flags
    (an error bit or a size mismatch — corrupt or unrepresentable data)
    is decoded again on the host.  stats, when given, receives "path"
    ("wave" or "python_host") and "fallback_blocks", the number of blocks
    the host decoded after the device path flagged them."""
    from deflate_jax.models import host_inflate as HI

    nfall = 0
    if device:
        from deflate_jax.models import wave_decoder as WD

        offs = [b[0] for b in man.blocks]
        sizes = [b[2] for b in man.blocks]
        words, produced, err = WD.inflate_wave_device(
            stream, offs, sizes, man.hint_array())
        w = np.asarray(words).view(np.uint8).reshape(len(man.blocks), -1)
        parts = []
        for i, (bit_off, _, olen) in enumerate(man.blocks):
            if err[i] or produced[i] != olen:       # per-block fallback
                nfall += 1
                parts.append(HI.inflate_raw(stream, start_bit=bit_off,
                                            single_block=True))
            else:
                parts.append(w[i, :olen].tobytes())
        out = b"".join(parts)
    else:
        out = b"".join(HI.inflate_raw(stream, start_bit=bit_off,
                                      single_block=True)
                       for bit_off, _, _ in man.blocks)
    if stats is not None:
        stats.update({"path": "wave" if device else "python_host",
                      "fallback_blocks": nfall})
    return out


def decode_range(stream: bytes, man: Manifest, start: int, end: int) -> bytes:
    """Random-access decode of output bytes [start, end) without touching
    the rest of the stream — possible because blocks are independent (Q5)."""
    import deflate_jax

    from deflate_jax.models import host_inflate as HI

    end = min(end, man.out_size)
    if start >= end:
        return b""
    idxs = man.blocks_for_range(start, end)
    out = bytearray()
    base = sum(b[2] for b in man.blocks[:idxs[0]])
    for i in idxs:
        bit_off, _, _ = man.blocks[i]
        # decode exactly one block at its original bit phase — the stored-
        # block byte-align padding depends on the absolute stream phase
        out += HI.inflate_raw(stream, start_bit=bit_off, single_block=True)
    return bytes(out[start - base:end - base])
