"""deflate_jax — a DEFLATE (RFC 1951) codec built on JAX.

Public API mirrors the reference library's surface (deflate.hpp:753-815,
inflate.hpp:324-408) with a correctness upgrade: every level round-trips
bit-exactly (the reference's level 2 emits corrupt streams — SURVEY.md B1).

    compress(data, level=2) -> bytes          # raw DEFLATE
    compress_file(src, dst, level=2)
    decompress(data, out_size=None) -> bytes  # raw DEFLATE
    decompress_zlib(data) -> bytes            # RFC 1950 container
    decompress_file(src, dst)

Levels: 0 stored, 1 Huffman-only, 2 fast (hash-chain), 3 best (lazy).
"""
from __future__ import annotations

import os as _os

import numpy as np


def compile_cache_dir(environ=_os.environ) -> str | None:
    """Where this package keeps JAX's persistent compilation cache: None
    when JAX_COMPILATION_CACHE_DIR is set (JAX then uses that directory
    itself), else <checkout>/.cache/jax — a fixed path, because the path
    is part of the cache key."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".cache", "jax")


def _enable_compile_cache():
    path = compile_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)


_enable_compile_cache()

from deflate_jax.models import host_inflate as _hi
from deflate_jax.runtime import stitch as _stitch
from deflate_jax.utils.config import CodecConfig
from deflate_jax.utils.tables import BLOCK_SIZE

InflateError = _hi.InflateError

__all__ = ["compress", "compress_file", "decompress", "decompress_zlib",
           "decompress_file", "compress_zlib", "compress_gzip",
           "decompress_gzip", "compress_many", "decompress_many",
           "InflateError", "CodecConfig"]

_BATCH_BUCKETS = (1, 8, 64)


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(data), dtype=np.uint8)
    a = np.asarray(data)
    if a.dtype != np.uint8:
        raise TypeError(f"expected bytes or uint8 array, got {a.dtype}")
    return a.reshape(-1)


def _bucket(n: int) -> int:
    for b in _BATCH_BUCKETS:
        if n <= b:
            return b
    return _BATCH_BUCKETS[-1]


def compress(data, level: int = 2, backend: str = "device",
             config=None, stats: dict | None = None) -> bytes:
    """Compress to a raw DEFLATE stream (decodable by zlib wbits=-15).

    backend: "device" (the JAX encoder — default), "native" (the C++
    host runtime, deflate_jax/native/deflate.cpp), or "auto" (native for
    sub-block inputs where a device round trip costs more than the work).

    config: a ``deflate_jax.CodecConfig``; when given it supplies level /
    backend / container (a "zlib" container wraps the stream per RFC
    1950).  stats: an empty dict that receives a structured run report
    (utils/metrics.RunReport schema: ratio, MB/s, block-type histogram).
    """
    if config is not None:
        level = config.level
        backend = config.backend
        if config.emit_manifest:
            # one encode produces stream + block index (+ v2 decode hints);
            # the manifest rides in stats["manifest"] so the return type
            # stays bytes.  Offsets always index the RAW deflate stream
            # (for zlib containers: relative to the first post-header byte).
            if stats is None:
                raise ValueError(
                    "config.emit_manifest=True needs a stats dict to "
                    "receive the manifest")
            from deflate_jax.runtime import manifest as _mf

            inner, man = _mf.compress_with_manifest(data, level)
            stats.update({"op": "compress", "bytes_in": len(_as_u8(data)),
                          "bytes_out": len(inner), "manifest": man})
            if config.container == "zlib":
                hdr = bytes([0x78, 0x01])
                adler = _hi.adler32(bytes(_as_u8(data).tobytes()))
                return hdr + inner + adler.to_bytes(4, "big")
            return inner
        if config.container == "zlib":
            inner = compress(data, level, backend, stats=stats)
            hdr = bytes([0x78, 0x01])
            adler = _hi.adler32(bytes(_as_u8(data).tobytes()))
            return hdr + inner + adler.to_bytes(4, "big")
    if not 0 <= level <= 3:
        raise ValueError(f"level must be 0..3, got {level}")
    if backend not in ("device", "native", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    report = None
    if stats is not None:
        from deflate_jax.utils.metrics import RunReport

        report = RunReport("compress")
    buf = _as_u8(data)
    if backend == "native" or (backend == "auto" and len(buf) < BLOCK_SIZE):
        from deflate_jax import native as _nat

        out = _nat.deflate(buf.tobytes(), level)
        if out is not None:
            if report is not None:
                report.bytes_in = len(buf)
                report.bytes_out = len(out)
                report.extra["backend"] = "native"
                stats.update(report.finish())
            return out

    import jax.numpy as jnp

    from deflate_jax.models import encoder as E
    nblocks = max(1, -(-len(buf) // BLOCK_SIZE))
    segments = []
    done = 0
    phase = 0                  # stream bit phase at the segment boundary
    while done < nblocks:
        B = _bucket(nblocks - done)
        take = min(B, nblocks - done)
        blocks = np.zeros((B, BLOCK_SIZE), np.uint8)
        blens = np.zeros((B,), np.int32)
        for i in range(take):
            chunk = buf[(done + i) * BLOCK_SIZE:(done + i + 1) * BLOCK_SIZE]
            blocks[i, :len(chunk)] = chunk
            blens[i] = len(chunk)
        live = np.arange(B) < take
        final_idx = (take - 1) if done + take == nblocks else -1
        words, total = E.encode_batch(
            jnp.asarray(blocks), jnp.asarray(blens), jnp.asarray(live),
            jnp.int32(final_idx), level, jnp.int32(phase))
        segments.append((np.asarray(words), int(total)))
        phase = (phase + int(total)) & 7
        done += take
    out_words, out_bits = _stitch.stitch_segments(segments)
    stream = _stitch.words_to_bytes(out_words, out_bits)
    if report is not None:
        import jax.numpy as jnp

        from deflate_jax.models import encoder as E
        blocks = np.zeros((nblocks, BLOCK_SIZE), np.uint8)
        blens = np.zeros((nblocks,), np.int32)
        for i in range(nblocks):
            chunk = buf[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE]
            blocks[i, :len(chunk)] = chunk
            blens[i] = len(chunk)
        choice, _, _, _ = E.plan_sizes(
            jnp.asarray(blocks), jnp.asarray(blens),
            jnp.ones((nblocks,), bool), level)
        report.bytes_in = len(buf)
        report.bytes_out = len(stream)
        report.extra["backend"] = "device"
        report.extra["level"] = level
        report.add_blocks(np.asarray(choice))
        stats.update(report.finish())
    return stream


def decompress(data, out_size: int | None = None,
               device: bool = False, config=None,
               stats: dict | None = None,
               force_device: bool = False) -> bytes:
    """Decompress a raw DEFLATE stream.

    For a bare stream (no manifest hints), device=True routes to the HOST
    decoder by default: the device path must first derive hints via a
    full sequential host walk, which costs more than the host decode
    itself.  Pass force_device=True to run the skeleton-walk + wavefront
    device path anyway (hint-carrying manifest decodes via decode_all
    always use the device).  config: a ``CodecConfig`` supplying
    device_decode / container; stats: an empty dict that receives a
    structured run report, including "device_path", the decoder that
    served the call.
    """
    if config is not None:
        device = config.device_decode
        if config.container == "zlib":
            out = decompress_zlib(data, device=device)
            if stats is not None:
                stats.update({"op": "decompress", "bytes_in": len(data),
                              "bytes_out": len(out), "container": "zlib"})
            return out
    if stats is not None:
        import time as _time

        t0 = _time.perf_counter()
        path = {}
        out = _decompress_impl(bytes(data), out_size, device, path,
                               force_device)
        dt = _time.perf_counter() - t0
        stats.update({
            "op": "decompress", "bytes_in": len(data),
            "bytes_out": len(out), "seconds": round(dt, 4),
            "mb_per_s": round(len(out) / dt / 1e6, 2) if dt else None,
            "device": device, "device_path": path.get("path"),
            "redirected": path.get("redirected")})
        return out
    return _decompress_impl(bytes(data), out_size, device, None,
                            force_device)


def _decompress_impl(raw: bytes, out_size, device: bool,
                     path: dict | None,
                     force_device: bool = False) -> bytes:
    """Decode dispatcher.  Records which backend actually served the call
    in path["path"]: "wave" (wavefront device decoder), "speculative"
    (XLA scan decoder, for streams the wave path declines),
    "native_host", or "python_host".
    """
    def _mark(p):
        if path is not None:
            path["path"] = p

    if device and not force_device:
        # hint-less streams: the device path needs a full sequential
        # host walk first (skeleton_plan), so device=True redirects to
        # the host decoder unless explicitly forced
        device = False
        if path is not None:
            path["redirected"] = "device_to_host_default"
    if device:
        from deflate_jax.models import decoder as _dd

        wave_out = _try_wave_decompress(raw, out_size)
        if wave_out is not None:
            _mark("wave")
            return wave_out
        _mark("speculative")
        return _dd.inflate_device(raw, out_size)
    from deflate_jax import native as _nat

    try:
        out = _nat.inflate(raw, out_size or max(1024, 8 * len(raw)),
                           exact=out_size is not None)
    except ValueError as e:
        raise InflateError(str(e)) from None
    if out is not None:
        _mark("native_host")
        return out
    _mark("python_host")
    return _hi.inflate_raw(raw, out_size)


#: Count of forced device decodes the wave path declined because of the
#: data (malformed stream, a block it cannot represent, an error flag, a
#: size mismatch), so that a slower decoder served them.  Errors in the
#: decoder itself are raised, never counted.
wave_fallback_count = 0


def _try_wave_decompress(raw: bytes, out_size) -> bytes | None:
    """Wavefront path for a bare stream (no manifest): a native skeleton
    walk derives every block's bit offset, output size, and per-chunk
    entry-phase hints, then the wavefront decoder
    (models/wave_decoder.py) decodes all blocks in parallel.  Returns
    None (and counts it in wave_fallback_count) when the stream's data
    rules the wave path out; exceptions propagate."""
    global wave_fallback_count
    from deflate_jax.models import wave_decoder as _wd

    plan = _wd.skeleton_plan(raw)
    out = None
    if plan is not None:
        out, err = _wd.inflate_wave_planned(raw, plan)
        if out is not None and (err.any() or (
                out_size is not None and len(out) != out_size)):
            out = None
    if out is None:
        wave_fallback_count += 1
    return out


def decompress_zlib(data, device: bool = False,
                    force_device: bool = False) -> bytes:
    """Decompress a zlib-wrapped (RFC 1950) stream, verifying Adler-32."""
    data = bytes(data)
    if device:
        if len(data) < 6:
            raise InflateError("zlib stream too short")
        cmf, flg = data[0], data[1]
        if cmf & 0x0F != 8:
            raise InflateError("unsupported compression method")
        if (cmf * 256 + flg) % 31 != 0:
            raise InflateError("bad zlib header check")
        ofs = 6 if flg & 0x20 else 2
        out = decompress(data[ofs:], device=True,
                         force_device=force_device)
        if _hi.adler32(out) != int.from_bytes(data[-4:], "big"):
            raise InflateError("adler32 mismatch")
        return out
    return _hi.inflate_zlib(data)


def compress_zlib(data, level: int = 2) -> bytes:
    """Compress into a zlib (RFC 1950) container — the reference can only
    *read* zlib streams; we also write them."""
    raw = compress(data, level)
    hdr = bytes([0x78, 0x01])            # CM=8, CINFO=7, FCHECK -> 0x7801
    adler = _hi.adler32(bytes(data) if not isinstance(data, bytes) else data)
    return hdr + raw + adler.to_bytes(4, "big")


def compress_gzip(data, level: int = 2) -> bytes:
    """Compress into a gzip (RFC 1952) member — a container the reference
    has no support for at all (it reads zlib only, and writes raw)."""
    import zlib as _z

    raw = compress(data, level)
    payload = bytes(data) if isinstance(data, (bytes, bytearray)) \
        else _as_u8(data).tobytes()
    hdr = bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 255])
    crc = _z.crc32(payload) & 0xFFFFFFFF
    isize = len(payload) & 0xFFFFFFFF
    return (hdr + raw + crc.to_bytes(4, "little")
            + isize.to_bytes(4, "little"))


def _gzip_member_payload_offset(buf: bytes, ofs: int) -> int:
    """Parse one gzip member header at `ofs`; return the payload offset.

    Verifies FHCRC (CRC-16 of the header) when present — the RFC 1952
    check the reference has no analog for.  Raises InflateError on any
    malformed header (truncated optional fields included).
    """
    import zlib as _z

    try:
        if buf[ofs] != 0x1F or buf[ofs + 1] != 0x8B:
            raise InflateError("not a gzip stream")
        if buf[ofs + 2] != 8:
            raise InflateError("unsupported gzip compression method")
        flg = buf[ofs + 3]
        if flg & 0xE0:
            raise InflateError("reserved gzip FLG bits set")
        p = ofs + 10
        if flg & 0x04:                               # FEXTRA
            xlen = int.from_bytes(buf[p:p + 2], "little")
            p += 2 + xlen
            if p > len(buf):
                raise InflateError("gzip FEXTRA truncated")
        if flg & 0x08:                               # FNAME
            p = buf.index(0, p) + 1
        if flg & 0x10:                               # FCOMMENT
            p = buf.index(0, p) + 1
        if flg & 0x02:                               # FHCRC
            stored = int.from_bytes(buf[p:p + 2], "little")
            if _z.crc32(buf[ofs:p]) & 0xFFFF != stored:
                raise InflateError("gzip header crc16 mismatch")
            p += 2
        if p + 8 > len(buf):                         # payload + trailer room
            raise InflateError("gzip member truncated")
        return p
    except (IndexError, ValueError) as e:
        if isinstance(e, InflateError):
            raise
        raise InflateError("malformed gzip header") from None


def decompress_gzip(data) -> bytes:
    """Decompress a gzip (RFC 1952) file: one or more concatenated members
    (RFC 1952 §2.2 — `gzip -c a b > ab.gz` style), verifying each member's
    CRC-32, ISIZE, and (when present) header CRC-16."""
    import zlib as _z

    from deflate_jax import native as _nat

    buf = bytes(data)
    if len(buf) < 18:
        raise InflateError("not a gzip stream")
    parts = []
    ofs = 0
    while ofs < len(buf):
        p = _gzip_member_payload_offset(buf, ofs)
        payload = buf[p:]
        try:
            res = _nat.inflate_consumed(payload, max(1024, 8 * len(payload)))
        except ValueError as e:
            raise InflateError(str(e)) from None
        if res is None:
            out, consumed = _hi.inflate_raw_consumed(payload)
        else:
            out, consumed = res
        t = p + consumed
        if t + 8 > len(buf):
            raise InflateError("gzip trailer truncated")
        crc = int.from_bytes(buf[t:t + 4], "little")
        isize = int.from_bytes(buf[t + 4:t + 8], "little")
        if _z.crc32(out) & 0xFFFFFFFF != crc:
            raise InflateError("gzip crc32 mismatch")
        if len(out) & 0xFFFFFFFF != isize:
            raise InflateError("gzip isize mismatch")
        parts.append(out)
        ofs = t + 8
    return b"".join(parts)


def compress_many(buffers, level: int = 2) -> list:
    """Compress many independent buffers in shared device batches.

    The production-serving shape: B streams encode as one batched program
    invocation instead of B separate calls.  Each buffer becomes its own
    raw DEFLATE stream (own BFINAL block, own bit phase 0).
    """
    import jax.numpy as jnp

    from deflate_jax.models import encoder as E

    if not 0 <= level <= 3:
        raise ValueError(f"level must be 0..3, got {level}")
    bufs = [_as_u8(b) for b in buffers]
    # flatten all buffers' blocks into one batch, remembering ownership
    owners = []                      # (buffer idx, is_final_block)
    chunks = []
    for bi, buf in enumerate(bufs):
        nb = max(1, -(-len(buf) // BLOCK_SIZE))
        for j in range(nb):
            chunks.append(buf[j * BLOCK_SIZE:(j + 1) * BLOCK_SIZE])
            owners.append((bi, j == nb - 1))

    B = len(chunks)
    blocks = np.zeros((B, BLOCK_SIZE), np.uint8)
    blens = np.zeros((B,), np.int32)
    for i, c in enumerate(chunks):
        blocks[i, :len(c)] = c
        blens[i] = len(c)

    # per-buffer phase is always 0 at its start; buffers are independent,
    # so encode each block batch with per-block bfinal via a mask trick:
    # run encode per contiguous buffer segment using one batched plan.
    # Simpler correct formulation: encode each buffer's blocks as its own
    # segment but batch ALL plans/emits in one call using final mask.
    finals = np.array([f for _, f in owners])
    live = np.ones((B,), bool)
    # encode_batch supports one final_idx; generalize by running it with
    # final_idx=-1 and fixing BFINAL bits per buffer is invasive — instead
    # group same-buffer blocks and exploit that choose_blocks only couples
    # blocks through the running phase, which resets per buffer.  We call
    # the batched planner once and emit with per-block bfinal & offsets
    # computed per buffer on host.
    words, per_bits = E.encode_blocks_multi(
        jnp.asarray(blocks), jnp.asarray(blens), jnp.asarray(live),
        jnp.asarray(finals),
        jnp.asarray(np.array([o for o, _ in owners], np.int32)), level)
    words = np.asarray(words).reshape(B, -1)
    per_bits = np.asarray(per_bits)

    out = []
    i = 0
    for bi, buf in enumerate(bufs):
        nb = max(1, -(-len(buf) // BLOCK_SIZE))
        segs = [(words[i + j], int(per_bits[i + j])) for j in range(nb)]
        w, t = _stitch.stitch_segments(segs)
        out.append(_stitch.words_to_bytes(w, t))
        i += nb
    return out


def decompress_many(streams, device: bool = False) -> list:
    """Decompress many independent raw DEFLATE streams."""
    return [decompress(s, device=device) for s in streams]


def compress_file(src: str, dst: str, level: int = 2,
                  chunk_blocks: int = 256) -> None:
    """Streaming file->file compression in bounded memory.

    Reads `chunk_blocks` 32 KiB blocks at a time (8 MiB by default),
    encodes each chunk as one device batch, and appends complete bytes to
    the output while carrying the bit-level tail across chunks — the
    reference's BitFile flush-on-byte-boundary behavior
    (deflate.hpp:160-182), without its single-shot memory profile.
    """
    import os as _os

    import jax.numpy as jnp

    from deflate_jax.models import encoder as E

    if not 0 <= level <= 3:
        raise ValueError(f"level must be 0..3, got {level}")
    size = _os.path.getsize(src)
    nblocks_total = max(1, -(-size // BLOCK_SIZE))
    chunk_bytes = chunk_blocks * BLOCK_SIZE

    phase = 0
    tail_byte = 0                   # partial byte carried across chunks
    done_blocks = 0
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        while True:
            data = fin.read(chunk_bytes)
            if not data and done_blocks:
                break
            buf = np.frombuffer(data, dtype=np.uint8)
            take = max(1, -(-len(buf) // BLOCK_SIZE)) if (
                len(buf) or done_blocks == 0) else 0
            if take == 0:
                break
            B = _bucket(take)
            blocks = np.zeros((B, BLOCK_SIZE), np.uint8)
            blens = np.zeros((B,), np.int32)
            for i in range(take):
                c = buf[i * BLOCK_SIZE:(i + 1) * BLOCK_SIZE]
                blocks[i, :len(c)] = c
                blens[i] = len(c)
            live = np.arange(B) < take
            final_idx = (take - 1) if done_blocks + take == nblocks_total \
                else -1
            words, total = E.encode_batch(
                jnp.asarray(blocks), jnp.asarray(blens), jnp.asarray(live),
                jnp.int32(final_idx), level, jnp.int32(phase))
            seg = np.asarray(words)
            nbits = int(total)
            # merge the carried tail with this segment at bit offset phase
            w, bits = _stitch.stitch_segments(
                [(np.array([tail_byte], np.uint32), phase), (seg, nbits)])
            stream = _stitch.words_to_bytes(w, bits)
            full = (phase + nbits) // 8
            fout.write(stream[:full])
            phase = (phase + nbits) & 7
            tail_byte = stream[full] if phase else 0
            done_blocks += take
            if done_blocks >= nblocks_total:
                break
        if phase:
            fout.write(bytes([tail_byte]))


def decompress_file(src: str, dst: str, chunk_bytes: int = 1 << 23) -> None:
    """Streaming file->file decompression in bounded memory.

    Decodes block by block with a sliding input window and a 32 KiB
    output-history window (cross-block back-references are RFC-legal in
    foreign streams), so peak memory is O(chunk_bytes), independent of
    the file size.  Blocks spanning a read boundary are handled by
    extending the window and retrying — the case the reference's chunked
    file path gets wrong (inflate.hpp:390-408, SURVEY.md B5).
    """
    from deflate_jax.models import host_inflate as _hi2

    with open(src, "rb") as fin, open(dst, "wb") as fout:
        ibuf = bytearray(fin.read(chunk_bytes))
        eof = len(ibuf) < chunk_bytes
        ibase = 0                       # absolute byte offset of ibuf[0]
        bitpos = 0                      # absolute bit position
        history = b""
        while True:
            local = bitpos - 8 * ibase
            try:
                out, end_local, bfinal = _hi2.inflate_block_streaming(
                    bytes(ibuf), local, history)
            except (InflateError, IndexError):
                if eof:
                    raise InflateError(
                        f"truncated or corrupt stream near bit {bitpos}"
                    ) from None
                more = fin.read(chunk_bytes)
                eof = len(more) < chunk_bytes
                ibuf += more
                continue
            fout.write(out)
            history = (history + out)[-32768:]
            bitpos = 8 * ibase + end_local
            if bfinal:
                break
            drop = (bitpos // 8) - ibase
            if drop > chunk_bytes // 2:          # slide consumed input out
                del ibuf[:drop]
                ibase += drop
            if not eof and len(ibuf) - (bitpos // 8 - ibase) \
                    < chunk_bytes // 2:
                more = fin.read(chunk_bytes)
                eof = len(more) < chunk_bytes
                ibuf += more
