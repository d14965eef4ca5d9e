"""Typed configuration for the codec (SURVEY.md §5.6).

Reference analog: one `int compression_level` plus compile-time constants
(deflate.hpp:675-679, common.hpp:14).  Defaults are reference-compatible:
32 KiB blocks, level semantics 0-3.
"""
from __future__ import annotations

import dataclasses

from deflate_jax.utils.tables import BLOCK_SIZE


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """End-to-end codec settings.

    level:       0 stored, 1 Huffman-only, 2 fast (hash chains), 3 best
                 (deeper chains + lazy matching) — reference levels
                 deflate.hpp:675-679, but every level round-trips correctly
                 (the reference's level 2 does not, SURVEY.md B1).
    block_size:  input bytes per DEFLATE block (reference: KB32, one chunk
                 = one block, quirk Q1).  The device programs are compiled
                 for 32768; other values use the native/host path.
    container:   "raw" (RFC 1951) or "zlib" (RFC 1950 with Adler-32).
    backend:     "device", "native", or "auto" (see deflate_jax.compress).
    device_decode: run decompression on the device decoder when True.
    emit_manifest: also produce a block-index manifest (seek/resume).
    mesh_axis:   name of the data-parallel mesh axis for multi-chip runs.
    """

    level: int = 2
    block_size: int = BLOCK_SIZE
    container: str = "raw"
    backend: str = "device"
    device_decode: bool = False
    emit_manifest: bool = False
    mesh_axis: str = "data"

    def __post_init__(self):
        if not 0 <= self.level <= 3:
            raise ValueError(f"level must be 0..3, got {self.level}")
        if self.container not in ("raw", "zlib"):
            raise ValueError(f"container must be raw|zlib, got {self.container}")
        if self.backend not in ("device", "native", "auto"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.block_size <= 0 or self.block_size > BLOCK_SIZE:
            raise ValueError("block_size must be in (0, 32768]")


DEFAULT = CodecConfig()
