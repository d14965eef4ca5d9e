"""Host-side bit-level stream assembly (numpy; C++ fast path in native/).

Joins device-produced bitstream segments at arbitrary bit offsets — the
host half of the seam the reference implements serially in
``Bitstream::copyBitstream`` (deflate.hpp:143-150) and ``BitFile``
(deflate.hpp:160-182).
"""
from __future__ import annotations

import numpy as np


def stitch_segments(segments) -> tuple[np.ndarray, int]:
    """Concatenate [(words uint32, nbits int), ...] at bit granularity.

    Returns (words uint32, total_bits). Bits past nbits in each segment's
    last word must be zero (device emitters guarantee this).
    """
    from deflate_jax import native as _nat

    fast = _nat.stitch(segments)
    if fast is not None:
        return fast
    total = sum(int(nb) for _, nb in segments)
    out = np.zeros(total // 32 + 2, dtype=np.uint32)
    off = 0
    for w, nb in segments:
        nb = int(nb)
        if nb == 0:
            continue
        nwords = (nb + 31) // 32
        w = np.asarray(w[:nwords], dtype=np.uint32)
        base, s = off >> 5, off & 31
        if s == 0:
            out[base:base + nwords] |= w
        else:
            sh = (w << np.uint32(s)).astype(np.uint32)
            carry = (w >> np.uint32(32 - s)).astype(np.uint32)
            out[base:base + nwords] |= sh
            out[base + 1:base + 1 + nwords] |= carry
        off += nb
    return out, total


def words_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    nbytes = (nbits + 7) // 8
    return words.view(np.uint8)[:nbytes].tobytes()
