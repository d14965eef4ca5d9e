"""Seeded in-repo test inputs that stand in for a reference corpus.

bitmap() is a 24-bit BMP of a low-entropy image: a few colours in long
horizontal runs, and rows that repeat the row above with small edits, so
the best matches sit one row stride back — the property behind L3's
adaptive TOO_FAR (ops/lz77.py).  Sizes follow the usual small test images
(a 16x16 icon, a ~22 KB picture).
"""
import struct

import numpy as np


def bitmap(width: int, height: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (12, 3), dtype=np.uint8)
    stride = (3 * width + 3) & ~3
    rows = []
    row = np.zeros(width, np.int64)
    for y in range(height):
        if y == 0 or rng.random() < 0.3:
            # a fresh row of colour runs
            x = 0
            while x < width:
                run = int(rng.integers(2, 24))
                row[x:x + run] = rng.integers(0, len(palette))
                x += run
        else:
            # the row above with a few short edits
            for _ in range(int(rng.integers(0, 8))):
                x = int(rng.integers(0, width))
                row[x:x + int(rng.integers(1, 6))] = rng.integers(
                    0, len(palette))
        px = palette[row].reshape(-1)
        rows.append(np.pad(px, (0, stride - 3 * width)).tobytes())
    pixels = b"".join(rows)
    header = (b"BM" + struct.pack("<IHHI", 54 + len(pixels), 0, 0, 54)
              + struct.pack("<IiiHHIIiiII", 40, width, height, 1, 24, 0,
                            len(pixels), 2835, 2835, 0, 0))
    return header + pixels


def tiny_bitmap() -> bytes:
    return bitmap(16, 16, seed=1)


def picture_bitmap() -> bytes:
    return bitmap(120, 60, seed=2)
