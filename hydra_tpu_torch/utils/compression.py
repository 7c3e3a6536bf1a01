"""zlib compression helpers — equivalent of src/compression.cpp:6-126.

The reference uses these only on its (absent) preprocessed-bed path; they are
provided for format parity: deflate/inflate of float64 columns with the same
zlib stream format, so data compressed by either implementation round-trips
through the other.
"""

from __future__ import annotations

import zlib

import numpy as np


def compress_doubles(values: np.ndarray, level: int = 6) -> bytes:
    """Deflate a float64 vector (compressData, compression.cpp:22-60)."""
    return zlib.compress(np.ascontiguousarray(values, dtype=np.float64).tobytes(),
                         level)


def decompress_doubles(blob: bytes, count: int) -> np.ndarray:
    """Inflate back to float64 (extractData, compression.cpp:70-126)."""
    raw = zlib.decompress(blob)
    out = np.frombuffer(raw, dtype=np.float64, count=count)
    if len(out) != count:
        raise ValueError(f"decompressed {len(out)} doubles, expected {count}")
    return out.copy()
