"""Streaming checksums for the checkpoint datapath.

The port's copy of what the datapath uses from ``repro.core.tce.fastcopy``:
:func:`crc32_stream`, a crc32 over a buffer without materialising
``tobytes()``. The reference's copy meter and its chunked multi-threaded copy
into cache arenas wait for the port of the TCE engine, which uses them.
"""
from __future__ import annotations

import zlib

import numpy as np

CRC_CHUNK = 1 << 20                  # streaming-crc window (cache-resident)


def crc32_stream(buf, chunk: int = CRC_CHUNK) -> int:
    """crc32 over a buffer *without* materialising ``tobytes()``.

    Walks a flat memoryview in cache-resident windows — zero allocations,
    zero copies (reads only). Accepts any contiguous buffer (ndarray,
    memoryview, bytes).
    """
    if isinstance(buf, np.ndarray):
        mv = memoryview(np.ascontiguousarray(buf)).cast("B")
    else:
        mv = memoryview(buf).cast("B")
    crc = 0
    for i in range(0, len(mv), chunk):
        crc = zlib.crc32(mv[i:i + chunk], crc)
    return crc & 0xFFFFFFFF
