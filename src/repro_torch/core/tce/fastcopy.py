"""Host memory copies and streaming checksums for the checkpoint datapath.

Counterpart of ``repro.core.tce.fastcopy`` (paper Algorithm 2): the chunked
multi-threaded host copy into cache arenas on one shared copy pool
(:func:`chunked_copy`, ``direct`` or ``bounce``), the global copy meter
:data:`METER` that every byte physically copied through the datapath reports
into, and :func:`crc32_stream`, a crc32 over a buffer without materialising
``tobytes()``. It takes any contiguous buffer, the codec's bf16 carrier
(:data:`~repro_torch.core.tce.codec.BF16`) included.

:func:`snapshot` takes a tensor: it is copied to the host once (into ``out``
when one is given), a CPU tensor too, as the reference's ``np.asarray`` of a
device array is; ``engine.flatten_pytree`` takes every leaf through it.
"""
from __future__ import annotations

import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .codec import BF16

DEFAULT_CHUNK = 4 * 1024 * 1024      # k: bounce-buffer size
DEFAULT_THREADS = 4                  # n
CRC_CHUNK = 1 << 20                  # streaming-crc window (cache-resident)

# One shared copy pool for every chunked_copy call in the process. The
# historical implementation spawned (and joined) fresh threading.Thread
# workers per call — thread creation dominated small steady-state saves.
# Copy workers never submit further work, so sharing one executor across
# concurrent engine save/restore calls cannot deadlock; calls just queue.
_COPY_POOL: Optional[ThreadPoolExecutor] = None
_COPY_POOL_LOCK = threading.Lock()


def _copy_pool() -> ThreadPoolExecutor:
    global _COPY_POOL
    if _COPY_POOL is None:
        with _COPY_POOL_LOCK:
            if _COPY_POOL is None:
                _COPY_POOL = ThreadPoolExecutor(
                    max_workers=max(os.cpu_count() or 4, DEFAULT_THREADS),
                    thread_name_prefix="copy")
    return _COPY_POOL


class CopyMeter:
    """Thread-safe count of bytes physically copied through the datapath."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, nbytes: int) -> None:
        with self._lock:
            self._n += int(nbytes)

    def read(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


METER = CopyMeter()


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


@dataclass
class CopyStats:
    nbytes: int
    wall_s: float
    threads: int
    chunk: int

    @property
    def gbps(self) -> float:
        return self.nbytes / max(self.wall_s, 1e-9) / 1e9


def chunked_copy(dst: np.ndarray, src: np.ndarray,
                 n_threads: int = DEFAULT_THREADS,
                 chunk: int = DEFAULT_CHUNK,
                 mode: str = "direct") -> CopyStats:
    """Multi-threaded chunked copy src -> dst (both uint8 views, same size).

    ``mode="direct"`` moves each byte once; ``mode="bounce"`` stages every
    chunk through a per-thread bounce buffer (two physical moves per byte,
    the pre-datapath behaviour). Both report into :data:`METER`.
    """
    assert dst.nbytes >= src.nbytes, (dst.nbytes, src.nbytes)
    assert mode in ("direct", "bounce"), mode
    n = src.nbytes
    hops = 1 if mode == "direct" else 2
    src_b = src.view(np.uint8).reshape(-1)
    dst_b = dst.view(np.uint8).reshape(-1)
    t0 = time.perf_counter()
    if n <= chunk or n_threads <= 1:
        if mode == "direct":
            dst_b[:n] = src_b
        else:
            bounce = np.empty(min(chunk, max(n, 1)), np.uint8)
            j = 0
            while j < n:
                step = min(chunk, n - j)
                bounce[:step] = src_b[j:j + step]
                dst_b[j:j + step] = bounce[:step]
                j += step
        METER.add(n * hops)
        return CopyStats(n, time.perf_counter() - t0, 1, chunk)

    per = (n + n_threads - 1) // n_threads

    def worker(i: int):
        beg, end = i * per, min((i + 1) * per, n)
        if mode == "direct":
            j = beg
            while j < end:
                step = min(chunk, end - j)
                dst_b[j:j + step] = src_b[j:j + step]
                j += step
            return
        bounce = np.empty(min(chunk, max(end - beg, 1)), np.uint8)  # pinned analogue
        j = beg
        while j < end:
            step = min(chunk, end - j)
            # two-hop copy through the small bounce buffer (cache-resident)
            bounce[:step] = src_b[j:j + step]
            dst_b[j:j + step] = bounce[:step]
            j += step

    pool = _copy_pool()
    for f in [pool.submit(worker, i) for i in range(n_threads)]:
        f.result()
    METER.add(n * hops)
    return CopyStats(n, time.perf_counter() - t0, n_threads, chunk)


def snapshot(tensor, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Device -> host snapshot of a tensor (or numpy array) into a host
    buffer: one copy, straight into ``out`` when it is given."""
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        if out is not None:
            dst = torch.from_numpy(out.view(np.uint8).reshape(-1)[:t.nbytes])
            dst.copy_(t.contiguous().reshape(-1).view(torch.uint8))
            METER.add(t.nbytes)
            return out
        host = t.to("cpu", copy=True)
        METER.add(host.nbytes)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(BF16)
        return host.numpy()
    host = np.asarray(tensor)
    if out is None:
        METER.add(host.nbytes)
        return np.array(host, copy=True)
    chunked_copy(out, host.view(np.uint8).reshape(-1))
    return out
