"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a fixed
run of steps or waves, exported as a Chrome trace into ``TMPDIR``, read back
and deleted. What the per-layer readers and the result's ``breakdown`` take
from it: device operations (kernels, copies, sets) as intervals, the
benchmark's own spans (``record_function``), and which kernels a span
launched (by the launch's correlation id).
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# A kernel's kind by its name (the first rule that matches), for the
# elementwise readers: a copy of the classes the repository's smoke run prints.
KERNEL_KINDS = (("ssd_scan", ("ssd_fwd",)), ("flash_attention", ("fa_fwd",)),
                ("topk", ("topk",)), ("scan / sort", ("scan", "sort", "radix")),
                ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "matmul")),
                ("softmax", ("softmax",)), ("reduce", ("reduce",)),
                ("gather / scatter", ("index", "gather", "scatter")),
                ("elementwise / copy", ("elementwise", "copy")))


def kernel_kind(name: str) -> str:
    low = name.lower()
    return next((kind for kind, keys in KERNEL_KINDS if any(k in low for k in keys)), "other")


class Profile:
    """``torch.profiler`` started and stopped around a run of steps; read
    once the measured window has closed."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def read(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        return Trace(events.get("traceEvents", events) if isinstance(events, dict) else events)


Interval = Tuple[float, float]


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(iv: List[Interval], t0: float, t1: float) -> List[Interval]:
    return [(max(a, t0), min(b, t1)) for a, b in iv if b > t0 and a < t1]


class Trace:
    """Times in microseconds, as the Chrome trace has them."""

    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str, str, Optional[int]]] = []
        self.spans: Dict[str, List[Tuple[float, float, int]]] = defaultdict(list)
        self.launches: Dict[int, float] = {}
        self.host: List[Tuple[float, float, str, int]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e["dur"])
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e["name"], cat, corr))
            if cat in LAUNCH_CATS and corr is not None:
                self.launches[corr] = ts
            if cat == "user_annotation":
                self.spans[e["name"]].append((ts, ts + dur, e.get("tid")))
            if cat in HOST_CATS:
                self.host.append((ts, ts + dur, e["name"], e.get("tid")))

    def window(self, span: str) -> Optional[Interval]:
        """From the first ``span``'s start to the last one's end."""
        s = self.spans.get(span)
        if not s:
            return None
        return min(a for a, _b, _t in s), max(b for _a, b, _t in s)

    def busy_us(self, t0: float, t1: float) -> float:
        """Time in [t0, t1] in which some operation ran on the device."""
        iv = union(_clip([(a, b) for a, b, *_ in self.device], t0, t1))
        return sum(b - a for a, b in iv)

    def kernels_in(self, t0: float, t1: float):
        return [d for d in self.device if d[3] == "kernel" and t0 <= d[0] < t1]

    def kernels_under(self, span: str, t0: float, t1: float):
        """Kernels whose launch the host made inside a ``span`` in [t0, t1]."""
        spans = [(a, b) for a, b, _t in self.spans.get(span, []) if t0 <= a < t1]
        out = []
        for d in self.device:
            ts = self.launches.get(d[4]) if d[4] is not None else None
            if d[3] == "kernel" and ts is not None and any(a <= ts <= b for a, b in spans):
                out.append(d)
        return out

    def top_ops(self, t0: float, t1: float, n: int = 10) -> List[list]:
        """The device operations that took most time, by name, in seconds."""
        tot: Dict[str, float] = defaultdict(float)
        for a, b, name, _c, _k in self.device:
            if t0 <= a < t1:
                tot[name] += b - a
        return [[k[:200], v * 1e-6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, t0: float, t1: float, main_tid, n: int = 10) -> List[list]:
        """The longest stretches of [t0, t1] with nothing on the device,
        each named by the innermost host operation of the main thread at
        its middle, in seconds."""
        busy = union(_clip([(a, b) for a, b, *_ in self.device], t0, t1))
        gaps, cur = [], t0
        for a, b in busy:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < t1:
            gaps.append((cur, t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [h for h in self.host if h[3] == main_tid and h[0] <= mid <= h[1]]
            name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "none"
            out.append([name[:200], (b - a) * 1e-6])
        return out

    def main_tid(self, span: str):
        s = self.spans.get(span)
        return s[0][2] if s else None
