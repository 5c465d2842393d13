"""One run of one cell: the job its traffic driver gets, the comparison of each
number with its limit, the per-layer readers over the trace, and the result
line.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from perfbench.counts.flops import PEAKS
from perfbench.lib import program, spec

SPANS = ("bench_step", "bench_wave", "tce_save")


@dataclass
class Job:
    cell: str
    doc: dict            # the configuration file
    port: dict           # its "port" section: the sizes as run
    cfg: Any             # the program's configuration object
    traffic: dict
    ref: Any             # the configuration's plain reference module
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


def make_job(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, port_over: Optional[dict] = None,
             traffic_over: Optional[dict] = None) -> Job:
    """``port_over`` and ``traffic_over`` replace entries of the files (the
    CPU tests' tiny sizes)."""
    c = spec.cell(bench, cell_name)
    doc = spec.config(bench, c["config"])
    port = {**doc["port"], **(port_over or {})}
    traffic = {**spec.traffic(c["traffic"]), **(traffic_over or {})}
    return Job(cell_name, doc, port, program.model_config(port), traffic,
               spec.reference(doc["reference"]), seed, seconds, trace, device, t_start)


def segment(trace):
    """The traced stretch: from the first span of the benchmark's own to the
    end of the last."""
    wins = [w for w in (trace.window(s) for s in SPANS) if w is not None]
    if not wins:
        return None
    return min(a for a, _ in wins), max(b for _, b in wins)


def per_layer(metrics: list, ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: dict, job: Job) -> dict:
    """Drive the cell once; returns the result line as a dict."""
    if job.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(job.device)
    limits = spec.limits(job.cell)
    out = spec.driver(job.traffic["driver"]).run(job)
    wanted = spec.cell_metrics(bench, job.cell)

    # the limits file names the numbers compared; a number the traffic driver
    # reads and the file does not name is printed, not compared
    numbers = out["numbers"]
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    correct = out["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    for k in sorted(set(numbers) - set(limits)):
        print(f"reading {k} {numbers[k]!r} (not compared)", file=sys.stderr)
    for note in out.get("notes", []):
        print(note, file=sys.stderr)

    device = {"platform": "gpu" if job.device.type == "cuda" else job.device.type,
              "kind": (torch.cuda.get_device_name(job.device) if job.device.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line: Dict[str, Any] = {"correct": bool(correct), "attempted": int(out["attempted"]),
                            "failed": int(out["failed"])}
    ctx = out["ctx"]
    if job.trace:
        trace = ctx.get("trace")
        seg = segment(trace) if trace is not None else None
        ctx.update(segment=seg, peaks=PEAKS)
        line["metrics"] = per_layer(wanted["per_layer"], ctx)
        if seg is not None:
            device["busy_s"] = trace.busy_us(*seg) * 1e-6
            device["window_s"] = (seg[1] - seg[0]) * 1e-6
            line["breakdown"] = {
                "device_ops": trace.top_ops(*seg),
                "idle_gaps": trace.idle_gaps(*seg, trace.main_tid("bench_step")
                                             or trace.main_tid("bench_wave"))}
    else:
        values = {**out["e2e"], "setup_s": out["setup_s"]}
        missing = [m["name"] for m in wanted["end_to_end"] if m["name"] not in values]
        if missing:
            raise spec.SpecError(f"{job.cell}: the traffic driver gives no {missing}")
        line["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                           for m in wanted["end_to_end"]}
    line["device"] = device
    line["checks"] = checks
    return line


def print_checks(line: dict) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {line['correct']} failed {line['failed']} of {line['attempted']}",
          file=sys.stderr)
