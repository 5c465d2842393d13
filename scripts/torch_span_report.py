"""Run one cell of the benchmark once with the trace on, as
``perfbench/run.py --trace 1`` does, and report beside its result line what
the program's own spans (``repro_torch.obs``) say about the run:

* the anchors (main-thread spans both in the ring and in the trace): their
  count, how far apart the tightest bounds on the clocks' offset lie, and the
  spread of the starts' and the ends' offsets;
* which program spans reached the trace from threads other than the main one
  (the TCE pool's and the reconciler's);
* the run's spans by name (the MoE's ``moe.*`` with ``moe.shared``, MLA's
  ``mla.project``, ``mla.attend`` and ``mla.out``): count, host seconds and
  summed attributes (but the step, rank and the layers' sizes and
  settings, ``SIZES``);
* ``durable_s``, which ``BENCHMARK.json`` does not list (read here in the
  traced run, where the profiler's stop can hold the reconciler);
* the longest idle gaps of the traced segment, each named by the main
  thread's innermost host operation and by the innermost program span open
  on another thread (the reconciler's phase) at its middle;
* the device busy time per traced step.

    python3 scripts/torch_span_report.py --workload mamba2-train-ckpt --seed 7 \\
        --seconds 51 --json build/spans.json

The result line is the last line of standard output, as ``run.py`` prints
it; the report goes to ``--json`` and to standard error. Needs a CUDA card.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = ("train.", "moe.", "mla.", "tce.")
# attributes that name a size or a setting, not a count: not summed
SIZES = ("step", "rank", "tokens", "capacity", "d_ff", "q_lora_rank", "qk_dim", "v_dim", "scale")


def gaps(trace, t0, t1, n):
    """The n longest stretches of [t0, t1] with nothing on the device: the
    list ``Trace.idle_gaps`` makes before it names each gap by the main
    thread alone (a benchmark change could let both share it)."""
    from perfbench.lib.trace import _clip, union

    busy = union(_clip([(a, b) for a, b, *_ in trace.device], t0, t1))
    out, cur = [], t0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return sorted(out, key=lambda g: g[0] - g[1])[:n]


def innermost(intervals, t):
    inside = [x for x in intervals if x[0] <= t <= x[1]]
    return min(inside, key=lambda x: x[1] - x[0])[2] if inside else "none"


def report(ctx, line, n_gaps):
    from perfbench.lib import program_spans, spec

    trace, seg = ctx["trace"], ctx["segment"]
    run = program_spans.run_spans(ctx)
    tid = trace.main_tid("bench_step") or trace.main_tid("bench_wave")
    reached = defaultdict(lambda: defaultdict(int))
    for name, spans in trace.spans.items():
        if name.startswith(PROGRAM):
            for _a, _b, t in spans:
                reached["main" if t == tid else str(t)][name] += 1
    out = {"main_tid": tid, "program_spans_in_trace": {k: dict(v) for k, v in reached.items()}}
    busy_s = trace.busy_us(*seg) * 1e-6
    out["busy_s"] = busy_s
    out["busy_ms_per_traced_step"] = busy_s * 1e3 / ctx["profiled"] if ctx.get("profiled") else None
    if run is None:
        out["anchors"] = None
        return out
    starts = [a - r.t0 * 1e-3 for (a, _b), r in zip(run.marks, run.anchors)]
    ends = [b - r.t1 * 1e-3 for (_a, b), r in zip(run.marks, run.anchors)]
    out["anchors"] = {"n": len(run.anchors), "bounds_apart_us": run.spread_us,
                      "start_offsets_spread_us": max(starts) - min(starts),
                      "end_offsets_spread_us": max(ends) - min(ends),
                      "loosest": sorted(((round(o - run.offset_us, 1), r.name) for o, r in
                                         zip(starts + ends, run.anchors * 2)),
                                        key=lambda x: -abs(x[0]))[:5]}
    me = threading.get_ident()
    by = defaultdict(lambda: {"count": 0, "seconds": 0.0, "attrs": defaultdict(float)})
    for r in run.records:
        key = f"{r.name}@{'main' if r.thread == me else 'other'}"
        by[key]["count"] += 1
        by[key]["seconds"] += r.seconds
        for k, v in r.attrs.items():
            if isinstance(v, (int, float)) and k not in SIZES:
                by[key]["attrs"][k] += v
    out["spans"] = {k: {**v, "attrs": dict(v["attrs"])} for k, v in sorted(by.items())}
    host = [(a, b, name) for a, b, name, t in trace.host if t == tid]
    others = [(*run.on_trace(r), r.name) for r in run.records if r.thread != me]
    out["idle_gaps"] = [{"seconds": (b - a) * 1e-6, "at_s": (a - seg[0]) * 1e-6,
                         "main": innermost(host, (a + b) / 2)[:80],
                         "other_thread": innermost(others, (a + b) / 2)}
                        for a, b in gaps(trace, *seg, n_gaps)]
    out["other_thread_spans_s"] = [[r.name, (run.on_trace(r)[0] - seg[0]) * 1e-6,
                                    (run.on_trace(r)[1] - seg[0]) * 1e-6]
                                   for r in run.records if r.thread != me
                                   and r.name in ("tce.reconcile", "tce.digest", "tce.persist",
                                                  "tce.backup", "tce.commit")]
    out["segment_s"] = (seg[1] - seg[0]) * 1e-6
    out["durable_s"] = spec.metric_reader("durable_s").read(ctx)
    ms = line.get("metrics", {})
    quiesce = sum(r.seconds for r in run.named("tce.quiesce"))
    if "save_stall_s" in ms:
        stall = ms["save_stall_s"]["value"]
        parts = sum(ms[k]["value"] for k in ("save_d2h_s", "save_cache_s") if k in ms)
        out["save_parts_over_stall_less_quiesce"] = parts / (stall - quiesce)
        out["quiesce_s"] = quiesce
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--gaps", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench.lib import harness, spec

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    seen = {}
    real = harness.per_layer

    def spy(metrics, ctx):
        seen["ctx"] = ctx
        return real(metrics, ctx)

    harness.per_layer = spy
    bench = spec.benchmark(ROOT)
    job = harness.make_job(bench, args.workload, args.seed, args.seconds, True, device, T_START)
    line = harness.run_cell(bench, job)
    rep = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device),
           **report(seen["ctx"], line, args.gaps)}
    text = json.dumps(rep, indent=1)
    print(text, file=sys.stderr)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text)
    print(json.dumps(line), flush=True)
    harness.print_checks(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
