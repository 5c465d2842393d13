"""Readings that set a cell's limits, at the cell's own size, on the card:

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13

For each seed, the numbers the cell compares, read with the plain reference
in bfloat16 as the judge and, in the program's place:

* ``control``: the reference computed in float8 (e4m3, one scale per
  tensor), the step below the configuration's bfloat16;
* ``half_batch`` (training cells): the reference fed the first half of each
  batch's rows, the mean taken over them, a fault a step can have;
* ``no_carry`` (cells of an SSD model): the reference with its scan run on
  each chunk alone from a zero state, as a scan that drops its starting
  states would.

A step that returns its state unchanged reads 1 on ``change_gap`` by that
number's definition and needs no run. One JSON line per seed and reading,
with the cell's verdict on it (``correct``: every number it reads within the
limit of ``limits/<cell>.json``) and the numbers over their limits. The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def verdict(numbers: dict, limits: dict) -> dict:
    """``correct`` as a run would judge these numbers (those a reading has
    no number for are not judged), and the numbers over their limits."""
    over = {k: v for k, v in numbers.items() if k in limits and not v <= limits[k]}
    return {"correct": not over, "over": over}


def readings(job) -> dict:
    """{reading: numbers} for one seed of ``job``'s cell."""
    from perfbench import faults
    from perfbench.drivers import prefill, train
    from perfbench.reference.common import Precision

    ref = job.ref
    if job.traffic["driver"] == "train":
        judge = train.reference_steps(job)
        out = {"control": train.compare(train.reference_steps(job, "fp8"), judge),
               "half_batch": train.compare(
                   train.reference_steps(job, rows=job.traffic["batch"] // 2), judge)}
        if hasattr(ref, "ssd"):
            with faults.patched(ref, "ssd", faults.no_carry(ref.ssd)):
                out["no_carry"] = train.compare(train.reference_steps(job), judge)
        return out

    t = job.traffic
    waves = {w: None for w in range(t["sample_waves"])}
    keep = {w: None for w in range(t["cache_waves"])}

    def fp8(params, m, tokens):
        return ref.prefill(params, m, tokens, Precision("fp8"))

    def no_carry(params, m, tokens):
        with faults.patched(ref, "ssd", faults.no_carry(ref.ssd)):
            return ref.prefill(params, m, tokens, Precision("bf16"))

    stand_ins = {"control": fp8}
    if hasattr(ref, "ssd"):
        stand_ins["no_carry"] = no_carry
    return {name: prefill.reference_gaps(job, waves, keep, stand_in=fn)
            for name, fn in stand_ins.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench.lib import harness, spec

    if not torch.cuda.is_available():
        print("error: the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = spec.benchmark(ROOT)
    limits = spec.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        job = harness.make_job(bench, args.workload, seed, 0.0, False, dev, time.perf_counter())
        if job.traffic["driver"] == "train":
            from repro_torch import deterministic

            deterministic(dev)
        t0 = time.perf_counter()
        for name, nums in readings(job).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "numbers": nums, **verdict(nums, limits),
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
