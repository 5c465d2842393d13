"""Two faults of the MLA + MoE configuration's own mechanisms, read at a
cell's own size on the card beside ``control.py``'s float8 control and half
batch, for the upper end of the cell's limits:

    python3 perfbench/mla_faults.py --workload dsv2lite-train --seeds 11,12,13

* ``no_yarn``: YaRN left out: the rope dims rotated by the plain
  frequencies, the softmax scale 1 / sqrt(qk head dim);
* ``renormalised_gates``: the top-k gates renormalised to sum to 1.

Each is the plain reference (``reference/mla_moe.py``) with the fault
planted in place of one of its functions, judged against the sound
reference as ``control.py`` judges its readings. One JSON line per seed and
fault, with the cell's verdict on it. The benchmark's own runs never run
this; the CPU tests plant the same faults in the program's place.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def no_yarn(ref):
    """The reference's rope frequencies and softmax scale without YaRN."""
    from perfbench.faults import patched

    freq, scale = ref.rope_inv_freq, ref.softmax_scale
    with patched(ref, "rope_inv_freq", lambda dim, theta, rs, dev: freq(dim, theta, None, dev)), \
            patched(ref, "softmax_scale", lambda a, rs: scale(a, None)):
        yield


@contextlib.contextmanager
def renormalised_gates(ref):
    """The reference's router with its top-k gates renormalised."""
    from perfbench.faults import patched

    gates = ref.gates
    with patched(ref, "gates", lambda probs, k, norm: gates(probs, k, True)):
        yield


FAULTS = {"no_yarn": no_yarn, "renormalised_gates": renormalised_gates}


def readings(job) -> dict:
    """{fault: numbers} for one seed of ``job``'s training cell."""
    from perfbench.drivers import train

    judge = train.reference_steps(job)
    out = {}
    for name, fault in FAULTS.items():
        with fault(job.ref):
            out[name] = train.compare(train.reference_steps(job), judge)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench.control import verdict
    from perfbench.lib import harness, spec

    if not torch.cuda.is_available():
        print("error: the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = spec.benchmark(ROOT)
    limits = spec.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        job = harness.make_job(bench, args.workload, seed, 0.0, False, dev, time.perf_counter())
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
