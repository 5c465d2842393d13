"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, its limits and its metrics are
found by name from ``BENCHMARK.json`` (see ``perfbench/lib/spec.py``). The
system under test is the PyTorch port under ``src/``; this runs it on the
card the process is given and on nothing else: no card, or fewer than the
cell asks for, exits with code 2 and prints no result. With ``--trace 0``
the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones. Build caches stay under ``build/`` in the checkout; the
checkpoint cell's store goes under ``TMPDIR`` and is removed at exit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# whole top-level module names that may not be loaded in the process that
# prints the result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from perfbench.lib import harness, spec

    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this host has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    job = harness.make_job(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    line = harness.run_cell(bench, job)
    found = loaded_forbidden()
    if found:
        print(f"error: the process loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    harness.print_checks(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
