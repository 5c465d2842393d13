"""Training driver under fault-tolerant recovery (``repro.launch.train`` is
the reference).

    # real multi-process ranks under the TOL/planner recovery loop, with
    # scripted SIGKILLs (the fault-tolerance capstone), on the card:
    PYTHONPATH=src python -m repro_torch.launch.train --substrate process \
        --tiny --ranks 2 --spares 2 --steps 24 --ckpt-every 6 \
        --inject-kills 9:1,17:0 --json /tmp/run.json
    # the same on the CPU:
    PYTHONPATH=src python -m repro_torch.launch.train --substrate process \
        --tiny --ranks 2 --spares 2 --steps 24 --ckpt-every 6 \
        --inject-kills 9:1,17:0 --device cpu

The flags are the reference's, plus ``--device`` (default ``cuda``; without
a card the run fails before any rank starts). ``--substrate process`` hands
the run to the shared recovery driver
(:func:`repro_torch.substrate.driver.run_protected`) over a
:class:`~repro_torch.substrate.process.ProcessSubstrate`; as in the
reference, the rank workers always train the reduced arch, so ``--reduced``
changes nothing there. The ``single`` (the default, as in the reference) and
``sim`` substrates are not ported yet and exit 2 with the ROADMAP item that
brings them. Exit code follows the shared convention: 0 iff the run
completed.
"""
from __future__ import annotations

import json
import sys

from repro_torch import DeviceUnavailable
from repro_torch.cli import (EXIT_FAILURE, EXIT_OK, EXIT_USAGE, base_parser,
                             list_catalog, write_reports)

SUBSTRATES = {
    "single": "in-process training loop, local TCE checkpoints (--resume)",
    "process": "real multi-process PyTorch ranks + TOL recovery driver",
    "sim": "modelled cluster under the same recovery driver",
}

#: the ROADMAP item that brings each substrate the port lacks
NOT_PORTED = {
    "single": "it needs the TCE engine (ROADMAP queue 1, item 2)",
    "sim": "it needs SimSubstrate (ROADMAP queue 1, item 3)",
}


def build_argparser():
    ap = base_parser("python -m repro_torch.launch.train",
                     "Train a model, optionally under fault-tolerant "
                     "recovery (substrate modes: single | process | sim).")
    ap.add_argument("--substrate", default="single",
                    choices=sorted(SUBSTRATES),
                    help="where the ranks run (default: single)")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch to its reduced test size")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="shorthand for --reduced --layers 1 with a small "
                         "batch/seq (fast smoke runs)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh tempdir)")
    ap.add_argument("--codec", default="raw",
                    help="TCE persist codec (raw|zlib|int8)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the freshest checkpoint (single mode)")
    ap.add_argument("--log-every", type=int, default=10)
    # protected-mode knobs (process/sim)
    ap.add_argument("--ranks", type=int, default=2,
                    help="gang size for process/sim substrates")
    ap.add_argument("--spares", type=int, default=2,
                    help="replacement pool size for process/sim substrates")
    ap.add_argument("--inject-kills", default="", metavar="SPECS",
                    help="scripted faults 'STEP:RANK[:CATEGORY],...' "
                         "(process/sim modes)")
    ap.add_argument("--inject-stalls", default="", metavar="SPECS",
                    help="scripted stragglers 'STEP:RANK[:SECONDS],...' — "
                         "SIGSTOP/SIGCONT a live rank (process/sim modes)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks and the error checks run "
                         "(default: cuda)")
    return ap


def _apply_tiny(args) -> None:
    if args.tiny:
        args.reduced = True
        args.layers = args.layers or 1
        args.batch = min(args.batch, 2)
        args.seq = min(args.seq, 16)


def run_protected_mode(args) -> int:
    """The process substrate under the shared recovery driver."""
    from repro_torch.substrate import build_substrate
    from repro_torch.substrate.driver import (DriveConfig, KillSpec,
                                              StallSpec, run_protected)

    try:
        kills = KillSpec.parse_list(args.inject_kills)
        stalls = StallSpec.parse_list(args.inject_stalls)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE

    try:
        sub = build_substrate(
            "process", n_ranks=args.ranks, n_spares=args.spares,
            ckpt_dir=args.ckpt_dir, seed=args.seed, arch=args.arch,
            layers=args.layers or 1, batch=args.batch, seq=args.seq,
            lr=args.lr, total_steps=args.steps, codec=args.codec,
            device=args.device)
    except DeviceUnavailable as e:
        print(f"error: DeviceUnavailable: {e}", file=sys.stderr)
        return EXIT_FAILURE
    cfg = DriveConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      seed=args.seed,
                      scenario=f"train_{args.substrate}")
    try:
        rep = run_protected(sub, cfg, kills, stalls)
    finally:
        sub.close()
    shown = {k: rep[k] for k in ("engine", "scenario", "seed", "completed",
                                 "steps_done", "lost_steps", "restarts",
                                 "final_loss", "timeline_digest")}
    shown["decisions"] = rep["decisions"]["by_decision"]
    print(json.dumps(shown, indent=2, sort_keys=True))
    write_reports([rep], json_path=args.json, out_dir=args.out)
    return EXIT_OK if rep["completed"] else EXIT_FAILURE


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.list:
        return list_catalog(
            SUBSTRATES, prog="python -m repro_torch.launch.train",
            what="substrate modes",
            hint="python -m repro_torch.launch.train --substrate <name>")
    _apply_tiny(args)
    if args.substrate in NOT_PORTED:
        print(f"error: --substrate {args.substrate} is not ported yet: "
              f"{NOT_PORTED[args.substrate]}", file=sys.stderr)
        return EXIT_USAGE
    return run_protected_mode(args)


if __name__ == "__main__":
    sys.exit(main())
