"""CLI for the fleet control plane.

    python -m repro.fleet --list
    python -m repro.fleet --run two_jobs_rack_outage --seed 0
    python -m repro.fleet --run all --json reports.json

Flags and exit codes follow the shared convention in :mod:`repro.cli`.
Reports are byte-identical across runs at the same seed (the CI determinism
gate diffs two invocations).
"""
from __future__ import annotations

import sys
from typing import List, Optional

from repro_torch.cli import catalog_main

from .presets import PRESETS, run_preset


def main(argv: Optional[List[str]] = None) -> int:
    return catalog_main(
        argv, prog="python -m repro_torch.fleet",
        description="Run multi-job fleet scenarios (shared topology, shared "
                    "spare pool, contended NAS bandwidth).",
        catalog={n: p.description for n, p in PRESETS.items()},
        run=run_preset, what="fleet presets",
        add_args=lambda ap: ap.add_argument(
            "--profile", action="store_true",
            help="attach a measured wall-time / dispatcher phase breakdown "
                 "to each report (volatile: excluded from digests)"),
        run_kwargs=lambda args: {"profile": args.profile})


if __name__ == "__main__":
    sys.exit(main())
