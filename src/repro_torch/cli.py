"""Shared CLI conventions for every ``python -m repro.*`` entrypoint.

One argparse parent, one flag vocabulary, one exit-code convention — the
scenario catalog (``repro.sim.scenarios``), the fleet control plane
(``repro.fleet``), the trace-replay frontend (``repro.sim.replay``), the
policy sweep (``repro.sim.sweep``) and the training driver
(``repro.launch.train``) all build their parsers through here.

Flags (every surface):

* ``--seed N``    — RNG seed for the run (default 0).
* ``--json PATH`` — write the machine-readable report(s) to PATH as one
                    JSON document (a single report, or a list when a run
                    produced several).
* ``--out DIR``   — write one ``<name>.json`` per report into DIR
                    (created if missing). ``--json`` and ``--out`` compose.
* ``--list``      — list what this surface can run, then exit 0.

Exit codes (every surface):

* ``0`` — success.
* ``1`` — runtime failure: a job did not complete, a gate failed.
* ``2`` — usage error: unknown scenario/preset/grid name, bad flags
          (argparse's own convention).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

EXIT_OK = 0
EXIT_FAILURE = 1
EXIT_USAGE = 2


def base_parser(prog: str, description: str) -> argparse.ArgumentParser:
    """An ArgumentParser pre-loaded with the shared flag vocabulary."""
    ap = argparse.ArgumentParser(
        prog=prog, description=description,
        epilog="Exit codes: 0 success, 1 runtime failure, "
               "2 usage error (see repro/cli.py).")
    ap.add_argument("--seed", type=int, default=0,
                    help="RNG seed (default 0)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the report(s) to PATH as one JSON document")
    ap.add_argument("--out", metavar="DIR",
                    help="write one <name>.json per report into DIR")
    ap.add_argument("--list", action="store_true",
                    help="list available runs and exit")
    return ap


def write_reports(reports: List[Dict[str, Any]], *,
                  json_path: Optional[str] = None,
                  out_dir: Optional[str] = None,
                  name_key: str = "scenario") -> None:
    """Emit reports per the shared ``--json`` / ``--out`` semantics."""
    if json_path:
        with open(json_path, "w") as f:
            json.dump(reports if len(reports) > 1 else reports[0], f,
                      indent=2, sort_keys=True)
            f.write("\n")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for i, rep in enumerate(reports):
            name = str(rep.get(name_key) or rep.get("engine") or f"report{i}")
            with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                json.dump(rep, f, indent=2, sort_keys=True)
                f.write("\n")


def list_catalog(catalog: Dict[str, str], *, prog: str,
                 what: str = "scenarios",
                 hint: Optional[str] = None) -> int:
    """Render a name->description catalog the way every surface does."""
    width = max(len(n) for n in catalog)
    for name in sorted(catalog):
        print(f"  {name:<{width}}  {catalog[name]}")
    print(f"\n{len(catalog)} {what}. "
          f"Run one with: {hint or f'{prog} --run <name>'}")
    return EXIT_OK


def catalog_main(argv: Optional[List[str]], *, prog: str, description: str,
                 catalog: Dict[str, str],
                 run: Callable[..., Dict[str, Any]],
                 what: str = "scenarios",
                 add_args: Optional[Callable[[argparse.ArgumentParser],
                                             None]] = None,
                 run_kwargs: Optional[Callable[[argparse.Namespace],
                                               Dict[str, Any]]] = None,
                 summarize: Optional[Callable[[Dict[str, Any]],
                                              Dict[str, Any]]] = None) -> int:
    """The shared ``--list / --run NAME|all`` driver behind the catalog CLIs.

    ``catalog`` maps name -> description; ``run(name, seed=..., **kw)``
    produces one report. ``add_args`` lets a surface register extra flags and
    ``run_kwargs`` maps the parsed namespace to extra ``run`` kwargs.
    ``summarize`` shrinks what is *printed* per report (the full report still
    goes to ``--json``/``--out``).
    """
    ap = base_parser(prog, description)
    ap.add_argument("--run", metavar="NAME", help=f"name, or 'all'")
    if add_args is not None:
        add_args(ap)
    args = ap.parse_args(argv)

    if args.list or not args.run:
        return list_catalog(catalog, prog=prog, what=what)

    if args.run != "all" and args.run not in catalog:
        print(f"error: unknown {what.rstrip('s')} {args.run!r} (see --list)",
              file=sys.stderr)
        return EXIT_USAGE
    names = sorted(catalog) if args.run == "all" else [args.run]
    extra = run_kwargs(args) if run_kwargs is not None else {}
    reports = []
    for name in names:
        rep = run(name, seed=args.seed, **extra)
        reports.append(rep)
        shown = summarize(rep) if summarize is not None else rep
        print(json.dumps(shown, indent=2, sort_keys=True))
    write_reports(reports, json_path=args.json, out_dir=args.out)
    return EXIT_OK
