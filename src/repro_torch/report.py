"""One report schema for every engine.

Every engine in this repo — the closed-loop scenario runner, the soak
engine, the fleet control plane, the replay frontend and the substrate
driver — emits a JSON report. Historically each hand-rolled its own dict;
consumers (``scripts/bench_gate.py``, the ``scripts/ci.sh`` double-run
determinism diffs, tests) had to know three shapes. This module is the one
shape they all share:

* ``schema_version`` — bumped when the shared keys change meaning;
* ``engine``         — which engine produced the report
                       (``scenario`` / ``soak`` / ``fleet`` / ``substrate``);
* ``scenario``       — the named preset/run this report describes;
* ``seed``           — the RNG seed the run was keyed on;
* ``decisions``      — the shared :class:`repro.recovery.RecoveryPlanner`
                       decision log (normalised to ``{"n": 0, "log": []}``
                       when an engine made no recovery decisions);
* ``timeline_digest``— a short content digest over the *deterministic*
                       part of the report (everything except volatile
                       wall-clock sections), so two runs at the same seed
                       can be compared by one string.

Engine-specific payload keys ride alongside; the schema constrains the
shared spine, not the payload. Wall-clock measurements MUST live under the
``measured`` key — that subtree is excluded from the digest and from the
CI determinism diffs.

Exit-code convention for the CLIs that print these reports is documented
in :mod:`repro.cli`.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

#: top-level keys that hold host-dependent measurements (wall-clock times,
#: pids, paths); excluded from the digest and from determinism diffs
VOLATILE_KEYS = ("measured",)

#: the shared spine every finalized report carries
REQUIRED_KEYS = ("schema_version", "engine", "scenario", "seed",
                 "decisions", "timeline_digest")


def strip_volatile(report: Dict[str, Any]) -> Dict[str, Any]:
    """The deterministic part of a report: volatile sections and the digest
    itself removed (the digest is *over* this dict, so it can't contain
    it)."""
    return {k: v for k, v in report.items()
            if k not in VOLATILE_KEYS and k != "timeline_digest"}


def timeline_digest(report: Dict[str, Any]) -> str:
    """Short stable digest of the deterministic report content."""
    canon = json.dumps(strip_volatile(report), sort_keys=True,
                       separators=(",", ":"), default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def finalize(report: Dict[str, Any], *, engine: Optional[str] = None,
             scenario: Optional[str] = None,
             seed: Optional[int] = None) -> Dict[str, Any]:
    """Stamp the shared spine onto an engine report (idempotent).

    Explicit arguments win over pre-existing keys; ``decisions`` is
    normalised to an empty planner log when the engine recorded none. The
    digest is computed last, over the deterministic content.
    """
    out = dict(report)
    out["schema_version"] = SCHEMA_VERSION
    if engine is not None:
        out["engine"] = engine
    out.setdefault("engine", "scenario")
    if scenario is not None:
        out["scenario"] = scenario
    out.setdefault("scenario", out["engine"])
    if seed is not None:
        out["seed"] = seed
    out.setdefault("seed", 0)
    out.setdefault("decisions", {"n": 0, "log": []})
    out["timeline_digest"] = timeline_digest(out)
    return out


def validate(report: Dict[str, Any]) -> List[str]:
    """Schema check: returns a list of problems (empty = conformant)."""
    problems: List[str] = []
    for key in REQUIRED_KEYS:
        if key not in report:
            problems.append(f"missing required key {key!r}")
    if report.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"schema_version {report.get('schema_version')!r} "
                        f"!= {SCHEMA_VERSION}")
    dec = report.get("decisions")
    if dec is not None and not (isinstance(dec, dict)
                                and "n" in dec and "log" in dec):
        problems.append("decisions is not a planner log ({'n', 'log'} dict)")
    if "timeline_digest" in report \
            and report["timeline_digest"] != timeline_digest(report):
        problems.append("timeline_digest does not match report content")
    return problems
