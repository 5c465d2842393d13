"""Everything the harness finds by name: a cell of ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``), the driver
that traffic names (``drivers/<driver>.py``), the configuration's plain
reference (``reference/<module>.py``), the cell's correctness limits
(``limits/<cell>.json``) and the reader of each per-layer metric
(``metrics/<metric>.py``, or one for every metric of a stem). A later cell, mix, configuration or metric is new
files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class SpecError(RuntimeError):
    """A name in BENCHMARK.json that has no file, or a file that is malformed."""


def _json(path: Path) -> Any:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"missing {path.relative_to(ROOT)}") from None


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    """The configuration file of ``name``, as BENCHMARK.json points to it."""
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise SpecError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return _json(BENCH_DIR / "limits" / f"{cell_name}.json")


def _reports(metric: dict, cell_name: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell_metrics(bench: dict, cell_name: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics ``cell_name`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, cell_name, names)]
    return {"end_to_end": e2e, "per_layer": per_layer}


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def reference(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")


def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or where there
    is none, ``metrics/<stem>.py`` for the name's part before its first dot,
    so that one reader serves ``idle_pct.train`` and ``idle_pct.prefill``.
    A name may hold dots, so the module is loaded by path; its ``read(ctx)``
    returns a number, or None where the run has nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise SpecError(f"no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
