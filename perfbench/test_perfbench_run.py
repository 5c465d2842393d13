"""A run of each cell on the CPU at a tiny size, the harness's look for a
card skipped: the result line's schema, with and without the trace, and the
port held to the plain references (a correct run)."""
import json

import pytest

from perfbench import tiny
from perfbench.lib import spec

CELLS = list(tiny.SIZES)


def check_schema(line: dict, cell: str, trace: bool) -> None:
    keys = list(line)
    assert keys[:3] == ["correct", "attempted", "failed"] and keys[-1] == "checks"
    assert {"metrics", "device"} <= set(keys) <= {"correct", "attempted", "failed", "metrics",
                                                  "device", "breakdown", "checks"}
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev) and dev["count"] == 1
    wanted = spec.cell_metrics(spec.benchmark(), cell)["per_layer" if trace else "end_to_end"]
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(line["metrics"]) <= set(units)
    for name, v in line["metrics"].items():
        assert v["unit"] == units[name] and v["value"] == v["value"]
    if not trace:
        assert set(line["metrics"]) == set(units)
    else:
        assert {"busy_s", "window_s"} <= set(dev)
        for key in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][key]) <= 10
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_line_schema_and_a_correct_run(cell, trace):
    line = tiny.run(cell, trace)
    check_schema(line, cell, trace)
    assert line["failed"] == 0
    limits = spec.limits(cell)
    assert set(line["checks"]) == set(limits)
    assert line["correct"], line["checks"]
