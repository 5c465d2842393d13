"""The port's scenario catalog (``repro_torch.sim.scenarios``) against the
reference's: the same 21 names, and each scenario's report on the CPU equal
to the reference's once the volatile ``measured`` block is dropped (the
closed-loop, soak, sweep and fleet engines are the same numpy code on the
same seeds; the port's only departure, the TOL burn-ins' device, leaves no
trace in a report). The CLI takes ``--device`` and refuses a card this host
lacks.
"""
import json

import pytest

pytest.importorskip("torch")

import repro.sim.scenarios as ref_scenarios  # noqa: E402
from repro_torch import DeviceUnavailable  # noqa: E402
from repro_torch.report import strip_volatile  # noqa: E402
from repro_torch.sim import scenarios  # noqa: E402

NAMES = sorted(ref_scenarios.SCENARIOS)


def _canon(rep):
    return json.dumps(strip_volatile(rep), sort_keys=True)


def test_catalog_is_the_reference_catalog():
    assert len(NAMES) == 21
    assert sorted(scenarios.SCENARIOS) == NAMES
    assert {n: s.description for n, s in scenarios.SCENARIOS.items()} == \
        {n: s.description for n, s in ref_scenarios.SCENARIOS.items()}


@pytest.mark.parametrize("name", NAMES)
def test_scenario_report_equals_the_reference(name):
    port = scenarios.run_scenario(name, seed=0, device="cpu")
    assert port["scenario"] == name and port["one_clock"] is not False
    assert _canon(port) == _canon(ref_scenarios.run_scenario(name, seed=0))


def test_cli_runs_on_the_cpu_and_writes_json(tmp_path, capsys):
    out = tmp_path / "r.json"
    rc = scenarios.main(["--run", "storage_stall", "--device", "cpu",
                         "--json", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["scenario"] == "storage_stall" and rep["completed"]
    assert '"storage_stall"' in capsys.readouterr().out


def test_cli_defaults_to_the_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(DeviceUnavailable):
        scenarios.main(["--run", "single_node_crash"])
