"""The port's examples (``examples/torch_*.py``) on the CPU, in-process
through their ``main(argv)``, against the reference's examples:

* the anomaly demo prints what the reference demo prints, byte for byte;
* the fault-tolerant example's ``--substrate sim`` report equals the
  reference example's ``drive("sim", 24, 6, kills)`` report, ``measured``
  dropped, and its process mode (CPU ranks) survives its two SIGKILLs;
* the quickstart restores step 30 from the memory-first waterfall, byte for
  byte, and resumes to step 40;
* the serve demo generates (4, 16) tokens for each arch, the same in two runs.

``chip_smoke.py`` holds the card's runs to what these CPU runs give; its
copies of those values must be the ones pinned here. Without ``--device
cpu`` every example refuses to run on a host without a card.
"""
import importlib.util
import json
import math
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch import DeviceUnavailable  # noqa: E402
from repro_torch.report import strip_volatile  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_demo", "anomaly_detection_demo",
            "fault_tolerant_training")

#: the anomaly demo's table on the CPU (the reference demo's, line for line)
ANOMALY_TABLE = [
    "category     detected  votes                                  bad ranks (true)",
    "storage      True      lof,nprofile,log                       (6,) ((4,))",
    "network      True      lof,nprofile,cluster                   (4,) ((4,))",
    "node_hw      True      lof,nprofile,cluster                   (3,) ((3,))",
    "user_code    True      log                                    (0,) ((0,))",
    "other        True      lof,nprofile                           () ((7,))",
]
#: the quickstart's restore: every one of the 4 ranks' shards from its cache
QUICKSTART_SOURCES = {"cache": 4, "backup": 0, "store": 0, "store_full": 0}
#: the fault-tolerant example's sim run: two kills, two spares claimed
FT_SIM = {"completed": True, "steps_done": 24, "restarts": {"inplace": 0, "resched": 2},
          "by_decision": {"claim_spare": 2}}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name: str):
    return _load(ROOT / "examples" / f"torch_{name}.py", f"torch_{name}")


def _ref_example(name: str):
    return _load(ROOT / "examples" / f"{name}.py", f"ref_{name}")


def _canon(rep: dict) -> str:
    return json.dumps(strip_volatile(rep), sort_keys=True)


def test_chip_smoke_holds_the_card_to_these_values():
    smoke = _load(ROOT / "chip_smoke.py", "chip_smoke")
    assert smoke.ANOMALY_TABLE == ANOMALY_TABLE
    assert smoke.QUICKSTART_SOURCES == QUICKSTART_SOURCES
    assert smoke.FT_SIM == FT_SIM


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_a_missing_card(name):
    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(DeviceUnavailable):
        _example(name).main([])


def test_anomaly_demo_prints_the_reference_table(capsys):
    _ref_example("anomaly_detection_demo").main()
    want = capsys.readouterr().out
    got = _example("anomaly_detection_demo").main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert got["table"] == ANOMALY_TABLE
    assert want.splitlines()[-len(ANOMALY_TABLE):] == ANOMALY_TABLE


def test_fault_tolerant_sim_report_equals_the_reference():
    ref = _ref_example("fault_tolerant_training")
    kills = (ref.KillSpec(9, 1), ref.KillSpec(17, 0, "network"))
    want = ref.drive("sim", 24, 6, kills)
    got = _example("fault_tolerant_training").main(["--substrate", "sim", "--device", "cpu"])
    rep = got["report"]
    assert _canon(rep) == _canon(want)
    assert got["continuity"] is True and got["clean"]["losses"] == rep["losses"]
    assert {"completed": rep["completed"], "steps_done": rep["steps_done"],
            "restarts": rep["restarts"],
            "by_decision": rep["decisions"]["by_decision"]} == FT_SIM


@pytest.mark.slow
def test_fault_tolerant_process_mode_survives_its_kills():
    got = _example("fault_tolerant_training").main(["--device", "cpu"])
    rep = got["report"]
    assert rep["completed"] and rep["steps_done"] == 24
    assert rep["restarts"]["resched"] + rep["restarts"]["inplace"] == 2
    assert got["continuity"] is True


def test_quickstart_restores_step_30_and_resumes_to_40():
    got = _example("quickstart").main(["--device", "cpu"])
    assert got["arch"] == "llama3-8b-reduced" and got["device"] == "cpu"
    assert len(got["save_losses"]) == 3
    assert got["restored_step"] == 30
    assert got["restore_sources"] == QUICKSTART_SOURCES
    assert got["restored_bit_exact"] is True
    assert got["resumed_step"] == 40 and len(got["resumed_losses"]) == 10
    assert got["resumed_finite"] and all(math.isfinite(x) for x in got["save_losses"])


def test_serve_demo_generates_for_each_arch_and_repeats():
    demo = _example("serve_demo")
    first = demo.main(["--device", "cpu"])
    assert list(first) == list(demo.ARCHS)
    for arch, res in first.items():
        tokens = res["tokens"]
        assert (len(tokens), len(tokens[0])) == (demo.BATCH, demo.STEPS) == (4, 16), arch
    second = demo.main(["--device", "cpu"])
    assert {a: r["tokens"] for a, r in second.items()} == \
        {a: r["tokens"] for a, r in first.items()}
