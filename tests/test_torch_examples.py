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


def _record_quiesce(monkeypatch, cls, returns: list) -> None:
    """Wrap ``cls.quiesce`` so that every call lands in ``returns`` as (its
    return value, the newest step committed when it returned): False is a
    quiesce that ran out of its wall-clock timeout."""
    quiesce = cls.quiesce

    def recorded(self, *args, **kwargs):
        ok = quiesce(self, *args, **kwargs)
        returns.append((ok, self._last_committed))
        return ok

    monkeypatch.setattr(cls, "quiesce", recorded)


def _first_difference(a, b, path="report"):
    """(path, a's value, b's value) of the first leaf where two JSON-like
    trees differ, or None."""
    if isinstance(a, dict) and isinstance(b, dict):
        for key in sorted(set(a) | set(b), key=str):
            if key not in a or key not in b:
                return f"{path}.{key}", a.get(key, "<missing>"), b.get(key, "<missing>")
            found = _first_difference(a[key], b[key], f"{path}.{key}")
            if found:
                return found
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            found = _first_difference(x, y, f"{path}[{i}]")
            if found:
                return found
        return None
    return None if a == b else (path, a, b)


def test_fault_tolerant_sim_report_equals_the_reference(monkeypatch):
    from repro.core.tce.reconciler import Reconciler as RefReconciler
    from repro_torch.core.tce.reconciler import Reconciler

    # Both SimSubstrates quiesce the reconciler (a 10 s wall-clock timeout)
    # before every restore and go on whatever it returns, then restore from
    # the newest committed step. Two quiesces of each run time out on every
    # host (a backup whose peer is down never lands), so a timeout is not a
    # fault by itself; where the reports differ, the returns and committed
    # steps show which side restored from less.
    quiesced = {"port": [], "reference": []}
    _record_quiesce(monkeypatch, Reconciler, quiesced["port"])
    _record_quiesce(monkeypatch, RefReconciler, quiesced["reference"])
    ref = _ref_example("fault_tolerant_training")
    kills = (ref.KillSpec(9, 1), ref.KillSpec(17, 0, "network"))
    want = ref.drive("sim", 24, 6, kills)
    got = _example("fault_tolerant_training").main(["--substrate", "sim", "--device", "cpu"])
    rep = got["report"]
    print(f"quiesce returns: {quiesced}")
    if _canon(rep) != _canon(want):
        a, b = (json.loads(_canon(r)) for r in (rep, want))
        where, port, reference = _first_difference(a, b)
        pytest.fail(f"reports differ first at {where}: port {port!r}, reference "
                    f"{reference!r}; quiesce (returned, newest committed step): "
                    f"{quiesced} (False: timed out)")
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
