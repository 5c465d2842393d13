"""The port's TCE engine against the reference's, and the launcher's
``--substrate single`` against the reference's ``run_single``.

* One fixed script (delta saves, a node failure and its recovery, a
  planner-constrained restore, a prefetched restore against a
  ``TieredStore``) drives both engines synchronously on the same flat state:
  the modelled clock, the stats, the restored states and the store trees are
  equal, byte for byte (the manifests but for their wall-clock ``time``).
* A delta chain that either package's engine wrote restores in the other's,
  also after its base step was deleted with ``rematerialize=True``.
* The reference's ``run_single`` writes a checkpoint; both launchers resume
  from it to the same loss (bf16 compute: within half of bf16's eps, as
  ``tests/test_torch_worker.py`` holds the workers' curves); the port's
  resume after ``delete_step`` of the last step repeats its uninterrupted run
  bit for bit; without a card and without ``--device cpu`` it writes nothing.
"""
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.tce as ref_tce  # noqa: E402
import repro.recovery as ref_recovery  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
import repro_torch.core.tce as port_tce  # noqa: E402
import repro_torch.recovery as port_recovery  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402

PACKAGES = {"reference": (ref_tce, ref_recovery), "port": (port_tce, port_recovery)}
N_NODES = 4
BF16_HALF_EPS = 2.0 ** -9


def _state(seed=7, leaves=6, rows=512):
    rng = np.random.default_rng(seed)
    s = {f"layer{i}/w": rng.standard_normal((rows, 8)).astype(np.float32)
         for i in range(leaves)}
    s["opt/adam_mu"] = rng.standard_normal((rows, 8)).astype(np.float32)
    s["step"] = np.array(3, np.int32)
    return s


def _store(tce, root, **kw):
    """A DiskStore-like store of either package; the port's (de)quantises on
    the CPU."""
    cls = kw.pop("cls", tce.DiskStore)
    if tce is port_tce:
        kw["device"] = "cpu"
    return cls(str(root), **kw)


def _tree(root: Path) -> dict:
    """Every file under root: its bytes, a manifest without its time field."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            b = p.read_bytes()
            if p.name == "manifest.json":
                m = json.loads(b)
                m.pop("time")
                b = json.dumps(m, sort_keys=True).encode()
            out[str(p.relative_to(root))] = hashlib.sha256(b).hexdigest()
    return out


def _script(name, root: Path, codec: str):
    """The same fixed script through one package's engine; returns what it
    observed at each stage."""
    tce, recovery = PACKAGES[name]
    clock = tce.store.SimClock()
    table = tce.default_tiers(ssd_capacity_bytes=60_000)
    legs = {
        recovery.TIER_SSD: _store(tce, root / "ssd", cls=tce.ModeledStore,
                                  tier_name=recovery.TIER_SSD,
                                  bw_read=table.get(recovery.TIER_SSD).read_bw,
                                  bw_write=table.get(recovery.TIER_SSD).write_bw,
                                  clock=clock),
        recovery.TIER_NAS: _store(tce, root / "nas", cls=tce.ModeledStore, clock=clock),
    }
    store = tce.TieredStore(legs, table=table, clock=clock)
    eng = tce.TCEngine(tce.TCEConfig(n_nodes=N_NODES, async_persist=False, codec=codec,
                                     tier_table=table, mem_limit_bytes=1 << 26),
                       store, clock=clock)
    seen = []

    def mark(what, out=None):
        seen.append((what, clock.seconds, json.dumps(eng.stats, sort_keys=True),
                     json.dumps(store.stats, sort_keys=True),
                     json.dumps(eng.reconciler.stats, sort_keys=True),
                     None if out is None else
                     (out[0], {k: (v.dtype.str, v.shape, v.tobytes()) for k, v in out[1].items()})))

    state = _state()
    for step, key in ((10, None), (20, "layer0/w"), (30, "layer1/w")):
        if key:
            state = dict(state, **{key: state[key] + np.float32(1.0)})
        eng.save(step, state)
        mark(f"save {step}")
    eng.node_failed(1)
    plan = recovery.RecoveryPlanner.choose_restore_plan(
        table, down=tuple(sorted(recovery.tiers_down_for(table, node_lost=True))),
        inplace=False, escalated=False)
    mark("restore with a plan", eng.restore(plan=plan))
    eng.node_recovered(1)
    mark("restore after recovery", eng.restore())
    for c in eng.caches:
        c.wipe()
    pf = eng.prefetch_restore()
    clock.advance(pf.duration_s / 4)
    mark("prefetched restore", eng.restore(prefetch=pf))
    eng.close()
    return seen, eng.reconciler.errors


@pytest.mark.parametrize("codec", ["raw", "zlib", "int8"])
def test_same_script_same_outcome(tmp_path, codec):
    """Both engines run one script: equal modelled clock and stats at every
    stage, equal restored states, byte-equal store trees. int8 runs the
    port's plain codec against the reference's Pallas kernel in interpret
    mode, which give the same bytes (tests/test_torch_tce.py)."""
    ref_seen, ref_errors = _script("reference", tmp_path / "ref", codec)
    port_seen, port_errors = _script("port", tmp_path / "port", codec)
    assert ref_errors == port_errors == []
    assert [s[0] for s in port_seen] == [s[0] for s in ref_seen]
    for got, want in zip(port_seen, ref_seen):
        assert got == want, got[0]
    assert ref_seen[-1][3] != json.dumps({"demotions": 0, "demoted_bytes": 0})  # demoted
    ref_tree, port_tree = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert len(port_tree) > 20 and port_tree == ref_tree


def _write_chain(tce, root):
    """save 10 (full) -> 20 (one leaf changed) -> 30 (another), persisted."""
    eng = tce.TCEngine(tce.TCEConfig(n_nodes=2, async_persist=False), _store(tce, root))
    states, state = {}, _state(11, rows=64)
    for step, key in ((10, None), (20, "layer0/w"), (30, "layer1/w")):
        if key:
            state = dict(state, **{key: state[key] * np.float32(0.5)})
        eng.save(step, state)
        states[step] = state
    eng.close()
    return states


@pytest.mark.parametrize("rematerialize", [False, True])
@pytest.mark.parametrize("writer, reader", [("reference", "port"), ("port", "reference")])
def test_delta_chain_restores_in_the_other_package(tmp_path, writer, reader, rematerialize):
    states = _write_chain(PACKAGES[writer][0], tmp_path)
    tce = PACKAGES[reader][0]
    store = _store(tce, tmp_path)
    assert store.chain_dependents(10) == [20, 30]
    if rematerialize:
        store.delete_step(10, rematerialize=True)
        assert store.steps() == [20, 30] and store.chain_dependents(10) == []
    eng = tce.TCEngine(tce.TCEConfig(n_nodes=2, async_persist=False), store)
    for step in (30, 20):
        got_step, got = eng.restore(step=step)
        assert got_step == step and eng.stats["restore_sources"]["store"] == 2
        assert set(got) == set(states[step])
        for k, v in states[step].items():
            assert got[k].tobytes() == v.tobytes(), (step, k)
    eng.close()


# --------------------------------------------------------------------------- #
# the launcher, --substrate single
# --------------------------------------------------------------------------- #
TINY = ["--tiny", "--steps", "20", "--ckpt-every", "10"]


def _final_loss(path: Path) -> float:
    return json.loads(path.read_text())["final_loss"]


def test_both_launchers_resume_the_reference_checkpoint_to_the_same_loss(tmp_path):
    """The reference's run_single writes its step-10 checkpoint (raw); each
    package's run_single resumes it to step 20."""
    src = tmp_path / "written"
    assert ref_train.main(TINY + ["--ckpt-dir", str(src), "--json",
                                  str(tmp_path / "written.json")]) == 0
    ref_tce.DiskStore(str(src)).delete_step(20)
    for name in ("reference", "port"):
        shutil.copytree(src, tmp_path / name)
    assert ref_train.main(TINY + ["--resume", "--ckpt-dir", str(tmp_path / "reference"),
                                  "--json", str(tmp_path / "reference.json")]) == 0
    assert port_train.main(TINY + ["--resume", "--device", "cpu", "--ckpt-dir",
                                   str(tmp_path / "port"), "--json",
                                   str(tmp_path / "port.json")]) == 0
    want = _final_loss(tmp_path / "reference.json")
    got = _final_loss(tmp_path / "port.json")
    assert np.isfinite(got) and abs(got - want) / abs(want) <= BF16_HALF_EPS, (got, want)
    # and the port's resumed run checkpointed step 20 for the reference to read
    assert port_tce.DiskStore(str(tmp_path / "port")).steps() == [10, 20]


def test_port_resume_after_deleting_the_last_step_is_bit_exact(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    args = TINY + ["--device", "cpu", "--ckpt-dir", str(ckpt)]
    assert port_train.main(args + ["--json", str(tmp_path / "a.json")]) == 0
    port_tce.DiskStore(str(ckpt)).delete_step(20)
    assert port_train.main(args + ["--resume", "--json", str(tmp_path / "b.json")]) == 0
    assert "resumed from step 10" in capsys.readouterr().out
    a, b = (json.loads((tmp_path / f).read_text()) for f in ("a.json", "b.json"))
    assert (a["engine"], a["scenario"], a["completed"]) == ("train", "single", True)
    assert b["final_loss"] == a["final_loss"]


def test_port_single_fails_on_a_lost_persist(tmp_path, monkeypatch, capsys):
    """A persist that raises in the reconciler leaves the step unpersisted;
    run_single reports it and exits 1 instead of finishing quietly."""
    def broken(self, *a, **k):
        raise OSError("disk gone")

    from repro_torch.core.tce.reconciler import Reconciler

    quiesce = Reconciler.quiesce
    monkeypatch.setattr(port_tce.DiskStore, "write_rank", broken)
    # the run waits up to 60 s for durability; the persist never comes
    monkeypatch.setattr(Reconciler, "quiesce", lambda self, timeout=30.0: quiesce(self, 0.5))
    rc = port_train.main(["--tiny", "--steps", "2", "--ckpt-every", "1", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path / "ckpt")])
    assert rc == 1
    err = capsys.readouterr().err
    assert "quiesced: False" in err and "disk gone" in err


def test_port_single_without_a_card_writes_nothing(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks a host without a card")
    ckpt = tmp_path / "ckpt"
    assert port_train.main(TINY + ["--ckpt-dir", str(ckpt)]) == 1
    assert "DeviceUnavailable" in capsys.readouterr().err
    assert not ckpt.exists()
