"""The port's Substrate API and recovery driver against the reference's:
the protocol surface, kill and stall schedules, the driver's decisions on one
fault schedule (both packages' ``run_protected``, each with its own TEE, over
the same in-process fake substrate), the launcher's modelled cluster
(``--substrate sim``) against the reference's, and real torch rank processes
on the CPU (the two-SIGKILL capstone through the launcher, a rank killed
mid-save, a stalled rank named by the TEE).
"""
import json
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

import repro_torch.substrate.driver as driver  # noqa: E402
from repro.core.tol import TransomServer as RefServer  # noqa: E402
from repro.report import strip_volatile as ref_strip_volatile  # noqa: E402
from repro.sim.clock import SimClock as RefClock  # noqa: E402
from repro.sim.topology import NodeState as RefNodeState  # noqa: E402
from repro.sim.topology import Topology as RefTopology  # noqa: E402
from repro.substrate import build_substrate as ref_build_substrate  # noqa: E402
from repro.substrate.base import FaultNotice as RefFaultNotice  # noqa: E402
from repro.substrate.base import StepSlice as RefStepSlice  # noqa: E402
from repro.substrate.driver import DriveConfig as RefDriveConfig  # noqa: E402
from repro.substrate.driver import KillSpec as RefKillSpec  # noqa: E402
from repro.substrate.driver import StallSpec as RefStallSpec  # noqa: E402
from repro.substrate.driver import run_protected as ref_run_protected  # noqa: E402
from repro.core.tee import TEEService as RefTEEService  # noqa: E402
from repro.substrate.sim import _fitted_tee as ref_fitted_tee  # noqa: E402
from repro_torch.core.tee import TEEService  # noqa: E402
from repro_torch import DeviceUnavailable  # noqa: E402
from repro_torch.core.tol import TransomServer  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.report import REQUIRED_KEYS, strip_volatile, validate  # noqa: E402
from repro_torch.sim.clock import SimClock  # noqa: E402
from repro_torch.sim.topology import NodeState, Topology  # noqa: E402
from repro_torch.substrate import (FaultNotice, StepSlice, Substrate,  # noqa: E402
                                   build_substrate)
from repro_torch.substrate.driver import (DriveConfig, KillSpec, StallSpec,  # noqa: E402
                                          run_protected)
from repro_torch.substrate.process import ProcessSubstrate  # noqa: E402
from repro_torch.substrate.sim import SimSubstrate, _fitted_tee  # noqa: E402

PROC_KW = dict(n_ranks=2, n_spares=2, seed=0, total_steps=24,
               batch=2, seq=16, lr=3e-4, device="cpu")
PROC_CFG = dict(total_steps=24, ckpt_every=6, seed=0)
PROC_KILLS = (KillSpec(9, 1), KillSpec(17, 0))


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Rank workers inherit the environment: one intra-op thread each, so
    several ranks and several test workers do not oversubscribe the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# --------------------------------------------------------------------------- #
# protocol surface (mirrors tests/test_substrate.py)
# --------------------------------------------------------------------------- #
def test_process_substrate_satisfies_protocol(tmp_path):
    sub = ProcessSubstrate(ckpt_dir=str(tmp_path), device="cpu")   # spawns nothing
    try:
        assert isinstance(sub, Substrate)
        assert str(sub.device) == "cpu" and sub.procs == {}
        assert isinstance(sub.tee, TEEService)       # on by default, as the reference
    finally:
        sub.close()
    for name in ("start_ranks", "health", "kill", "stall", "save_via_tce",
                 "restore_via_tce", "prefetch_restore", "step_metrics", "close"):
        assert callable(getattr(ProcessSubstrate, name)), name


def test_build_substrate_modes(tmp_path):
    with pytest.raises(ValueError, match="unknown substrate mode"):
        build_substrate("quantum")
    sim = build_substrate("sim", store_root=str(tmp_path / "sim"), device="cpu")
    try:
        assert isinstance(sim, SimSubstrate) and isinstance(sim, Substrate)
        assert isinstance(sim.tee, TEEService) and str(sim.device) == "cpu"
        assert sim.clock_identity_ok()
    finally:
        sim.close()
    proc = ProcessSubstrate(ckpt_dir=str(tmp_path / "proc"), device="cpu", with_tee=True)
    try:
        assert isinstance(proc.tee, TEEService) and proc.procs == {}
    finally:
        proc.close()


def test_driver_has_no_isinstance_dispatch():
    import inspect
    assert "isinstance(" not in inspect.getsource(driver)


def test_kill_spec_parsing():
    assert KillSpec.parse("13:1") == KillSpec(13, 1, "node_hw")
    assert KillSpec.parse("9:0:network") == KillSpec(9, 0, "network")
    assert KillSpec.parse_list("") == ()
    assert KillSpec.parse_list("9:1, 17:0:gpu_xid") == (
        KillSpec(9, 1), KillSpec(17, 0, "gpu_xid"))
    with pytest.raises(ValueError):
        KillSpec.parse("13")
    with pytest.raises(ValueError):
        KillSpec.parse("a:b")


def test_stall_spec_parsing():
    assert StallSpec.parse("9:1") == StallSpec(9, 1, 1.5)
    assert StallSpec.parse("9:1:2.5") == StallSpec(9, 1, 2.5)
    assert StallSpec.parse_list("") == ()
    assert StallSpec.parse_list("9:1, 17:0:0.5") == (
        StallSpec(9, 1), StallSpec(17, 0, 0.5))
    with pytest.raises(ValueError):
        StallSpec.parse("9")
    with pytest.raises(ValueError):
        StallSpec.parse("9:1:2.5:x")


def test_step_slice_ok_property():
    assert StepSlice(5).ok
    assert not StepSlice(5, fault=FaultNotice(5, (1,))).ok


def test_process_substrate_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    def no_spawn(*a, **k):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr("repro_torch.substrate.process.RankProcess", no_spawn)
    with pytest.raises(DeviceUnavailable):
        ProcessSubstrate(ckpt_dir=str(tmp_path / "ckpt"))
    assert not (tmp_path / "ckpt").exists()


def test_launcher_without_a_card_fails_before_any_rank(tmp_path, monkeypatch, capsys):
    def no_spawn(*a, **k):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr("repro_torch.substrate.process.RankProcess", no_spawn)
    rc = train_cli.main(["--substrate", "process", "--tiny", "--ckpt-dir",
                         str(tmp_path / "ckpt"), "--inject-kills", "9:1,17:0"])
    assert rc == 1
    assert "DeviceUnavailable" in capsys.readouterr().err
    assert not (tmp_path / "ckpt").exists()


SIM_ARGS = ["--substrate", "sim", "--ranks", "4", "--steps", "40", "--ckpt-every", "10",
            "--inject-kills", "13:1,27:2"]


def test_launcher_sim_reports_as_the_reference(tmp_path, monkeypatch):
    """``--substrate sim`` on the CPU: exit 0 and, through strip_volatile, the
    reference launcher's report with an equal timeline digest. Each package's
    sim saves settle (the reconciler quiesces) before the run goes on: a kill
    that races a save's persist falls back one interval or not by thread
    timing, in either package. The two launchers run side by side, each
    waiting on its reconciler's bounded waits for most of its wall time."""
    from repro.launch import train as ref_cli
    from repro.substrate.sim import SimSubstrate as RefSimSubstrate

    for cls in (SimSubstrate, RefSimSubstrate):
        def settled(self, step, _save=cls.save_via_tce):
            committed = _save(self, step)
            self.tce.reconciler.quiesce(10)
            return committed
        monkeypatch.setattr(cls, "save_via_tce", settled)
    rcs = {}
    ref = threading.Thread(target=lambda: rcs.update(ref=ref_cli.main(
        SIM_ARGS + ["--ckpt-dir", str(tmp_path / "ref"), "--json", str(tmp_path / "ref.json")])))
    ref.start()
    try:
        rcs["port"] = train_cli.main(SIM_ARGS + ["--device", "cpu",
                                                 "--ckpt-dir", str(tmp_path / "port"),
                                                 "--json", str(tmp_path / "port.json")])
    finally:
        ref.join(timeout=300)
    assert rcs == {"ref": 0, "port": 0}
    port, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "ref"))
    assert validate(port) == []
    assert json.dumps(strip_volatile(port), sort_keys=True, default=str) == \
        json.dumps(ref_strip_volatile(want), sort_keys=True, default=str)
    assert port["timeline_digest"] == want["timeline_digest"]
    assert port["restarts"] == {"inplace": 0, "resched": 2} and port["tee_verdicts"] > 0


def test_launcher_sim_without_a_card_fails_before_building(tmp_path, capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("this host has a card: the default device resolves")
    rc = train_cli.main(SIM_ARGS + ["--ckpt-dir", str(tmp_path / "ckpt")])
    assert rc == 1
    assert "DeviceUnavailable" in capsys.readouterr().err
    assert not (tmp_path / "ckpt").exists()


# --------------------------------------------------------------------------- #
# driver parity: both packages' run_protected over one fake substrate
# --------------------------------------------------------------------------- #
PACKAGES = {
    "reference": (RefClock, RefTopology, RefNodeState, RefServer, RefStepSlice,
                  RefFaultNotice, RefTEEService, ref_fitted_tee),
    "port": (SimClock, Topology, NodeState, TransomServer, StepSlice, FaultNotice,
             TEEService, _fitted_tee),
}


class FakeSubstrate:
    """In-process ranks on one package's SimClock / Topology / TransomServer
    and TEE: step ``s`` has the loss of a numpy stream seeded with ``s``, a
    kill fails the rank's node and surfaces at the next slice, a stall adds
    its seconds to the rank's wall time of the next slice, a save always
    commits."""

    def __init__(self, package, n_ranks, n_spares):
        (clock, topology, self.node_state, server, self.slice, self.notice, tee,
         fitted) = PACKAGES[package]
        self.n_ranks, self.job_id, self.device = n_ranks, "job0", "cpu"
        self.tee = tee(fitted(n_ranks=n_ranks))
        self.clock, self.server = clock(), server()
        self.topology = topology(n_ranks, n_spares=n_spares, nodes_per_rack=2,
                                 clock=self.clock)
        self.dead, self.ckpts, self.step, self.stalled = {}, [], 0, {}
        self.last_rank_walls = {}

    def start_ranks(self, assignments=None):
        if self.topology.node_of_rank(0) is None and not assignments:
            for rank, node in enumerate(self.topology.assigned):
                self.topology.bind_rank(rank, node)
        for rank, node in (assignments or {}).items():
            self.topology.bind_rank(rank, node)
        self.dead = {}

    def kill(self, rank, category="node_hw"):
        node = self.topology.nodes[self.topology.node_of_rank(rank)]
        node.state, node.fail_category = self.node_state.FAILED, category
        self.dead[rank] = category

    def stall(self, rank, stall_s=1.5):
        self.stalled[rank] = self.stalled.get(rank, 0.0) + stall_s

    def step_metrics(self, upto):
        if self.dead:
            return self.slice(self.step, fault=self.notice(
                self.step, tuple(sorted(self.dead)), dict(self.dead)))
        losses = [[s, float(np.random.default_rng(s).random())]
                  for s in range(self.step + 1, upto + 1)]
        self.last_rank_walls = {r: float(upto - self.step) + self.stalled.get(r, 0.0)
                                for r in range(self.n_ranks)}
        self.stalled = {}
        self.clock.advance(float(upto - self.step))
        self.step = upto
        return self.slice(upto, {"loss": losses[-1][1]}, losses)

    def save_via_tce(self, step):
        self.ckpts.append(step)
        return True

    def prefetch_restore(self):
        return self.ckpts[-1] if self.ckpts else None

    def restore_via_tce(self):
        self.step = self.ckpts[-1] if self.ckpts else 0
        return self.step

    def close(self):
        pass


PARITY_CASES = {
    # name: (n_ranks, n_spares, DriveConfig kwargs, kills as (step, rank),
    #        stalls as (step, rank, seconds))
    "two_kills": (2, 2, dict(total_steps=24, ckpt_every=6), ((9, 1), (17, 0)), ()),
    "spares_exhausted": (4, 0, dict(total_steps=40, ckpt_every=10), ((13, 1),), ()),
    "restart_budget": (4, 4, dict(total_steps=40, ckpt_every=10, max_restarts=2),
                       tuple((5 + 2 * i, i % 2) for i in range(4)), ()),
    "stall": (4, 0, dict(total_steps=40, ckpt_every=10), (), ((13, 2, 30.0),)),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_driver_decides_as_the_reference(case):
    n_ranks, n_spares, cfg, kills, stalls = PARITY_CASES[case]
    ref = ref_run_protected(FakeSubstrate("reference", n_ranks, n_spares),
                            RefDriveConfig(scenario=case, **cfg),
                            tuple(RefKillSpec(s, r) for s, r in kills),
                            tuple(RefStallSpec(*st) for st in stalls))
    port = run_protected(FakeSubstrate("port", n_ranks, n_spares),
                         DriveConfig(scenario=case, **cfg),
                         tuple(KillSpec(s, r) for s, r in kills),
                         tuple(StallSpec(*st) for st in stalls))
    assert validate(port) == [] and all(k in port for k in REQUIRED_KEYS)
    assert json.dumps(strip_volatile(port), sort_keys=True, default=str) == \
        json.dumps(ref_strip_volatile(ref), sort_keys=True, default=str)
    assert port["timeline_digest"] == ref["timeline_digest"]
    # each case reaches the outcome it is named for
    outcome = {"two_kills": (True, {"claim_spare": 2}),
               "spares_exhausted": (False, {"give_up": 1}),
               "restart_budget": (False, {"claim_spare": 2}),
               "stall": (True, {})}[case]
    assert (port["completed"], port["decisions"]["by_decision"]) == outcome
    # each recovery scored its dead ranks with the streaming TEE; the stall
    # was attributed
    assert port["tee_verdicts"] >= max(sum(port["restarts"].values()) + len(stalls), 1)
    att = port["measured"].get("stall_attribution", [])
    assert att == ref["measured"].get("stall_attribution", [])
    if stalls:
        assert [(a["slowest_rank"], a["anomalous"], 2 in a["attributed_ranks"])
                for a in att] == [(2, True, True)]


# --------------------------------------------------------------------------- #
# real torch rank processes on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kills", [
    # the capstone; over 60 s in the tier-1 run, so its one-kill variant
    # stands for it there
    pytest.param(PROC_KILLS, marks=pytest.mark.slow, id="9:1,17:0"),
    pytest.param(PROC_KILLS[:1], id="9:1")])
def test_capstone_sigkills_replay_the_clean_curve(kills, tmp_path, one_thread_ranks):
    # the fault run goes through the launcher a user calls: its --tiny flags
    # are PROC_KW, and its DriveConfig is PROC_CFG
    report = tmp_path / "faulty.json"
    rc = train_cli.main(["--substrate", "process", "--tiny", "--ranks", "2", "--spares", "2",
                         "--steps", "24", "--ckpt-every", "6",
                         "--inject-kills", ",".join(f"{k.step}:{k.rank}" for k in kills),
                         "--device", "cpu", "--ckpt-dir", str(tmp_path / "faulty"),
                         "--json", str(report)])
    assert rc == 0
    faulty = json.loads(report.read_text())
    sub = build_substrate("process", ckpt_dir=str(tmp_path / "clean"), **PROC_KW)
    try:
        clean = run_protected(sub, DriveConfig(scenario="clean", **PROC_CFG))
    finally:
        sub.close()
    assert faulty["completed"] and clean["completed"]
    assert faulty["restarts"] == {"inplace": 0, "resched": len(kills)}
    assert faulty["decisions"]["by_decision"] == {"claim_spare": len(kills)}
    assert [e[0] for e in faulty["losses"]] == list(range(1, 25))
    assert faulty["losses"] == clean["losses"]           # bit for bit
    assert faulty["final_loss"] == clean["final_loss"]
    assert faulty["lost_steps"] > 0 and clean["lost_steps"] == 0
    # the same schedule on the reference's modelled cluster decides the same
    ref_sub = ref_build_substrate("sim", n_nodes=4, n_spares=4)
    try:
        sim = ref_run_protected(ref_sub, RefDriveConfig(scenario="eq", **PROC_CFG),
                                tuple(RefKillSpec(k.step, k.rank) for k in kills))
    finally:
        ref_sub.close()
    assert [e["decision"] for e in faulty["decisions"]["log"]] == \
        [e["decision"] for e in sim["decisions"]["log"]] == ["claim_spare"] * len(kills)
    assert faulty["restarts"] == sim["restarts"]
    assert [s for _, s, _ in faulty["state_history"]] == \
        [s for _, s, _ in sim["state_history"]]


def test_process_killed_mid_save_never_torn(tmp_path, one_thread_ranks):
    sub = ProcessSubstrate(**dict(PROC_KW, ckpt_dir=str(tmp_path)))
    try:
        sub.start_ranks()
        assert sub.step_metrics(6).ok
        assert sub.save_via_tce(6)
        assert sub.store.latest_step() == 6
        # rank 0 SIGKILLs itself after its shard write but before the
        # controller can see all acks: the manifest must never commit
        sub.schedule_save_death(0, 12, "after_write")
        assert sub.step_metrics(12).ok
        assert not sub.save_via_tce(12)
        assert sub.store.latest_step() == 6      # torn step invisible
        # recovery: respawn the dead rank, restore, replay
        sl = sub.step_metrics(12)
        assert not sl.ok and sl.fault.dead_ranks == (0,)
        sub.start_ranks()
        assert sub.restore_via_tce() == 6
        assert sub.step_metrics(12).ok
        # bit-exact restore: replicated ranks agree leaf for leaf
        digs = sub.digests()
        assert len(digs) == 2 and digs[0] == digs[1]
        # and the retried save of the same step commits cleanly
        assert sub.save_via_tce(12)
        assert sub.store.latest_step() == 12
        assert [s["device"] for s in sub.spawn_log] == ["cpu"] * 3
    finally:
        sub.close()


def test_process_stall_completes_and_names_the_slow_rank(tmp_path, one_thread_ranks):
    sub = ProcessSubstrate(**dict(PROC_KW, ckpt_dir=str(tmp_path)))
    walls = {}
    step_metrics = sub.step_metrics

    def recording(upto):
        sl = step_metrics(upto)
        walls[upto] = dict(sub.last_rank_walls)
        return sl

    sub.step_metrics = recording
    try:
        rep = run_protected(sub, DriveConfig(scenario="stall", **PROC_CFG),
                            stalls=(StallSpec(9, 1, 1.0),))
    finally:
        sub.close()
    assert rep["completed"]
    assert rep["restarts"] == {"inplace": 0, "resched": 0}
    assert rep["stalls"] == [{"step": 9, "rank": 1, "seconds": 1.0}]
    # the slice from the stall to the next checkpoint is 9 -> 12
    assert sorted(walls) == [6, 9, 12, 18, 24]
    slow = walls[12]
    assert max(slow, key=slow.get) == 1 and slow[1] >= 1.0 > slow[0]


@pytest.mark.slow
def test_process_stall_injection_attributes_slow_rank(tmp_path, one_thread_ranks):
    """Four ranks (slow-rank attribution is consensus-based and needs a
    healthy majority), rank 1 SIGSTOPped for 2 s: no restart, and the TEE
    names it (tests/test_substrate.py's own checks)."""
    sub = ProcessSubstrate(**dict(PROC_KW, n_ranks=4, n_spares=0, ckpt_dir=str(tmp_path)))
    try:
        rep = run_protected(sub, DriveConfig(scenario="stall_proc", **PROC_CFG),
                            stalls=(StallSpec(9, 1, 2.0),))
    finally:
        sub.close()
    assert rep["completed"]
    assert rep["restarts"] == {"inplace": 0, "resched": 0}
    assert rep["stalls"] == [{"step": 9, "rank": 1, "seconds": 2.0}]
    att = rep["measured"]["stall_attribution"]
    assert len(att) == 1 and att[0]["stalled_ranks"] == [1]
    assert att[0]["slowest_rank"] == 1
    assert att[0]["slowdown"] > 1.3
    assert att[0]["anomalous"]
    assert 1 in att[0]["attributed_ranks"]
    assert 0.0 < att[0]["confidence"] <= 1.0


@pytest.mark.slow
def test_same_fault_sequence_same_decisions_on_both_substrates(tmp_path, one_thread_ranks):
    """The port's modelled cluster and its real ranks decide alike on one
    schedule (tests/test_substrate.py's invariant, within the port)."""
    sim_sub = build_substrate("sim", n_nodes=4, n_spares=4, device="cpu",
                              store_root=str(tmp_path / "sim"))
    try:
        sim = run_protected(sim_sub, DriveConfig(scenario="eq", **PROC_CFG), PROC_KILLS)
    finally:
        sim_sub.close()
    proc_sub = build_substrate("process", ckpt_dir=str(tmp_path / "proc"), **PROC_KW)
    try:
        proc = run_protected(proc_sub, DriveConfig(scenario="eq", **PROC_CFG), PROC_KILLS)
    finally:
        proc_sub.close()
    assert [e["decision"] for e in sim["decisions"]["log"]] == \
        [e["decision"] for e in proc["decisions"]["log"]] == ["claim_spare", "claim_spare"]
    assert sim["restarts"] == proc["restarts"]
    assert [s for _, s, _ in sim["state_history"]] == [s for _, s, _ in proc["state_history"]]
    assert proc["tee_verdicts"] > 0
