"""The port's closed loop (``repro_torch.core.tol.orchestrator.TransomOperator``)
against the reference's: every test of ``tests/test_system.py`` and
``tests/test_elastic.py`` run on the port (the reference trains ``olmo-1b``,
which the port lacks, so its mirror trains ``mamba2-130m`` reduced in
float32), then both packages' operators on one fault schedule: a toy numpy
step, then a reduced ``mamba2-130m`` from weights exported from the
reference. Also: the initial state the port snapshots for a fault before the
first checkpoint (its train step updates the state in place), and the card
the operator asks for by default.

Tolerances: the mirrors keep the reference tests' own (rtol = atol = 1e-6 on
the final params of a recovered run against an uninterrupted one); the
JobReport fields of the two packages are equal exactly; their loss curves in
float32 agree within 1e-4 relative, as ``tests/test_torch_worker.py`` holds
the two trainers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tce import DiskStore as RefDiskStore  # noqa: E402
from repro.core.tce import TCEConfig as RefTCEConfig  # noqa: E402
from repro.core.tce import TCEngine as RefTCEngine  # noqa: E402
from repro.core.tce.engine import flatten_pytree as jax_flatten  # noqa: E402
from repro.core.tee import TEEService as RefTEEService  # noqa: E402
from repro.core.tol import ClusterSim as RefClusterSim  # noqa: E402
from repro.core.tol import JobConfig as RefJobConfig  # noqa: E402
from repro.core.tol import TransomOperator as RefOperator  # noqa: E402
from repro.core.tol import TransomServer as RefServer  # noqa: E402
from repro.core.tol.cluster import NodeState as RefNodeState  # noqa: E402
from repro.core.tol.orchestrator import SimulatedFault as RefSimulatedFault  # noqa: E402
from repro.substrate.sim import _fitted_tee as ref_fitted_tee  # noqa: E402
from repro.train import AdamConfig as JaxAdam  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import init_train_state as jax_init  # noqa: E402
from repro.train import make_train_step as jax_make_step  # noqa: E402
from repro_torch import DeviceUnavailable  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tce import DiskStore, TCEConfig, TCEngine  # noqa: E402
from repro_torch.core.tce.engine import flatten_pytree, unflatten_like  # noqa: E402
from repro_torch.core.tee import OfflineTrainer, TEEService, TraceGenerator  # noqa: E402
from repro_torch.core.tol import (ClusterSim, JobConfig, TransomOperator,  # noqa: E402
                                  TransomServer)
from repro_torch.core.tol.cluster import NodeState  # noqa: E402
from repro_torch.core.tol.orchestrator import SimulatedFault  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.substrate import build_sim_substrate  # noqa: E402
from repro_torch.substrate.sim import _fitted_tee  # noqa: E402
from repro_torch.train import AdamConfig, TrainConfig, init_train_state, make_train_step  # noqa: E402

ARCH = "mamba2-130m"
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=60, grad_clip=1.0)
#: the reference test's schedule (tests/test_system.py): step -> (category,
#: rank); chip_smoke.py runs the same faults at full size, over 30 steps
FAULTS = {13: ("node_hw", 1), 27: ("network", 2)}
CLOSED_LOOP = dict(total_steps=40, ckpt_every=5, n_sim_nodes=4)
LOSS_REL_TOL = 1e-4


@pytest.fixture(scope="module")
def tee_service():
    gen = TraceGenerator(n_ranks=4, seed=1)
    return TEEService(OfflineTrainer().fit([gen.normal() for _ in range(8)]))


def _operator(tmp_path, tee, n_nodes=4, n_spares=4):
    server = TransomServer()
    cluster = ClusterSim(n_nodes=n_nodes, n_spares=n_spares)
    tce = TCEngine(TCEConfig(n_nodes=n_nodes), DiskStore(str(tmp_path), device="cpu"))
    return TransomOperator(server, cluster, tce, tee, device="cpu"), cluster, tce


def _fault_hook(op, cluster, faults, fault_cls, node_state):
    """The reference test's hook: fail the rank's node, raise once per step."""
    fired = set()

    def hook(step):
        if step in faults and step not in fired:
            fired.add(step)
            cat, rank = faults[step]
            node = op.launchers[rank].node
            cluster.nodes[node].state = node_state.FAILED
            cluster.nodes[node].fail_category = cat
            raise fault_cls(cat, rank)
    return hook


def _mamba(compute_dtype="float32"):
    return dataclasses.replace(get_config(ARCH).reduced(), compute_dtype=compute_dtype)


# --------------------------------------------------------------------------- #
# mirrors of tests/test_system.py
# --------------------------------------------------------------------------- #
def test_closed_loop_recovers_real_lm_training(tmp_path, tee_service):
    """Reduced mamba2 trained under TRANSOM with two injected node faults; the
    final params must match an uninterrupted run (fp32)."""
    cfg = _mamba()
    opt = AdamConfig(**OPT)
    data = SyntheticLMData(cfg.vocab_size, 32, 4, seed=0)
    inner = make_train_step(cfg, opt, TrainConfig())

    def step_fn(state, step):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}
        return inner(state, batch)[0]

    op, cluster, tce = _operator(tmp_path, tee_service)
    hook = _fault_hook(op, cluster, FAULTS, SimulatedFault, NodeState)
    report, final_state = op.run_job(JobConfig(**CLOSED_LOOP),
                                     init_train_state(cfg, opt, seed=0, device="cpu"),
                                     step_fn, fault_hook=hook)
    tce.close()

    assert report.completed
    assert report.restarts_resched == 2
    assert len(report.evicted_nodes) == 2
    assert report.lost_steps <= 2 * (2 * 5)
    assert 0 < report.mean_restart_s < 15 * 60

    # ground truth: an uninterrupted run from a fresh initial state (the
    # step trains in place)
    want = init_train_state(cfg, opt, seed=0, device="cpu")
    for s in range(40):
        want = step_fn(want, s)
    got, ref = flatten_pytree(final_state.params), flatten_pytree(want.params)
    assert sorted(got) == sorted(ref)
    for path in got:
        np.testing.assert_allclose(got[path], ref[path], rtol=1e-6, atol=1e-6, err_msg=path)


def test_closed_loop_inplace_restart_when_no_bad_node(tmp_path, tee_service):
    op, cluster, tce = _operator(tmp_path, tee_service)
    fired = set()

    def fault_hook(step):
        if step == 7 and step not in fired:
            fired.add(step)
            raise SimulatedFault("user_code", 0)   # no node marked bad

    report, w = op.run_job(JobConfig(total_steps=20, ckpt_every=4, n_sim_nodes=4),
                           torch.zeros((4, 4)), lambda s, i: s + 1.0, fault_hook=fault_hook)
    tce.close()
    assert report.completed
    assert report.restarts_inplace == 1 and report.restarts_resched == 0
    assert not report.evicted_nodes
    assert float(w[0, 0]) == 20.0


def test_job_fails_cleanly_when_restart_budget_exhausted(tmp_path, tee_service):
    op, cluster, tce = _operator(tmp_path, tee_service)

    def fault_hook(step):
        raise SimulatedFault("other", 0)

    report, _ = op.run_job(
        JobConfig(total_steps=10, ckpt_every=2, n_sim_nodes=4, max_restarts=3),
        torch.zeros(()), lambda s, i: s + 1.0, fault_hook=fault_hook)
    tce.close()
    assert not report.completed
    assert report.state_history[-1][1] == "failed"


def test_checkpoint_state_roundtrip_through_tce(tmp_path):
    """TrainState (incl. int8 opt moments) survives TCE flatten/restore."""
    cfg = _mamba("bfloat16")
    state = init_train_state(cfg, AdamConfig(moment_dtype="int8"), seed=3, device="cpu")
    tce = TCEngine(TCEConfig(n_nodes=2), DiskStore(str(tmp_path), device="cpu"))
    tce.save(1, state, wait=True)
    _, flat = tce.restore()
    got = unflatten_like(state, flat)
    tce.close()
    want, back = flatten_pytree(state), flatten_pytree(got)
    assert sorted(want) == sorted(back) and any(p.endswith("/q") for p in want)
    for path in want:
        assert want[path].dtype == back[path].dtype, path
        np.testing.assert_array_equal(want[path], back[path], err_msg=path)


# --------------------------------------------------------------------------- #
# mirrors of tests/test_elastic.py
# --------------------------------------------------------------------------- #
def test_elastic_shrink_continues_training(tmp_path):
    server = TransomServer()
    cluster = ClusterSim(n_nodes=4, n_spares=0)     # no replacements available
    tce = TCEngine(TCEConfig(n_nodes=4), DiskStore(str(tmp_path), device="cpu"))
    op = TransomOperator(server, cluster, tce, tee=None, device="cpu")
    fired = set()

    def fault_hook(step):
        if step == 11 and step not in fired:
            fired.add(step)
            cluster.nodes[op.launchers[2].node].state = NodeState.FAILED
            raise SimulatedFault("node_hw", 2)

    report, w = op.run_job(
        JobConfig(total_steps=30, ckpt_every=5, n_sim_nodes=4, allow_shrink=True, min_nodes=2),
        torch.zeros(()), lambda s, i: s + 1.0, fault_hook=fault_hook)
    op.tce.close()
    assert report.completed
    assert report.shrinks == 1
    assert report.final_nodes == 3
    assert float(w) == 30.0
    step, flat = op.tce.restore()
    assert step == 30
    assert op.tce.cfg.n_nodes == 3


def test_shrink_refused_below_min_nodes(tmp_path):
    server = TransomServer()
    cluster = ClusterSim(n_nodes=2, n_spares=0)
    tce = TCEngine(TCEConfig(n_nodes=2), DiskStore(str(tmp_path), device="cpu"))
    op = TransomOperator(server, cluster, tce, tee=None, device="cpu")

    def fault_hook(step):
        if step == 5:
            cluster.nodes[op.launchers[1].node].state = NodeState.FAILED
            raise SimulatedFault("node_hw", 1)

    report, _ = op.run_job(
        JobConfig(total_steps=20, ckpt_every=5, n_sim_nodes=2, allow_shrink=True, min_nodes=2),
        torch.zeros(()), lambda s, i: s + 1.0, fault_hook=fault_hook)
    op.tce.close()
    assert not report.completed
    assert report.state_history[-1][1] == "failed"


# --------------------------------------------------------------------------- #
# the port's own departures
# --------------------------------------------------------------------------- #
def test_fault_before_the_first_checkpoint_resumes_from_the_initial_values(tmp_path):
    """The step updates its state in place; a fault before the first save
    must resume from the values the job started with, not the trained ones."""
    op, cluster, tce = _operator(tmp_path, None)
    fired = set()

    def add_in_place(s, i):
        s["w"].add_(1.0)
        return s

    def fault_hook(step):
        if step == 3 and step not in fired:
            fired.add(step)
            raise SimulatedFault("user_code", 0)

    state0 = {"w": torch.full((4,), 2.0)}
    report, w = op.run_job(JobConfig(total_steps=12, ckpt_every=5, n_sim_nodes=4),
                           state0, add_in_place, fault_hook=fault_hook)
    tce.close()
    assert report.completed and report.restarts_inplace == 1
    assert report.lost_steps == 3 and report.restore_sources == {}
    assert torch.equal(w["w"], torch.full((4,), 14.0))   # 2 + 12 steps, not 2 + 15


def test_operator_and_sim_substrate_need_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device resolves")
    tce = TCEngine(TCEConfig(n_nodes=2), DiskStore(str(tmp_path), device="cpu"))
    try:
        with pytest.raises(DeviceUnavailable):
            TransomOperator(TransomServer(), ClusterSim(n_nodes=2), tce)
    finally:
        tce.close()
    with pytest.raises(DeviceUnavailable):
        build_sim_substrate(store_root=str(tmp_path / "sim"))
    assert not (tmp_path / "sim").exists()
    sub = build_sim_substrate(store_root=str(tmp_path / "sim"), device="cpu")
    try:
        assert str(sub.device) == "cpu" and sub.clock_identity_ok()
    finally:
        sub.close()


# --------------------------------------------------------------------------- #
# both packages' closed loops on one schedule
# --------------------------------------------------------------------------- #
PACKAGES = {
    "reference": dict(server=RefServer, cluster=RefClusterSim, tce=RefTCEngine,
                      tce_cfg=RefTCEConfig, store=RefDiskStore, tee=RefTEEService,
                      fitted=ref_fitted_tee, job=RefJobConfig, op=RefOperator,
                      fault=RefSimulatedFault, node_state=RefNodeState, kw={}, store_kw={}),
    "port": dict(server=TransomServer, cluster=ClusterSim, tce=TCEngine, tce_cfg=TCEConfig,
                 store=DiskStore, tee=TEEService, fitted=_fitted_tee, job=JobConfig,
                 op=TransomOperator, fault=SimulatedFault, node_state=NodeState,
                 kw={"device": "cpu"}, store_kw={"device": "cpu"}),
}

#: name -> (n_nodes, n_spares, JobConfig kwargs, faults, with TEE)
SCHEDULES = {
    "two_node_faults": (4, 4, CLOSED_LOOP, FAULTS, True),
    "inplace": (4, 4, dict(total_steps=20, ckpt_every=4, n_sim_nodes=4),
                {7: ("user_code", None)}, True),
    "shrink": (4, 0, dict(total_steps=30, ckpt_every=5, n_sim_nodes=4, allow_shrink=True,
                          min_nodes=2), {11: ("node_hw", 2)}, False),
    "budget": (4, 4, dict(total_steps=20, ckpt_every=2, n_sim_nodes=4, max_restarts=3),
               {s: ("other", None) for s in range(20)}, True),
}


def _run_closed_loop(package, root, schedule, state0, step_fn):
    """One package's operator over ``schedule``; a fault whose rank is None
    fails no node (a transient error). Each step first waits for the
    reconciler, so no fault races a save: which interval a racing fault
    falls back to depends on thread timing, in either package."""
    n_nodes, n_spares, job, faults, with_tee = SCHEDULES[schedule]
    pk = PACKAGES[package]
    cluster = pk["cluster"](n_nodes=n_nodes, n_spares=n_spares)
    tce = pk["tce"](pk["tce_cfg"](n_nodes=n_nodes), pk["store"](str(root), **pk["store_kw"]))
    tee = pk["tee"](pk["fitted"](n_ranks=n_nodes)) if with_tee else None
    op = pk["op"](pk["server"](), cluster, tce, tee, **pk["kw"])
    fired = set()

    def hook(step):
        if step in faults and step not in fired:
            fired.add(step)
            cat, rank = faults[step]
            if rank is not None:
                node = cluster.nodes[op.launchers[rank].node]
                node.state, node.fail_category = pk["node_state"].FAILED, cat
            raise pk["fault"](cat, 0 if rank is None else rank)

    def settled_step(state, step):
        op.tce.reconciler.quiesce(10)
        return step_fn(state, step)

    try:
        report, state = op.run_job(pk["job"](**job), state0, settled_step, fault_hook=hook)
    finally:
        op.tce.close()
    return report, state


def _report_fields(r):
    return {"completed": r.completed, "steps_done": r.steps_done,
            "restarts": (r.restarts_inplace, r.restarts_resched), "shrinks": r.shrinks,
            "final_nodes": r.final_nodes, "evicted_nodes": r.evicted_nodes,
            "modeled_downtime_s": r.modeled_downtime_s,
            "modeled_restart_times": r.modeled_restart_times,
            # the clock is also advanced by the reconciler's thread: the
            # history's stamps are not deterministic, its states and reasons are
            "state_history": [(s, why) for _t, s, why in r.state_history],
            "lost_steps": r.lost_steps, "tee_verdicts": r.tee_verdicts,
            "decisions": r.decisions, "restore_sources": r.restore_sources}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_toy_closed_loop_reports_as_the_reference(schedule, tmp_path):
    """A numpy step through both operators: equal JobReport fields and final
    states. chip_smoke.py holds its card runs' ``tee_verdicts`` to the port's
    operator on this toy step; here the port's count is held to the
    reference's."""
    reports, finals = {}, {}
    for package in PACKAGES:
        reports[package], finals[package] = _run_closed_loop(
            package, tmp_path / package, schedule, np.zeros((4, 4), np.float32),
            lambda s, i: s + np.float32(1.0))
    assert _report_fields(reports["port"]) == _report_fields(reports["reference"])
    np.testing.assert_array_equal(np.asarray(finals["port"]), np.asarray(finals["reference"]))
    if schedule == "two_node_faults":
        r = reports["port"]
        assert r.completed and r.restarts_resched == 2 and r.tee_verdicts > 2


def test_mamba2_closed_loop_reports_and_trains_as_the_reference(tmp_path):
    """Reduced mamba2 in float32 from weights exported from the reference,
    through both operators on the two-fault schedule: equal JobReport fields,
    and each step's loss (replays included) within 1e-4 relative."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), compute_dtype="float32")
    pcfg = _mamba()
    jstate = jax_init(jcfg, JaxAdam(**OPT), jax.random.key(0))
    pstate = unflatten_like(init_train_state(pcfg, AdamConfig(**OPT), device="cpu"),
                            jax_flatten(jstate))
    data = SyntheticLMData(jcfg.vocab_size, 32, 4, seed=0)
    jstep = jax.jit(jax_make_step(jcfg, JaxAdam(**OPT), JaxTrainConfig()))
    pstep = make_train_step(pcfg, AdamConfig(**OPT), TrainConfig())
    losses = {"reference": [], "port": []}

    def jax_step(state, step):
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in data.batch_at(step).items()})
        losses["reference"].append((step, float(m["loss"])))
        return state

    def port_step(state, step):
        state, m = pstep(state, {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()})
        losses["port"].append((step, float(m["loss"])))
        return state

    ref, _ = _run_closed_loop("reference", tmp_path / "ref", "two_node_faults", jstate, jax_step)
    port, _ = _run_closed_loop("port", tmp_path / "port", "two_node_faults", pstate, port_step)
    assert _report_fields(port) == _report_fields(ref)
    assert port.completed and port.restarts_resched == 2
    assert [s for s, _ in losses["port"]] == [s for s, _ in losses["reference"]]
    rel = max(abs(g - w) / abs(w) for (_, g), (_, w) in zip(losses["port"], losses["reference"]))
    assert rel <= LOSS_REL_TOL
