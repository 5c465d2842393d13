"""The port's TOL control plane and its fleet simulation
(``repro_torch.core.tol``) against the reference's: every test of
``tests/test_tol.py`` run on the port, then ``SimJob`` / ``compare`` of both
packages on the same seeds.

Tolerances: the mirrors keep the reference tests' own bounds; the
cross-package check is exact (the same numpy code on the same seed).
"""
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")


from repro.core.tol.simulate import SimJob as RefSimJob  # noqa: E402
from repro.core.tol.simulate import compare as ref_compare  # noqa: E402
from repro_torch.core.tol import (ClusterSim, FaultInjector, JobState,  # noqa: E402
                                  LauncherFSM, TransomServer)
from repro_torch.core.tol.cluster import NodeState  # noqa: E402
from repro_torch.core.tol.fsm import TransitionError, _TRANSITIONS  # noqa: E402
from repro_torch.core.tol.simulate import SimJob, compare  # noqa: E402


# --------------------------------------------------------------------------- #
# FSM
# --------------------------------------------------------------------------- #
def test_fsm_happy_path():
    f = LauncherFSM()
    f.to(JobState.WARMUP)
    f.to(JobState.RUNNING)
    f.to(JobState.CHECKING, "anomaly")
    f.to(JobState.RESCHEDULING, "bad node")
    f.to(JobState.WARMUP)
    f.to(JobState.RUNNING)
    f.to(JobState.DONE)
    assert f.terminal and f.restarts() == 1


def test_fsm_rejects_illegal_transitions():
    f = LauncherFSM()
    with pytest.raises(TransitionError):
        f.to(JobState.RUNNING)          # must warm up first
    f.to(JobState.WARMUP)
    f.to(JobState.RUNNING)
    with pytest.raises(TransitionError):
        f.to(JobState.RESCHEDULING)     # must pass through CHECKING


@given(st.lists(st.sampled_from(list(JobState)), min_size=1, max_size=12))
@settings(max_examples=60, deadline=None)
def test_fsm_never_reaches_invalid_state(path):
    """Property: after any event sequence (legal ones applied, illegal ones
    rejected), the FSM state is always a declared state with legal history."""
    f = LauncherFSM()
    for s in path:
        try:
            f.to(s)
        except TransitionError:
            pass
    # every consecutive pair in history must be a legal edge
    states = [h[1] for h in f.history]
    for a, b in zip(states, states[1:]):
        assert b in _TRANSITIONS[a]


# --------------------------------------------------------------------------- #
# lease server
# --------------------------------------------------------------------------- #
def test_leader_election_single_winner():
    srv = TransomServer(lease_ttl=100)
    l0 = srv.acquire("m", 0)
    l1 = srv.acquire("m", 1)
    assert l0 is not None and l1 is None
    assert srv.holder("m") == 0


def test_lease_renewal_and_expiry():
    t = [0.0]
    srv = TransomServer(lease_ttl=5, now=lambda: t[0])
    srv.acquire("m", 0)
    t[0] = 4.0
    assert srv.acquire("m", 0) is not None     # renewed
    t[0] = 20.0
    l1 = srv.acquire("m", 1)                   # expired -> new holder
    assert l1 is not None and srv.holder("m") == 1


def test_stateless_server_restart_preserves_leadership():
    srv = TransomServer(lease_ttl=100)
    lease = srv.acquire("m", 0)
    srv.restart()                              # in-memory map wiped
    # holder re-sends with its carried lease: re-adopted, no re-election
    again = srv.acquire("m", 0, prev=lease)
    assert again is not None and again.token == lease.token
    assert srv.acquire("m", 1) is None


def test_bad_node_registry():
    srv = TransomServer()
    srv.report_bad_node("node0003")
    assert "node0003" in srv.bad_nodes()


# --------------------------------------------------------------------------- #
# cluster scheduling
# --------------------------------------------------------------------------- #
def test_evict_and_antiaffinity_replacement():
    c = ClusterSim(n_nodes=4, n_spares=2)
    c.evict("node0001", t=0.0)
    assert c.nodes["node0001"].state == NodeState.CORDONED
    new = c.schedule_replacement(anti_affinity={"node0001"})
    assert new is not None and new != "node0001"
    assert new in c.assigned


def test_replacement_exhaustion():
    c = ClusterSim(n_nodes=2, n_spares=0)
    c.evict("node0000", t=0.0)
    c.evict("node0001", t=0.0)
    assert c.schedule_replacement(set()) is None


def test_fault_injector_category_mix():
    evs = FaultInjector(64, mean_days_between_node_faults=20,
                        horizon_days=200, seed=1).schedule()
    assert len(evs) > 100
    cats = {e.category for e in evs}
    assert cats == {"storage", "network", "node_hw", "user_code", "other"}
    assert all(evs[i].t <= evs[i + 1].t for i in range(len(evs) - 1))


# --------------------------------------------------------------------------- #
# end-to-end simulation (Fig. 6)
# --------------------------------------------------------------------------- #
def test_simulation_transom_beats_baseline():
    res = compare(SimJob(seed=3))
    b, t = res["baseline"], res["transom"]
    assert t.end_to_end_days < b.end_to_end_days
    improvement = 1 - t.end_to_end_days / b.end_to_end_days
    assert 0.15 < improvement < 0.45          # paper: 28%
    assert t.effective_frac > 0.90            # paper: > 90%
    assert t.mean_restart_s < 15 * 60         # paper: ~12 min
    assert b.mean_restart_s > 60 * 60
    assert t.lost_compute_days >= 0 and b.lost_compute_days >= 0


@pytest.mark.parametrize("seed", [0, 3])
def test_simulation_matches_the_reference(seed):
    got, want = compare(SimJob(seed=seed)), ref_compare(RefSimJob(seed=seed))
    assert sorted(got) == sorted(want)
    for mode in got:
        assert vars(got[mode]) == vars(want[mode]), mode
