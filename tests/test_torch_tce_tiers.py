"""The port's N-tier checkpoint hierarchy against the reference's tests
(``tests/test_tce_tiers.py``, case for case, but for the soak run, which
waits for the port of ``sim/soak.py``): chain-safe GC, tier failover along
planner-ranked plans, capacity-driven demotion, speculative restore
prefetch, and the planner-adaptive checkpoint cadence."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core.tce import (ChainIntegrityError, DiskStore, ModeledStore,  # noqa: E402
                                  NASStore, TCEConfig, TCEngine, TieredStore,
                                  default_tiers)
from repro_torch.core.tce.store import SimClock  # noqa: E402
from repro_torch.recovery import (CADENCE_ADAPT, SRC_BACKUP, SRC_CACHE,  # noqa: E402
                                  SRC_STORE, CadenceController, RecoveryPlanner,
                                  TIER_COLD, TIER_DEVICE, TIER_DRAM, TIER_NAS,
                                  TIER_PEER, TIER_SSD, three_leg_tiers,
                                  tiers_down_for)
from repro_torch.recovery.planner import DecisionLog  # noqa: E402

N_NODES = 4


def _mk_state(seed=7, leaves=6, rows=512):
    rng = np.random.default_rng(seed)
    return {f"layer{i}/w": rng.standard_normal((rows, 8)).astype(np.float32)
            for i in range(leaves)}


def _save_chain(eng, seed=7):
    """Two checkpoints (full then delta) made durable synchronously.
    Returns (state_at_100, state_at_200)."""
    state = _mk_state(seed)
    s100 = {k: v.copy() for k, v in state.items()}
    eng.save(100, state)
    state["layer0/w"] = state["layer0/w"] + np.float32(1.0)
    state["layer1/w"] = state["layer1/w"] * np.float32(0.5)
    s200 = {k: v.copy() for k, v in state.items()}
    eng.save(200, state)
    eng.reconciler.quiesce(30)
    return s100, s200


def _bit_exact(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


# --------------------------------------------------------------------------- #
# satellite 1 (pinned): chain-safe delete_step
# --------------------------------------------------------------------------- #
def test_delete_step_refuses_live_delta_base(tmp_path):
    """Deleting a step that is still the delta base of a live chain must
    refuse (ChainIntegrityError), not corrupt the dependent checkpoint.
    This pins the GC bug where aging out the base step left every delta
    chain through it unreadable."""
    eng = TCEngine(TCEConfig(n_nodes=N_NODES, async_persist=False,
                             mem_limit_bytes=1 << 26),
                   DiskStore(tmp_path))
    _, s200 = _save_chain(eng)
    store = eng.store
    assert store.chain_dependents(100) == [200]
    with pytest.raises(ChainIntegrityError):
        store.delete_step(100)
    # the refused delete left both steps fully readable
    for c in eng.caches:
        c.wipe()
    step, got = eng.restore()
    assert step == 200
    _bit_exact(got, s200)
    eng.close()


def test_delete_step_rematerializes_then_deletes(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=N_NODES, async_persist=False,
                             mem_limit_bytes=1 << 26),
                   DiskStore(tmp_path))
    _, s200 = _save_chain(eng)
    store = eng.store
    store.delete_step(100, rematerialize=True)
    assert not store.has_step(100)
    assert store.chain_dependents(100) == []
    assert store.stats["leaves_rematerialized"] > 0
    # the dependent chain was migrated before the base died: bit-exact
    for c in eng.caches:
        c.wipe()
    step, got = eng.restore()
    assert step == 200
    _bit_exact(got, s200)
    eng.close()


def test_delete_step_force_bypasses_guard(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=N_NODES, async_persist=False,
                             mem_limit_bytes=1 << 26),
                   DiskStore(tmp_path))
    _save_chain(eng)
    eng.store.delete_step(100, force=True)      # explicit foot-gun
    assert not eng.store.has_step(100)
    eng.close()


# --------------------------------------------------------------------------- #
# tiered store: demotion + failover
# --------------------------------------------------------------------------- #
def _tiered_engine(root, *, ssd_cap=0):
    clock = SimClock()
    table = default_tiers(ssd_capacity_bytes=ssd_cap)
    ssd = ModeledStore(f"{root}/ssd", tier_name=TIER_SSD,
                       bw_read=table.get(TIER_SSD).read_bw,
                       bw_write=table.get(TIER_SSD).write_bw, clock=clock)
    nas = ModeledStore(f"{root}/nas", clock=clock)
    store = TieredStore({TIER_SSD: ssd, TIER_NAS: nas}, table=table,
                        clock=clock)
    eng = TCEngine(TCEConfig(n_nodes=N_NODES, async_persist=False,
                             tier_table=table, mem_limit_bytes=1 << 26),
                   store, clock=clock)
    return eng, store, table, clock


def test_demotion_keeps_chains_bit_exact(tmp_path):
    """Over-capacity SSD demotes the oldest step down to NAS; the demoted
    copy is self-contained (rematerialized) and reads bit-exact."""
    eng, store, table, _clock = _tiered_engine(tmp_path, ssd_cap=60_000)
    s100, s200 = _save_chain(eng)
    assert store.stats["demotions"] >= 1
    assert store.tier_of(100) == TIER_NAS       # oldest went down a rung
    assert store.tier_of(200) == TIER_SSD       # hottest stayed high
    got = {}
    for rank in range(N_NODES):
        for path, (_spec, data) in store.read_rank(
                100, rank, tiers=frozenset({TIER_NAS})).items():
            got.setdefault(path, []).append(data)
    # per-leaf shards re-concatenate to the original step-100 state
    for path, parts in got.items():
        want = s100[path].reshape(-1)
        have = np.concatenate([p.reshape(-1) for p in parts])
        assert have.tobytes() == want.tobytes(), path
    eng.close()


@pytest.mark.parametrize("failed,plan_kw,want_tier,want_step,want_srcs", [
    # nothing failed, rollback only: hottest tier (HBM snapshot) serves
    ((), dict(inplace=True, escalated=False), TIER_DEVICE, 200,
     {"device": N_NODES}),
    # node lost: device+dram die with it -> ring backup tier. The dead
    # node also *held* its ward's backup, so exactly that one rank falls
    # through to the durable store (ring semantics, pinned here).
    (("node",), dict(inplace=False, escalated=False), TIER_PEER, 200,
     {"backup": N_NODES - 1, "store": 1}),
    # escalated double fault: volatile tiers distrusted -> rack SSD
    (("node", "escalated"), dict(inplace=False, escalated=True),
     TIER_SSD, 200, None),
    # NAS brownout during rollback: plan simply routes around the store
    (("nas",), dict(inplace=True, escalated=False), TIER_DEVICE, 200,
     {"device": N_NODES}),
    # correlated rack outage: peer ring AND rack SSD share the failure
    # domain -> the older, demoted NAS copy is the best restorable step
    (("node", "rack", "escalated"), dict(inplace=False, escalated=True),
     TIER_NAS, 100, None),
])
def test_tier_failover_matches_plan(tmp_path, failed, plan_kw, want_tier,
                                    want_step, want_srcs):
    """Fail each tier in turn: the restore source must match the planner's
    tier ranking, and the restored pytree must be bit-exact — including the
    rack case, where the restore goes through a demoted delta chain."""
    eng, store, table, _clock = _tiered_engine(tmp_path, ssd_cap=60_000)
    s100, s200 = _save_chain(eng)
    want_state = {100: s100, 200: s200}[want_step]

    down = set()
    if "node" in failed:
        down |= set(tiers_down_for(table, node_lost=True))
        eng.node_failed(0)
        eng.node_recovered(0)       # replacement joined, cache refilled
    if "rack" in failed:
        down |= set(table.correlated("rack"))
        store.fail_tier(TIER_SSD)
        for c in eng.caches:        # the rack hosted the whole gang
            c.wipe()
        eng.fabric.fail_node(1)
    if "nas" in failed:
        down.add(TIER_NAS)
        store.fail_tier(TIER_NAS)

    plan = RecoveryPlanner.choose_restore_plan(table, down=tuple(sorted(down)),
                                               **plan_kw)
    assert plan.source == want_tier
    step, got = eng.restore(plan=plan)
    assert step == want_step
    _bit_exact(got, want_state)
    srcs = {k: v for k, v in eng.stats["restore_sources"].items() if v}
    if want_srcs is not None:
        assert srcs == want_srcs
    else:
        assert set(srcs) <= {"store", "store_full"} and srcs
    eng.close()


def test_plan_wrapper_reproduces_legacy_sources():
    """choose_restore_source (the 3-leg legacy surface) must reproduce the
    historical decisions verbatim through the tier table."""
    legacy = {
        (True, False, True): SRC_CACHE,
        (False, False, True): SRC_BACKUP,
        (True, True, True): SRC_STORE,
        (False, True, True): SRC_STORE,
        (True, False, False): SRC_STORE,
        (False, False, False): SRC_STORE,
        (True, True, False): SRC_STORE,
        (False, True, False): SRC_STORE,
    }
    p = RecoveryPlanner()
    for (inp, esc, ring), want in legacy.items():
        got = p.choose_restore_source(inplace=inp, escalated=esc,
                                      has_ring_backup=ring)
        assert got == want, (inp, esc, ring)
    # and the plan over the legacy table ranks exactly the legacy 3 legs
    plan = RecoveryPlanner.choose_restore_plan(
        three_leg_tiers(), inplace=True, escalated=False)
    assert plan.tiers == (TIER_DRAM, TIER_PEER, TIER_NAS)


def test_no_eligible_tier_falls_back_to_coldest():
    table = default_tiers()
    plan = RecoveryPlanner.choose_restore_plan(
        table, inplace=False, escalated=True,
        down=(TIER_SSD, TIER_NAS))
    assert plan.tiers == (TIER_COLD,)


# --------------------------------------------------------------------------- #
# speculative restore prefetch
# --------------------------------------------------------------------------- #
def test_prefetch_overlaps_election_window(tmp_path):
    clock = SimClock()
    eng = TCEngine(TCEConfig(n_nodes=N_NODES, async_persist=False,
                             mem_limit_bytes=1 << 26),
                   NASStore(tmp_path, clock=clock), clock=clock)
    _, s200 = _save_chain(eng)
    eng.reconciler.stop()
    for c in eng.caches:
        c.wipe()
    clock.reset()
    pf = eng.prefetch_restore()
    assert pf is not None and pf.step == 200
    clock.advance(max(pf.duration_s * 2, 10.0))   # election outlasts stream
    t_mark = clock.seconds
    step, got = eng.restore(prefetch=pf)
    assert step == 200
    _bit_exact(got, s200)
    # the stream fully overlapped the election: the restore leg was free
    assert clock.seconds == t_mark
    st = eng.stats["prefetch"]
    assert st["overlap_frac"] == 1.0
    assert st["overlap_s"] == pytest.approx(pf.duration_s)
    eng.close()


def test_prefetch_residual_charged_when_election_is_short(tmp_path):
    clock = SimClock()
    eng = TCEngine(TCEConfig(n_nodes=N_NODES, async_persist=False,
                             mem_limit_bytes=1 << 26),
                   NASStore(tmp_path, clock=clock), clock=clock)
    _, s200 = _save_chain(eng)
    eng.reconciler.stop()
    for c in eng.caches:
        c.wipe()
    clock.reset()
    pf = eng.prefetch_restore()
    clock.advance(pf.duration_s / 4)              # election ends early
    t_mark = clock.seconds
    step, got = eng.restore(prefetch=pf)
    assert step == 200
    _bit_exact(got, s200)
    residual = clock.seconds - t_mark
    assert residual == pytest.approx(pf.duration_s * 3 / 4)
    assert eng.stats["prefetch"]["overlap_frac"] == pytest.approx(0.25)
    # a consumed handle is single-use
    assert pf.used
    eng.close()


def test_prefetch_none_when_store_empty(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=N_NODES, async_persist=False,
                             mem_limit_bytes=1 << 26),
                   DiskStore(tmp_path))
    assert eng.prefetch_restore() is None
    eng.close()


# --------------------------------------------------------------------------- #
# planner-adaptive cadence
# --------------------------------------------------------------------------- #
def test_cadence_tightens_and_relaxes():
    log = DecisionLog()
    c = CadenceController(1800.0, log=log)
    # calm start establishes the baseline
    for i in range(4):
        c.observe_incident(3600.0 * (i + 1), 300.0)
    assert c.interval_s == 1800.0
    # rollback costs spike (e.g. every restore now rides a slow tier)
    for i in range(4, 8):
        c.observe_incident(3600.0 * (i + 1), 1500.0)
    tightened = c.interval_s
    assert tightened < 1800.0
    assert tightened >= 1800.0 / 8          # clamped at base/8
    # costs recover: the cadence relaxes back toward the base
    for i in range(8, 16):
        c.observe_incident(3600.0 * (i + 1), 100.0)
    assert c.interval_s > tightened
    assert c.interval_s <= 1800.0
    rep = c.to_report()
    assert rep["initial_s"] == 1800.0
    assert rep["adaptions"] >= 2
    # every adaption is visible in the decision log
    entries = [e for e in log.entries if e["decision"] == CADENCE_ADAPT]
    assert len(entries) == rep["adaptions"]
    assert all(e["kind"] == "cadence" for e in entries)
