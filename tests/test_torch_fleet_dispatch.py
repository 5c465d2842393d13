"""The port's mirror of ``tests/test_fleet_dispatch.py``: each of its tests
run on ``repro_torch``. The reference's docstring:

Indexed event dispatch vs the legacy poll loop — the fleet control
plane's perf rewrite, pinned by byte-identical reports.

The contract: ``legacy_dispatch=True`` runs the old poll-everything loop
(kept verbatim in the engine for same-machine A/Bs), and the indexed
dispatcher — per-job until-heap, vectorized marker candidates, NAS
epoch-cached completion prediction, dirty-set retry/regrow fan-out,
vectorized progress banking, O(1) done-count termination — must produce
the *same report bytes* on every preset and replay mix. Speed may differ;
the modelled timeline may not.

Also covers the wakeup-heap lazy-deletion semantics, the SharedBandwidth
rate-change epoch (the NAS prediction cache key), TieredStore demotions
charged through the shared arbiter, and the ``--profile`` measured section.
"""
import json

import pytest

from repro_torch.core.tce.store import SharedBandwidth, TieredStore
from repro_torch.fleet import FleetConfig, JobSpec, run_fleet, run_preset
from repro_torch.fleet.engine import (RESTORE, _FleetRun, set_force_legacy,
                                      set_profile)
from repro_torch.fleet.presets import PRESETS
from repro_torch.sim.clock import SimClock
from repro_torch.sim.replay import ReplayPreset, run_replay


def _strip(rep: dict) -> str:
    d = dict(rep)
    d.pop("measured", None)
    return json.dumps(d, sort_keys=True)


def _ab_preset(fn, *args, **kw):
    """Run the same entry point under both dispatchers; return (new, old)."""
    new = fn(*args, **kw)
    set_force_legacy(True)
    try:
        old = fn(*args, **kw)
    finally:
        set_force_legacy(False)
    return new, old


# --------------------------------------------------------------------------- #
# equivalence: every fleet preset, byte-for-byte
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_equivalence(name):
    new, old = _ab_preset(run_preset, name, 0)
    assert _strip(new) == _strip(old), \
        f"indexed dispatch diverged from legacy on preset {name!r}"


@pytest.mark.parametrize("name", ["table1_64_week", "bytedance_64_week",
                                  "table1_1k_month"])
def test_replay_equivalence(name):
    new, old = _ab_preset(run_replay, name, 0)
    assert _strip(new) == _strip(old), \
        f"indexed dispatch diverged from legacy on replay {name!r}"


@pytest.mark.slow
@pytest.mark.parametrize("name", ["bytedance_1k_month", "table1_10k_month"])
def test_replay_equivalence_large(name):
    new, old = _ab_preset(run_replay, name, 0)
    assert _strip(new) == _strip(old)


@pytest.mark.slow
def test_replay_equivalence_256_jobs_short_horizon():
    """The dense 256-job pod on the bench's shortened horizon (the full
    month point is the bench A/B; legacy there is minutes of wall time)."""
    preset = ReplayPreset("ab256", "test A/B", mix="table1",
                          scale="1k_dense", ideal_hours=40.0,
                          horizon_days=4.0)
    cfg = preset.build(0)
    from dataclasses import replace
    new = run_fleet(cfg, seed=0)
    old = run_fleet(replace(cfg, legacy_dispatch=True), seed=0)
    assert _strip(new) == _strip(old)


def test_legacy_flag_not_in_report():
    """The dispatcher choice is an implementation detail: the report must
    not mention it (else the A/B could never be byte-identical)."""
    cfg = FleetConfig(jobs=(JobSpec("j0", 2, ideal_hours=0.5),),
                      n_nodes=4, n_spares=1)
    rep = run_fleet(cfg, seed=0)
    assert "legacy" not in json.dumps(rep)


# --------------------------------------------------------------------------- #
# wakeup heap: lazy deletion by generation counter
# --------------------------------------------------------------------------- #
def _mk_run(**kw):
    cfg = FleetConfig(jobs=(JobSpec("j0", 2, ideal_hours=1.0),
                            JobSpec("j1", 2, ideal_hours=1.0)),
                      n_nodes=8, n_spares=2, **kw)
    return _FleetRun(cfg, seed=0)


def test_until_heap_stale_entries_are_skipped():
    run = _mk_run()
    job = run.jobs["j0"]
    job.state = RESTORE
    job.until = 50.0
    run._touch(job)
    # retime the same job: the old heap entry goes stale (gen mismatch)
    job.until = 30.0
    run._touch(job)
    assert len(run._until_heap) == 2          # both entries still queued...
    assert run._next_deadline(0.0) == 30.0    # ...but only the live one wins
    # retime again: both older entries are now stale tops and get peeled
    # off the heap during the next peek, leaving only the live entry
    job.until = 80.0
    run._touch(job)
    run._next_deadline(0.0)
    assert run._until_heap == [(80.0, job.idx, run._gen[job.idx])]


def test_until_heap_ignores_untimed_states():
    run = _mk_run()
    job = run.jobs["j0"]
    job.state = RESTORE
    job.until = 10.0
    run._touch(job)
    before = len(run._until_heap)
    job.state = "running"                     # RUNNING is untimed
    job.until = float("inf")
    run._touch(job)
    assert len(run._until_heap) == before     # no new entry pushed
    # and the old one is invalidated by the generation bump
    assert run._gen[job.idx] == 2


def test_touch_is_inert_under_legacy_dispatch():
    run = _mk_run(legacy_dispatch=True)
    job = run.jobs["j0"]
    job.state = RESTORE
    job.until = 10.0
    run._touch(job)
    assert not run._until_heap and run._gen[job.idx] == 0


# --------------------------------------------------------------------------- #
# NAS arbiter: rate-change epochs (the completion-prediction cache key)
# --------------------------------------------------------------------------- #
def test_shared_bandwidth_epoch_tracks_flow_set_changes():
    arb = SharedBandwidth(100e6)
    e0 = arb.epoch
    fid = arb.start(0.0, 1e9, "save")
    assert arb.epoch == e0 + 1                # start bumps
    arb.cancel(999)                           # unknown fid: no bump
    assert arb.epoch == e0 + 1
    arb.cancel(fid)
    assert arb.epoch == e0 + 2                # real cancel bumps
    fid2 = arb.start(1.0, 1e8, "restore")
    e_before = arb.epoch
    done = arb.take_completed(1e9)            # completion pops bump too
    assert [f for _t, f, _l in done] == [fid2]
    assert arb.epoch == e_before + 1
    assert arb.virtual_time > 0.0


def test_nas_prediction_cache_invalidates_on_epoch():
    run = _mk_run()
    arb = run.nas
    assert run._nas_next() is None
    arb.start(0.0, 1e9, "save")               # epoch bump -> cache miss
    t = run._nas_next()
    assert t is not None and t > 0.0
    assert run._nas_next() == t               # cached: same key, same value
    arb.start(0.0, 1e9, "save2")              # second flow halves the rate
    assert run._nas_next() > t


# --------------------------------------------------------------------------- #
# TieredStore demotions through the shared arbiter (satellite 1)
# --------------------------------------------------------------------------- #
def test_tiered_store_demotion_charges_arbiter(tmp_path):
    from repro_torch.core.tce import ModeledStore, default_tiers
    from repro_torch.recovery import TIER_NAS, TIER_SSD
    clock = SimClock()
    arb = SharedBandwidth(100e6)
    table = default_tiers(ssd_capacity_bytes=60_000)
    ssd = ModeledStore(f"{tmp_path}/ssd", tier_name=TIER_SSD,
                       bw_read=table.get(TIER_SSD).read_bw,
                       bw_write=table.get(TIER_SSD).write_bw, clock=clock)
    nas = ModeledStore(f"{tmp_path}/nas", clock=clock)
    store = TieredStore({TIER_SSD: ssd, TIER_NAS: nas}, table=table,
                        clock=clock, arbiter=arb)
    from repro_torch.core.tce import TCEConfig, TCEngine
    eng = TCEngine(TCEConfig(n_nodes=2, async_persist=False,
                             tier_table=table, mem_limit_bytes=1 << 26),
                   store, clock=clock)
    import numpy as np
    state = {"layer0/w": np.arange(16384, dtype=np.float32)}  # > ssd cap
    eng.save(100, state)
    state["layer0/w"] = state["layer0/w"] + np.float32(1.0)
    eng.save(200, state)
    eng.reconciler.quiesce(30)
    store.demote_due()
    assert store.stats["demotions"] >= 1
    # the demotion's bytes went through the shared arbiter, not for free
    assert store.stats["demotion_transfer_s"] > 0.0
    assert arb.epoch > 0
    eng.close()


def test_tiered_store_without_arbiter_has_no_transfer_stat(tmp_path):
    from repro_torch.core.tce import ModeledStore
    from repro_torch.recovery import TIER_NAS, TIER_SSD
    clock = SimClock()
    store = TieredStore(
        {TIER_SSD: ModeledStore(f"{tmp_path}/s", tier_name=TIER_SSD,
                                clock=clock),
         TIER_NAS: ModeledStore(f"{tmp_path}/n", clock=clock)}, clock=clock)
    # backwards compatible: the stats dict keeps its original shape (the
    # TCE bench embeds it in BENCH_tce.json)
    assert "demotion_transfer_s" not in store.stats


def test_demotion_contention_preset_contends():
    rep = run_preset("demotion_contention", 0)
    assert rep["demotion_contends_with_saves"] is True
    assert rep["contended_flows"]["demotion"] > rep["contended_flows"]["baseline"]
    nas = rep["fleet"]["nas"]
    assert nas["demotions"]["started"] == nas["demotions"]["drained"] > 0
    # the demotion-free baseline report carries no demotion accounting
    assert "demotions" not in rep["no_demotion"]["fleet"]["nas"]


# --------------------------------------------------------------------------- #
# --profile: volatile measured section, unchanged report body
# --------------------------------------------------------------------------- #
def test_profile_attaches_measured_without_changing_report():
    cfg = FleetConfig(jobs=(JobSpec("j0", 2, ideal_hours=0.5),),
                      n_nodes=4, n_spares=1)
    plain = run_fleet(cfg, seed=0)
    set_profile(True)
    try:
        prof = run_fleet(cfg, seed=0)
    finally:
        set_profile(False)
    m = prof.pop("measured")
    assert json.dumps(plain, sort_keys=True) == json.dumps(prof, sort_keys=True)
    assert m["dispatch"] == "indexed" and m["ticks"] > 0
    assert set(m["profile_s"]) == {"deadline_bank", "nas", "phases",
                                   "retry_regrow", "markers", "events_admit"}
    assert plain["timeline_digest"] == prof["timeline_digest"]


def test_run_preset_profile_kwarg():
    rep = run_preset("two_jobs_rack_outage", 0, profile=True)
    assert rep["measured"]["dispatch"] == "indexed"
    assert run_preset("two_jobs_rack_outage", 0).get("measured") is None
