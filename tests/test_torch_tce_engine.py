"""The port's TCE engine against the reference's unit and property tests
(``tests/test_tce.py``, case for case): arena, fastcopy, shard layout, store,
cache, engine failure modes, theory model."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.core.tce import (DiskStore, EvictionConfig, NASStore,  # noqa: E402
                                  TCEConfig, TCEngine, reshard, shard_state,
                                  unshard_state)
from repro_torch.core.tce.arena import Arena, ArenaError  # noqa: E402
from repro_torch.core.tce.cache import CacheServer  # noqa: E402
from repro_torch.core.tce.fastcopy import chunked_copy  # noqa: E402
from repro_torch.core.tce.model import TheoryParams, tce_theory  # noqa: E402
from repro_torch.core.tce.store import SimClock  # noqa: E402


# --------------------------------------------------------------------------- #
# arena + fastcopy
# --------------------------------------------------------------------------- #
def test_arena_capacity_and_free():
    a = Arena(1 << 16)
    sid = a.alloc(1000)
    assert a.used == 4096  # page-rounded
    a.free_slab(sid)
    assert a.used == 0
    with pytest.raises(ArenaError):
        a.alloc(1 << 17)


def test_arena_store_roundtrip():
    a = Arena(1 << 20)
    x = np.random.randn(123, 7).astype(np.float32)
    sid = a.store(x)
    got = a.view(sid, x.nbytes).view(np.float32).reshape(x.shape)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("n,threads,chunk", [(100, 1, 64), (10_000, 4, 1024),
                                             (1 << 20, 4, 1 << 16), (3, 2, 8)])
def test_chunked_copy_exact(n, threads, chunk):
    src = np.random.randint(0, 255, n, dtype=np.uint8)
    dst = np.zeros(n, np.uint8)
    stats = chunked_copy(dst, src, n_threads=threads, chunk=chunk)
    np.testing.assert_array_equal(dst, src)
    assert stats.nbytes == n


# --------------------------------------------------------------------------- #
# shard layout properties
# --------------------------------------------------------------------------- #
@st.composite
def state_dicts(draw):
    n_leaves = draw(st.integers(1, 6))
    out = {}
    for i in range(n_leaves):
        ndim = draw(st.integers(0, 3))
        shape = tuple(draw(st.integers(1, 12)) for _ in range(ndim))
        out[f"leaf{i}/{draw(st.integers(0, 99))}"] = np.arange(
            int(np.prod(shape, dtype=np.int64)), dtype=np.float32).reshape(shape) + i
    return out


@given(state=state_dicts(), n_nodes=st.integers(1, 7))
@settings(max_examples=40, deadline=None)
def test_shard_unshard_roundtrip(state, n_nodes):
    per_node = shard_state(state, n_nodes)
    got = unshard_state(per_node)
    assert set(got) == set(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])


@given(state=state_dicts(), n1=st.integers(1, 6), n2=st.integers(1, 6))
@settings(max_examples=25, deadline=None)
def test_reshard_preserves_state(state, n1, n2):
    got = unshard_state(reshard(shard_state(state, n1), n2))
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])


def test_unshard_detects_missing_shard():
    state = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    per_node = shard_state(state, 4)
    per_node[2] = None
    with pytest.raises(ValueError):
        unshard_state(per_node)


# --------------------------------------------------------------------------- #
# store
# --------------------------------------------------------------------------- #
def test_store_atomic_commit(tmp_path):
    store = DiskStore(str(tmp_path))
    state = {"w": np.ones((8, 4), np.float32)}
    per_node = shard_state(state, 2)
    store.write_rank(5, 0, per_node[0])
    # no manifest yet -> checkpoint invisible
    assert store.latest_step() is None
    store.write_rank(5, 1, per_node[1])
    store.commit(5, 2)
    assert store.latest_step() == 5
    got = unshard_state(store.read_all(5))
    np.testing.assert_array_equal(got["w"], state["w"])


def test_store_checksum_detects_corruption(tmp_path):
    store = DiskStore(str(tmp_path))
    state = {"w": np.ones((16,), np.float32)}
    store.write_rank(1, 0, shard_state(state, 1)[0])
    store.commit(1, 1)
    f = next((tmp_path / "step_00000001" / "rank_00000").glob("shard_*.bin"))
    raw = bytearray(f.read_bytes())
    raw[-2] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        store.read_rank(1, 0)


def test_nas_store_models_bandwidth(tmp_path):
    clock = SimClock()
    store = NASStore(str(tmp_path), bw_per_rank=1e6, clock=clock)
    state = {"w": np.zeros((1 << 18,), np.float32)}  # 1 MiB
    store.write_rank(1, 0, shard_state(state, 1)[0])
    assert clock.seconds == pytest.approx((1 << 20) / 1e6, rel=1e-3)


# --------------------------------------------------------------------------- #
# cache eviction properties
# --------------------------------------------------------------------------- #
@given(steps=st.lists(st.integers(1, 50).map(lambda x: x * 10),
                      min_size=1, max_size=8, unique=True),
       max_cycles=st.integers(1, 3))
@settings(max_examples=20, deadline=None)
def test_cache_cycle_limit(steps, max_cycles):
    cache = CacheServer(0, EvictionConfig(1 << 24, max_cycles))
    shards = shard_state({"w": np.zeros((64,), np.float32)}, 1)[0]
    for s in sorted(steps):
        cache.put(s, shards)
    kept = cache.steps()
    assert len(kept) <= max_cycles
    assert kept == sorted(steps)[-len(kept):]   # newest survive


def test_cache_memory_cap_evicts_oldest():
    cache = CacheServer(0, EvictionConfig(mem_limit_bytes=64 * 4096,
                                          max_cycles=100))
    shards = shard_state({"w": np.zeros((4096 * 8,), np.uint8)}, 1)[0]
    for s in range(1, 12):
        cache.put(s * 10, shards)
    assert cache.arena.used <= 64 * 4096
    assert 10 not in cache.steps()
    assert cache.evictions > 0


def test_cache_put_delta_shares_base_slabs():
    """Ring-backup delta receives share unchanged leaves' slabs (refcounted)."""
    cache = CacheServer(1, EvictionConfig(mem_limit_bytes=1 << 22,
                                          max_cycles=100))
    state = {"a": np.zeros((4096,), np.uint8), "b": np.ones((4096,), np.uint8)}
    cache.put(10, shard_state(state, 1)[0], is_backup=True, owner_rank=0)
    used_one = cache.arena.used
    changed = shard_state({"b": np.full((4096,), 7, np.uint8)}, 1)[0]
    stats = cache.put_delta(20, changed, 10, owner_rank=0)
    assert stats.reused_leaves == 1 and stats.bytes_staged == 4096
    assert cache.arena.used == used_one + 4096   # "a" shared, "b" staged
    got = cache.get(20, owner_rank=0)
    np.testing.assert_array_equal(got["a"][1], state["a"])
    np.testing.assert_array_equal(got["b"][1], np.full((4096,), 7, np.uint8))


# --------------------------------------------------------------------------- #
# engine failure modes
# --------------------------------------------------------------------------- #
@pytest.fixture
def engine(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=4), DiskStore(str(tmp_path)))
    yield eng
    eng.close()


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {f"l{i}/w": rng.standard_normal((32, 8)).astype(np.float32)
            for i in range(6)}


def test_engine_save_restore(engine):
    s = _state()
    h = engine.save(10, s)
    assert h.wait(15)
    step, got = engine.restore()
    assert step == 10
    for k in s:
        np.testing.assert_array_equal(got[k], s[k])


def test_engine_single_node_failure_uses_backup(engine):
    s = _state(1)
    engine.save(10, s, wait=True)
    engine.node_failed(1)
    step, got = engine.restore(consumers_per_node=8)
    assert engine.stats["restore_sources"]["backup"] == 1
    assert engine.stats["fetch_transfers"] == 1  # dedup'd
    for k in s:
        np.testing.assert_array_equal(got[k], s[k])


def test_engine_adjacent_double_failure_falls_to_store(engine):
    s = _state(2)
    engine.save(10, s, wait=True)
    engine.node_failed(0)
    engine.node_failed(1)   # holds node 0's backup
    step, got = engine.restore()
    assert engine.stats["restore_sources"]["store"] >= 1
    for k in s:
        np.testing.assert_array_equal(got[k], s[k])


def test_engine_unpersisted_double_failure_raises(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=4, async_persist=False, backup=False),
                   DiskStore(str(tmp_path)))
    # not persisted (async_persist off, no reconcile pass), no backups
    eng.caches[0].put(10, shard_state(_state(), 4)[0])
    eng.node_failed(0)
    with pytest.raises(FileNotFoundError):
        eng.restore(step=10)
    eng.close()


def test_engine_node_recovery_repopulates(engine):
    s = _state(3)
    engine.save(10, s, wait=True)
    engine.node_failed(2)
    engine.node_recovered(2)
    assert engine.caches[2].get(10) is not None


def test_engine_elastic_restore_other_node_count(tmp_path):
    s = _state(4)
    eng4 = TCEngine(TCEConfig(n_nodes=4), DiskStore(str(tmp_path)))
    eng4.save(10, s, wait=True)
    eng4.close()
    eng3 = TCEngine(TCEConfig(n_nodes=3), DiskStore(str(tmp_path)))
    step, got = eng3.restore(step=10)
    assert eng3.stats["restore_sources"]["store_full"] == 1
    for k in s:
        np.testing.assert_array_equal(got[k], s[k])
    eng3.close()


def test_theory_model_matches_paper_example():
    """Paper: 175B, 128 ranks (N=16), DP=8 -> ~4.5 min NAS save at 71.1 MB/s
    (mean rank: 2.3 TB / 128 = ~18 GB); TCE ~10 s; ~27x gain."""
    t = TheoryParams(p=175e9, n_nodes=16, dp=8, b_mem=1.92e9)
    r = tce_theory(t)
    assert r["mean_save_bytes_per_rank"] == pytest.approx(19.1e9, rel=0.05)
    assert 230 < r["t_save_nas_mean_s"] < 310     # ~4.5 min
    assert r["t_save_tce_mean_s"] < 12            # ~10 s
    assert 20 < r["G_save"] < 35                  # ~27x


def test_transom_protect_wrapper(tmp_path):
    """Paper §V-C non-intrusiveness: one wrapper call adds async ckpt+resume."""
    from repro_torch.core.tce import restore_into, transom_protect

    tce = TCEngine(TCEConfig(n_nodes=2), DiskStore(str(tmp_path)))
    saves = []
    step_fn = transom_protect(lambda s, i: s + 1.0, tce, every=5,
                              on_save=lambda h: saves.append(h.step))
    state = torch.zeros(())
    for step in range(12):
        state = step_fn(state, step)
    assert saves == [5, 10]
    tce.reconciler.quiesce(15)
    step, got = restore_into(tce, state)
    assert step == 10 and float(got) == 10.0
    tce.close()


# --------------------------------------------------------------------------- #
# the port's own: in-place training state, the card's device on every leg
# --------------------------------------------------------------------------- #
def _train_state():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.train import AdamConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), n_layers=1)
    opt = AdamConfig(warmup_steps=0)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    data = SyntheticLMData(cfg.vocab_size, 16, 2, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    return state, lambda s: make_train_step(cfg, opt)(s, batch)[0]


def test_flatten_pytree_leaves_do_not_follow_in_place_updates():
    """The AdamW update writes params and moments in place; a flat dict taken
    before a step must keep the state it was taken from (it aliased 36 of
    the 38 leaves when CPU leaves were flattened as views)."""
    from repro_torch.core.tce import flatten_pytree

    state, step = _train_state()
    flat = flatten_pytree(state)
    before = {k: v.copy() for k, v in flat.items()}
    after = flatten_pytree(step(state))
    assert sum(after[k].tobytes() != before[k].tobytes() for k in flat) >= 36
    for k, v in flat.items():
        assert v.tobytes() == before[k].tobytes(), k


def test_device_tier_restore_returns_the_saved_state(tmp_path):
    """The device-tier snapshot keeps the saved flat state by reference; a
    step taken after the save must not reach it."""
    from repro_torch.core.tce import default_tiers, flatten_pytree

    state, step = _train_state()
    eng = TCEngine(TCEConfig(n_nodes=2, async_persist=False, tier_table=default_tiers()),
                   DiskStore(str(tmp_path)))
    want = {k: v.copy() for k, v in flatten_pytree(state).items()}
    eng.save(1, state)
    step(state)
    got_step, got = eng.restore()
    assert got_step == 1 and eng.stats["restore_sources"] == {"device": 2}
    for k, v in want.items():
        assert got[k].tobytes() == v.tobytes(), k
    eng.close()


def test_int8_backup_and_restore_run_on_the_store_device(tmp_path):
    """Every int8 encode and decode of the ring backup runs where the store
    says: here the CPU (the default, the card, is absent, so a leg that
    ignored the store's device would log a DeviceUnavailable)."""
    rng = np.random.default_rng(5)
    state = {f"l{i}/w": rng.standard_normal((64, 256)).astype(np.float32) for i in range(4)}
    eng = TCEngine(TCEConfig(n_nodes=2, codec="int8"), DiskStore(str(tmp_path), device="cpu"))
    assert eng.save(10, state).wait(30)
    eng.node_failed(0)
    step, got = eng.restore()
    assert eng.reconciler.errors == []
    assert eng.stats["restore_sources"] == {"cache": 1, "backup": 1, "store": 0,
                                            "store_full": 0}
    for k, v in state.items():
        assert np.allclose(got[k], v, atol=float(np.abs(v).max()) / 100), k
    eng.close()


def test_namespace_and_tiered_store_carry_the_device(tmp_path):
    from repro_torch.core.tce import ModeledStore, TieredStore

    nas = NASStore(str(tmp_path / "nas"), device="cpu")
    assert nas.namespace("job/1").device == "cpu"
    assert DiskStore(str(tmp_path / "d"), device="cpu").namespace("a").device == "cpu"
    tiered = TieredStore({"ssd": ModeledStore(str(tmp_path / "ssd"), device="cpu"),
                          "nas": nas})
    assert tiered.device == "cpu"


def test_snapshot_copies_a_tensor_once():
    from repro_torch.core.tce import BF16, METER
    from repro_torch.core.tce.fastcopy import snapshot

    x = torch.randn(33, 7)
    m0 = METER.read()
    host = snapshot(x)
    assert METER.read() - m0 == x.nbytes
    x.add_(1.0)
    assert not np.shares_memory(host, x.numpy()) and np.array_equal(host + 1.0, x.numpy())
    out = np.zeros(x.nbytes + 100, np.uint8)
    assert snapshot(x, out) is out
    assert out[:x.nbytes].view(np.float32).reshape(x.shape).tobytes() == x.numpy().tobytes()
    b = torch.randn(5, 3).to(torch.bfloat16)
    hb = snapshot(b)
    assert hb.dtype == BF16 and hb.view(np.int16).tobytes() == b.view(torch.int16).numpy().tobytes()
