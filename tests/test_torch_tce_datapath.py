"""The port's checkpoint datapath against the reference's datapath tests
(``tests/test_tce_datapath.py``, case for case): zero-copy staging, parallel
puts, delta checkpoints, compressed persistence (zlib lossless / int8
through the quant_blockwise kernels' plain version, on the CPU), copy-meter
accounting, and the legacy-vs-new A/B contract."""
import threading
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core.tce import (DiskStore, EvictionConfig, METER, TCEConfig,  # noqa: E402
                                  TCEngine, crc32_stream, decode_shard,
                                  encode_shard, shard_state)
from repro_torch.core.tce.arena import Arena  # noqa: E402
from repro_torch.core.tce.cache import CacheServer  # noqa: E402


def _state(seed=0, n_leaves=6, rows=64):
    rng = np.random.default_rng(seed)
    s = {f"layer{i}/w": rng.standard_normal((rows, 8)).astype(np.float32)
         for i in range(n_leaves)}
    s["opt/adam_mu"] = rng.standard_normal((rows, 8)).astype(np.float32)
    return s


def _mutate(state, key):
    out = dict(state)
    out[key] = state[key] + 1.0
    return out


# --------------------------------------------------------------------------- #
# crc streaming + codec primitives
# --------------------------------------------------------------------------- #
def test_crc32_stream_matches_tobytes():
    x = np.random.default_rng(0).standard_normal(10_001).astype(np.float32)
    assert crc32_stream(x) == (zlib.crc32(x.tobytes()) & 0xFFFFFFFF)
    assert crc32_stream(x, chunk=97) == crc32_stream(x)


@pytest.mark.parametrize("codec", ["raw", "zlib", "int8"])
def test_codec_roundtrip(codec):
    rng = np.random.default_rng(1)
    for shape in [(300,), (7, 33), (2, 3, 5)]:
        x = rng.standard_normal(shape).astype(np.float32)
        enc, payload, meta = encode_shard(x, codec, device="cpu")
        got = decode_shard(enc, payload, "float32", shape, meta, device="cpu")
        if codec == "int8" and enc == "int8":
            # blockwise absmax: error bounded by half an int8 step per block
            assert np.allclose(got, x, atol=float(np.abs(x).max()) / 100)
        else:
            np.testing.assert_array_equal(got, x)


def test_codec_lossless_allowlist_and_nonfloat_demote():
    x = np.arange(256, dtype=np.int64)
    enc, payload, meta = encode_shard(x, "int8", device="cpu")   # non-float -> lossless
    assert enc in ("raw", "zlib")
    np.testing.assert_array_equal(
        decode_shard(enc, payload, "int64", x.shape, meta), x)
    y = np.ones(256, np.float32)
    enc, payload, meta = encode_shard(y, "int8", lossless=True, device="cpu")
    assert enc in ("raw", "zlib")
    np.testing.assert_array_equal(
        decode_shard(enc, payload, "float32", y.shape, meta), y)


# --------------------------------------------------------------------------- #
# zero-copy staging
# --------------------------------------------------------------------------- #
def test_cache_get_returns_readonly_views():
    cache = CacheServer(0)
    cache.put(10, shard_state({"w": np.arange(64, dtype=np.float32)}, 1)[0])
    a = cache.get(10)["w"][1]
    b = cache.get(10)["w"][1]
    assert not a.flags.writeable
    assert np.shares_memory(a, b)          # same arena slab, no copies
    with pytest.raises(ValueError):
        a[0] = 1.0


def test_save_copies_each_byte_once():
    state = {"w": np.random.default_rng(0).standard_normal(
        (1 << 14,)).astype(np.float32)}
    store_dir_engine = []
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        eng = TCEngine(TCEConfig(n_nodes=2, backup=False, async_persist=False,
                                 delta=False), DiskStore(d))
        m0 = METER.read()
        h = eng.save(10, state)
        # the blocking stall copies every byte exactly once into the arena
        assert h.bytes_copied == h.nbytes == state["w"].nbytes
        eng.close()


def test_legacy_datapath_copies_more():
    """The A/B contract fig8 gates on: new path stalls with >=2x fewer
    physical byte-copies than the legacy bounce+copy+recopy path."""
    import tempfile
    state = _state(3, rows=256)
    counts = {}
    for name, legacy in [("new", False), ("legacy", True)]:
        with tempfile.TemporaryDirectory() as d:
            eng = TCEngine(TCEConfig(n_nodes=2, legacy_datapath=legacy),
                           DiskStore(d, legacy_crc=legacy))
            m0 = METER.read()
            s = state
            for step, key in [(10, None), (20, "layer0/w"), (30, "layer1/w")]:
                if key:
                    s = _mutate(s, key)
                eng.save(step, s, wait=True)
            counts[name] = METER.read() - m0
            eng.close()
    assert counts["legacy"] >= 2 * counts["new"], counts


# --------------------------------------------------------------------------- #
# arena accounting under concurrent per-rank puts
# --------------------------------------------------------------------------- #
def test_arena_accounting_exact_under_concurrent_puts():
    cache = CacheServer(0, EvictionConfig(mem_limit_bytes=1 << 26,
                                          max_cycles=100))
    n_threads, leaf = 8, 4096 * 3
    errs = []

    def put(i):
        try:
            data = np.full((leaf,), i, np.uint8)
            cache.put((i + 1) * 10, shard_state({"w": data}, 1)[0])
        except Exception as e:          # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=put, args=(i,)) for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    expected = n_threads * ((leaf + 4095) // 4096 * 4096)
    assert cache.arena.used == expected
    cache.wipe()
    assert cache.arena.used == 0


def test_put_delta_rolls_back_on_arena_full():
    """A failed delta put must release every reference it took (no leaked
    arena capacity), and the cache must stay usable."""
    from repro_torch.core.tce.arena import ArenaError
    cache = CacheServer(1, EvictionConfig(mem_limit_bytes=4 * 4096,
                                          max_cycles=100))
    base = shard_state({"a": np.zeros((4096,), np.uint8),
                        "b": np.ones((4096,), np.uint8)}, 1)[0]
    cache.put(10, base, is_backup=True, owner_rank=0)
    huge = shard_state({"b": np.zeros((1 << 20,), np.uint8)}, 1)[0]
    with pytest.raises(ArenaError):
        cache.put_delta(20, huge, 10, owner_rank=0)
    # accounting stays exact: used equals the live entries' bytes — the
    # retained refs taken by the failed put were all rolled back (here the
    # eviction loop legally dropped the base too, so everything is free)
    live = sum(ss.nbytes for e in cache._entries.values()
               for ss in e.shards.values())
    assert cache.arena.used <= max(live, 1) * 2
    if not cache._entries:
        assert cache.arena.used == 0         # no orphaned slabs


def test_restored_state_is_writable():
    """Cache-served restores must hand back mutable arrays for every leaf —
    including small unsharded (axis=-1) leaves served straight from arena
    views."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        eng = TCEngine(TCEConfig(n_nodes=4), DiskStore(d))
        state = {"w": np.random.default_rng(0).standard_normal(
                     (32, 8)).astype(np.float32),
                 "step_counter": np.array([7], np.int64)}   # unsharded leaf
        eng.save(10, state, wait=True)
        _, got = eng.restore()
        for k in got:
            got[k] += 1                      # must not raise read-only
        eng.close()


def test_delta_backup_does_not_resurrect_deleted_leaves(engine2):
    s1 = _state(13)
    engine2.save(10, s1, wait=True)
    s2 = dict(s1)
    del s2["layer2/w"]                       # schema change drops a leaf
    engine2.save(20, s2, wait=True)
    engine2.node_failed(0)                   # force backup-served restore
    step, got = engine2.restore(step=20)
    assert "layer2/w" not in got
    assert set(got) == set(s2)


def test_arena_refcount_shared_slab_freed_once():
    a = Arena(1 << 20)
    sid = a.alloc(4096)
    a.retain(sid)
    used = a.used
    a.free_slab(sid)
    assert a.used == used               # still referenced by the second holder
    a.free_slab(sid)
    assert a.used == 0


# --------------------------------------------------------------------------- #
# delta checkpoints
# --------------------------------------------------------------------------- #
@pytest.fixture
def engine2(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=2, max_cycles=2), DiskStore(str(tmp_path)))
    yield eng
    eng.close()


def test_delta_persists_only_changed_leaves(engine2, tmp_path):
    s1 = _state(7)
    engine2.save(10, s1, wait=True)
    full_bytes = engine2.store.stats["bytes_stored"]
    s2 = _mutate(s1, "layer0/w")
    engine2.save(20, s2, wait=True)
    delta_bytes = engine2.store.stats["bytes_stored"] - full_bytes
    assert delta_bytes < full_bytes / 2          # only one leaf re-persisted
    assert engine2.store.stats["leaves_ref"] > 0
    # an identical re-save persists zero new leaf bytes (all refs)
    before = engine2.store.stats["bytes_stored"]
    engine2.save(30, s2, wait=True)
    assert engine2.store.stats["bytes_stored"] == before
    assert engine2.reconciler.stats["delta_leaves_skipped"] > 0


def test_delta_chain_restore_across_evicted_base(engine2):
    """save 10 (full) -> 20 (delta) -> 30 (delta); max_cycles=2 evicts step 10
    from every cache; a cold restore of 30 resolves refs into 10/20's files."""
    s1 = _state(8)
    engine2.save(10, s1, wait=True)
    s2 = _mutate(s1, "layer0/w")
    engine2.save(20, s2, wait=True)
    s3 = _mutate(s2, "layer1/w")
    engine2.save(30, s3, wait=True)
    assert 10 not in engine2.caches[0].steps()   # base evicted from cache
    for c in engine2.caches:                     # cold restore: store only
        c.wipe()
    step, got = engine2.restore(step=30)
    assert engine2.stats["restore_sources"]["store"] == 2
    for k in s3:
        np.testing.assert_array_equal(got[k], s3[k])
    # manifest-level chain recorded
    assert engine2.store.manifest(30)["delta_base"] == 20
    assert engine2.store.manifest(20)["delta_base"] == 10


def test_delta_backup_ships_only_changed_bytes(engine2):
    s1 = _state(9, rows=512)
    engine2.save(10, s1, wait=True)
    moved_full = engine2.fabric.bytes_moved
    s2 = _mutate(s1, "layer0/w")
    engine2.save(20, s2, wait=True)
    moved_delta = engine2.fabric.bytes_moved - moved_full
    assert moved_delta < moved_full / 2
    # the neighbour's rebuilt backup entry must still restore the full state
    engine2.node_failed(0)
    step, got = engine2.restore(step=20)
    assert engine2.stats["restore_sources"]["backup"] == 1
    for k in s2:
        np.testing.assert_array_equal(got[k], s2[k])


# --------------------------------------------------------------------------- #
# compressed persistence
# --------------------------------------------------------------------------- #
def test_zlib_save_evict_restore_bit_exact(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=2, codec="zlib"), DiskStore(str(tmp_path)))
    state = {"w": np.ones((512, 8), np.float32),
             "b": np.arange(4096, dtype=np.float32).reshape(512, 8)}
    eng.save(10, state, wait=True)
    assert eng.store.stats["bytes_stored"] < eng.store.stats["bytes_raw"]
    for c in eng.caches:
        c.wipe()
    step, got = eng.restore()
    assert eng.stats["restore_sources"]["store"] == 2
    for k in state:
        assert got[k].tobytes() == state[k].tobytes()   # bit-exact
    eng.close()


def test_int8_save_restore_tolerance_and_allowlist(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=2, codec="int8",
                             lossless_paths=("*adam*",)),
                   DiskStore(str(tmp_path), device="cpu"))
    state = _state(11, rows=256)
    eng.save(10, state, wait=True)
    assert eng.store.stats["bytes_stored"] < eng.store.stats["bytes_raw"] / 2
    for c in eng.caches:
        c.wipe()
    step, got = eng.restore()
    np.testing.assert_array_equal(got["opt/adam_mu"], state["opt/adam_mu"])
    for k in state:
        if k == "opt/adam_mu":
            continue
        tol = float(np.abs(state[k]).max()) / 100
        assert np.allclose(got[k], state[k], atol=tol), k
        assert got[k].tobytes() != state[k].tobytes()   # really quantised
    eng.close()


def test_store_checksum_detects_corruption_encoded(tmp_path):
    store = DiskStore(str(tmp_path))
    state = {"w": np.ones((16,), np.float32)}
    store.write_rank(1, 0, shard_state(state, 1)[0], codec="zlib")
    store.commit(1, 1)
    f = next((tmp_path / "step_00000001" / "rank_00000").glob("shard_*.bin"))
    raw = bytearray(f.read_bytes())
    raw[-2] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        store.read_rank(1, 0)


# --------------------------------------------------------------------------- #
# reconciler: one view feeds persist + backup
# --------------------------------------------------------------------------- #
def test_reconciler_single_get_per_entry_pass(tmp_path):
    eng = TCEngine(TCEConfig(n_nodes=2, async_persist=False),
                   DiskStore(str(tmp_path)))
    calls = []
    orig = CacheServer.get

    def counting_get(self, step, owner_rank=None):
        calls.append((self.rank, step, owner_rank))
        return orig(self, step, owner_rank)

    CacheServer.get = counting_get
    try:
        eng.save(10, _state(12))
    finally:
        CacheServer.get = orig
    own_gets = [c for c in calls if c[2] is None]
    assert len(own_gets) == 2          # one per rank, feeding persist AND backup
    eng.close()
