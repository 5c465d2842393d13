"""The port's rank worker on the CPU: the reference's JSON-lines protocol, a
SIGKILL in the middle of a save and a restore that repeats the uninterrupted
run bit for bit, and a checkpoint written by the reference's worker that the
port's worker restores.

The workers are subprocesses (``device=cpu``); the test plays the
controller, which commits a step's manifest after the rank acked its write.
"""
import json

import pytest

pytest.importorskip("torch")

from repro_torch.core.tce import DiskStore  # noqa: E402
from repro_torch.substrate.worker import RankProcess  # noqa: E402

SPEC = dict(rank=0, n_ranks=1, seed=0, total_steps=20, batch=4, seq=32, device="cpu")


def _spawn(tmp_path, name, **kw):
    spec = dict(SPEC, ckpt_dir=str(tmp_path / "ckpt"), **kw)
    return RankProcess(spec, tmp_path / f"{name}.log")


def _ok(resp):
    assert resp is not None and resp.get("ok") == 1, resp
    return resp


def test_killed_rank_restores_and_repeats_the_run_bit_for_bit(tmp_path):
    """Step to 4, save 4, step to 8, digest; a save of 8 dies after its
    write; a fresh worker restores 4 and steps to 8."""
    store = DiskStore(str(tmp_path / "ckpt"), device="cpu")
    w = _spawn(tmp_path, "first")
    try:
        assert w.call({"cmd": "ping"}) == {"ok": 1}
        _ok(w.call({"cmd": "step", "upto": 4}))
        _ok(w.call({"cmd": "save", "step": 4}))
        store.commit(4, 1)
        tail = _ok(w.call({"cmd": "step", "upto": 8}))["losses"]
        digest = _ok(w.call({"cmd": "digest"}))
        assert w.call({"cmd": "save", "step": 8, "die_at": "after_write"}) is None
        w.proc.wait(timeout=30)
        assert w.proc.returncode == -9                  # SIGKILL
    finally:
        w.close()
    assert store.latest_step() == 4                     # step 8 was never committed
    w = _spawn(tmp_path, "second")
    try:
        assert _ok(w.call({"cmd": "restore", "step": 4}))["step"] == 4
        again = _ok(w.call({"cmd": "step", "upto": 8}))["losses"]
        digest_again = _ok(w.call({"cmd": "digest"}))
    finally:
        w.close()
    assert [s for s, _ in tail] == [5, 6, 7, 8]
    assert again == tail                                # exact floats
    assert digest_again == digest                       # every leaf's crc
    assert {e["enc"] for e in store.rank_index(4, 0)} == {"raw"}


def test_int8_checkpoint_quantises_params_only(tmp_path):
    store = DiskStore(str(tmp_path / "ckpt"), device="cpu")
    w = _spawn(tmp_path, "int8", codec="int8")
    try:
        _ok(w.call({"cmd": "step", "upto": 4}))
        _ok(w.call({"cmd": "save", "step": 4}))
        store.commit(4, 1)
        tail = _ok(w.call({"cmd": "step", "upto": 8}))["losses"]
        _ok(w.call({"cmd": "restore", "step": 4}))
        again = _ok(w.call({"cmd": "step", "upto": 8}))["losses"]
    finally:
        w.close()
    encs = {e["spec"]["path"]: e["enc"] for e in store.rank_index(4, 0)}
    quantised = {p for p, enc in encs.items() if enc == "int8"}
    assert quantised == {p for p in encs if p.startswith("params/") and not p.endswith("/scale")}
    assert len(quantised) == 9                          # tok/table, tok/head, 7 projections
    # the restored params are within the codec's error (s / 2 per value): the
    # run goes on close to the uninterrupted one, not equal to it
    assert [s for s, _ in again] == [s for s, _ in tail]
    assert all(abs(a - b) < 0.05 * abs(b) for (_, a), (_, b) in zip(again, tail))


def test_port_worker_restores_a_reference_worker_checkpoint(tmp_path):
    pytest.importorskip("jax")
    store = DiskStore(str(tmp_path / "ckpt"), device="cpu")
    jax_spec = {k: v for k, v in SPEC.items() if k != "device"}
    jax_spec["ckpt_dir"] = str(tmp_path / "ckpt")
    jw = RankProcess(jax_spec, tmp_path / "jax.log", module="repro.substrate.worker")
    try:
        _ok(jw.call({"cmd": "step", "upto": 3}))
        _ok(jw.call({"cmd": "save", "step": 3}))
        store.commit(3, 1)
        jax_digest = _ok(jw.call({"cmd": "digest"}))
    finally:
        jw.close()
    pw = _spawn(tmp_path, "port")
    try:
        _ok(pw.call({"cmd": "restore", "step": 3}))
        port_digest = _ok(pw.call({"cmd": "digest"}))
        # and it trains on from there
        assert _ok(pw.call({"cmd": "step", "upto": 4}))["step"] == 4
    finally:
        pw.close()
    assert port_digest["step"] == 3
    assert json.dumps(port_digest["leaves"], sort_keys=True) == \
           json.dumps(jax_digest["leaves"], sort_keys=True)
