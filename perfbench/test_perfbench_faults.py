"""The rest of a run driven with the timed path broken underneath, on the
CPU at a tiny size with the look for a card skipped: each fault a cell can
have must come out as ``correct`` false against the cell's own limits. (On
one chip no exchange between chips exists to leave out.)"""
import pytest
import torch

from perfbench import faults, tiny


def frozen_steps(make_train_step):
    """A step that returns its state unchanged (it still reports a loss)."""
    def factory(cfg, opt_cfg, tcfg=None, mesh=None):
        from repro_torch.models.model import loss_fn

        def step(state, batch):
            with torch.no_grad():
                _loss, metrics = loss_fn(state.params, cfg, batch)
            return state, metrics
        return step
    return factory


def half_batch_steps(make_train_step):
    """Half of the batch left out, the mean taken over the rest."""
    def factory(cfg, opt_cfg, tcfg=None, mesh=None):
        real = make_train_step(cfg, opt_cfg, tcfg, mesh)

        def step(state, batch):
            return real(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return step
    return factory


TRAIN_FAULTS = {"state_unchanged": frozen_steps, "half_batch": half_batch_steps}


@pytest.mark.parametrize("fault", list(TRAIN_FAULTS))
@pytest.mark.parametrize("cell", ["olmoe-train", "mamba2-train-ckpt"])
def test_training_fault_is_not_correct(cell, fault, monkeypatch):
    import repro_torch.train as train_pkg

    faulty = TRAIN_FAULTS[fault](train_pkg.make_train_step)
    monkeypatch.setattr(train_pkg, "make_train_step", faulty)
    line = tiny.run(cell)
    assert not line["correct"], line["checks"]


def test_checkpoint_byte_altered_at_the_save_is_not_correct(monkeypatch):
    """One byte of the state altered where the save produces its host copy:
    every leg restores it, and none matches what the save was handed."""
    import repro_torch.core.tce.engine as engine

    real = engine.flatten_pytree

    def altered(tree):
        flat = real(tree)
        path = sorted(p for p in flat if p.startswith("params/"))[0]
        flat[path].view("uint8").reshape(-1)[0] ^= 1
        return flat

    monkeypatch.setattr(engine, "flatten_pytree", altered)
    line = tiny.run("mamba2-train-ckpt")
    assert not line["correct"]
    for leg in ("cache", "backup", "store"):
        assert line["checks"][f"restore_{leg}"]["value"] > 0


def token_altered(prefill_fn):
    """Every served token moved to the next vocabulary id where it is made."""
    def fn(params, cfg, batch, attn_impl="kernel"):
        logits, cache = prefill_fn(params, cfg, batch, attn_impl)
        return torch.roll(logits, 1, dims=-1), cache
    return fn


def half_wave(prefill_fn):
    """Half of the wave's prompts prefilled, their answers given to all."""
    def fn(params, cfg, batch, attn_impl="kernel"):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        logits, cache = prefill_fn(params, cfg, half, attn_impl)
        cache = {s: {l: {k: torch.cat([v, v], dim=1) for k, v in leaves.items()}
                     for l, leaves in seg.items()} for s, seg in cache.items()}
        return torch.cat([logits, logits]), cache
    return fn


@pytest.mark.parametrize("fault", [token_altered, half_wave], ids=["token_altered", "half_wave"])
def test_prefill_fault_is_not_correct(fault, monkeypatch):
    import repro_torch.serve.engine as engine

    monkeypatch.setattr(engine, "prefill_fn", fault(engine.prefill_fn))
    line = tiny.run("mamba2-prefill")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["mamba2-train-ckpt", "mamba2-prefill"])
def test_ssd_starting_states_zeroed_is_not_correct(cell, monkeypatch):
    """The SSD scan run on each chunk from a zero state: the carry between
    chunks left out, in the training scan and in the prefill's kernel entry."""
    import repro_torch.kernels.ssd_scan.ops as ssd_ops
    import repro_torch.models.ssm as ssm

    monkeypatch.setattr(ssm, "ssd_chunked", faults.no_carry(ssm.ssd_chunked))
    monkeypatch.setattr(ssd_ops, "ssd_scan", faults.no_carry(ssd_ops.ssd_scan))
    line = tiny.run(cell)
    assert not line["correct"], line["checks"]
