"""The control at a tiny size on the CPU: the plain reference computed in
float8 in the program's place (``control.py`` reads the same at each cell's
own size on the card, where the limits were set from it). Here the sound
program reads 0 or bfloat16 rounding, and the control has to read well above
it on the numbers that separate the two at full size."""
import pytest

from perfbench import control, tiny
from perfbench.drivers import train
from perfbench.lib import spec

SEEDS = (1, 2, 3)


@pytest.mark.parametrize("cell", ["olmoe-train", "mamba2-train-ckpt"])
def test_training_control_fails_the_gradient_limit(cell):
    limit = spec.limits(cell)["grad_gap"]
    for seed in SEEDS:
        _bench, job = tiny.job(cell, seed=seed)
        judge = train.reference_steps(job)
        control = train.compare(train.reference_steps(job, "fp8"), judge)
        assert control["grad_gap"] > limit, (seed, control)


def test_prefill_control_reads_far_above_the_program():
    """The control and the zeroed starting states each fail the prefill
    cell's limits, as ``control.py`` judges them, where the sound program
    passes; the control reads far above the program on the caches."""
    _bench, job = tiny.job("mamba2-prefill")
    limits = spec.limits("mamba2-prefill")
    sound = tiny.run("mamba2-prefill")["checks"]
    got = control.readings(job)
    assert set(got) == {"control", "no_carry"}
    for name, numbers in got.items():
        assert not control.verdict(numbers, limits)["correct"], (name, numbers)
    assert control.verdict({k: c["value"] for k, c in sound.items()}, limits)["correct"]
    for name in ("state_gap", "conv_gap"):
        assert got["control"][name] > 3 * max(sound[name]["value"], 1e-3), (name, got, sound)
