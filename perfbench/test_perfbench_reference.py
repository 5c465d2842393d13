"""Each plain reference held against the port at a tiny size on the CPU:
the training step's losses, first gradients and parameter changes over the
first steps (OLMoE-shaped and Mamba-2), and Mamba-2's prefill logits and the
cache it hands on. Tolerances are bfloat16's: the Mamba-2 reference
accumulates its scan's gradients in another order than the port, so the two
differ by rounding; the OLMoE reference and the prefill repeat the port's
order."""
import torch

from perfbench import tiny
from perfbench.drivers import train
from perfbench.lib import inputs, program

BF16_STEP = 1e-2       # a few bf16 roundings (2^-8) carried through 3 steps


def program_steps(job):
    """The port's first steps from the benchmark's weights, read as the
    train driver reads them."""
    from repro_torch.models.params import flatten_params
    from repro_torch.train import AdamConfig, TrainConfig, make_train_step
    from repro_torch.train.optimizer import adam_init
    from repro_torch.train.state import TrainState, init_rng

    t, m = job.traffic, job.port
    spec = job.ref.param_spec(m)
    params = program.param_tree(job.cfg, inputs.weight_dict(spec, job.seed, "cpu", torch.float32))
    opt = AdamConfig(**t["optimizer"])
    state = TrainState(torch.zeros((), dtype=torch.int32), init_rng(job.seed), params,
                       adam_init(params, opt))
    step = make_train_step(job.cfg, opt, TrainConfig())
    losses, grad = [], None
    for k in range(train.FIRST_STEPS):
        state, metrics = step(state, inputs.batch(job.seed, k, t["batch"], t["seq"],
                                                  m["vocab_size"], "cpu"))
        losses.append(float(metrics["loss"]))
        if k == 0:
            grad = {p: float(torch.linalg.vector_norm(x)) / (1 - opt.b1)
                    for p, x in flatten_params(state.opt["m"]).items()}
    change = train._change_norms(flatten_params(state.params), spec, job.seed, "cpu")
    return losses, grad, change


def test_olmoe_training_step_matches_the_reference():
    _bench, job = tiny.job("olmoe-train")
    gaps = train.compare(program_steps(job), train.reference_steps(job))
    assert max(gaps.values()) <= BF16_STEP, gaps


def test_mamba2_training_step_matches_the_reference():
    _bench, job = tiny.job("mamba2-train-ckpt")
    gaps = train.compare(program_steps(job), train.reference_steps(job))
    assert max(gaps.values()) <= BF16_STEP, gaps


def test_mamba2_prefill_matches_the_reference():
    from repro_torch.serve.engine import prefill_fn

    from perfbench.reference.common import Precision

    _bench, job = tiny.job("mamba2-prefill")
    m = job.port
    flat = inputs.weight_dict(job.ref.param_spec(m), job.seed, "cpu", torch.bfloat16)
    tokens = inputs.wave(job.seed, 0, 4, 64, m["vocab_size"], "cpu")
    with torch.inference_mode():
        logits, cache = prefill_fn(program.param_tree(job.cfg, flat), job.cfg, {"tokens": tokens})
        r_logits, r_tails, r_states = job.ref.prefill(flat, m, tokens, Precision())
    scale = float(r_logits.float().abs().max())
    assert float((logits.float() - r_logits.float()).abs().max()) <= BF16_STEP * scale
    seg = cache["stack"]["l0"]
    assert torch.allclose(seg["conv"].float(), r_tails.float(), rtol=BF16_STEP, atol=BF16_STEP)
    assert torch.allclose(seg["state"], r_states, rtol=BF16_STEP, atol=BF16_STEP)
