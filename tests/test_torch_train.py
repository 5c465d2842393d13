"""The port's training rank (loss, chunked attention, AdamW, train step)
against the JAX reference, on the CPU at a small size.

Weights come from the reference through the weight bridge; inputs, grads and
batches are made with numpy from fixed seeds and handed to both packages.
Tolerances are float32 across two frameworks, stated with their reasons.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tce.engine import flatten_pytree as jax_flatten  # noqa: E402
from repro.data import SyntheticLMData  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import (TrainConfig as JaxTrainConfig, init_train_state as jax_init_state,  # noqa: E402
                         make_train_step as jax_make_train_step)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMData as PortData  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_reference  # noqa: E402
from repro_torch.models import attention, model  # noqa: E402
from repro_torch.models.params import params_from_flat, tree_items  # noqa: E402
from repro_torch.train import (AdamConfig, TrainConfig, TrainState, adam_init,  # noqa: E402
                               adam_update, init_train_state, lr_schedule, make_train_step)
from repro_torch.train import optimizer  # noqa: E402


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _cfgs(**kw):
    return (dataclasses.replace(jax_get_config("llama3-8b").reduced(), **kw),
            dataclasses.replace(get_config("llama3-8b").reduced(), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #
def test_cross_entropy_masks_negative_labels_vs_jax():
    logits = _rand((3, 7, 50), seed=1, scale=4.0)
    labels = np.random.default_rng(2).integers(0, 50, (3, 7))
    labels[0, :3] = -1
    labels[2, 6] = -1
    got = model.cross_entropy(_t(logits), _t(labels))
    want = jax_model.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    # f32 logsumexp in two libraries: a few ulp of a value near 4
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(model.cross_entropy(_t(logits), torch.full((3, 7), -1))) == 0.0


def test_cross_entropy_bf16_logits_match_their_f32_upcast():
    logits = torch.from_numpy(_rand((2, 5, 40), seed=3)).bfloat16()
    labels = torch.from_numpy(np.random.default_rng(4).integers(0, 40, (2, 5)))
    assert torch.equal(model.cross_entropy(logits, labels),
                       model.cross_entropy(logits.float(), labels))


# --------------------------------------------------------------------------- #
# Chunked attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("q_block", [None, 8, 16, 32])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_gqa_vs_jax(q_block, causal):
    q, k, v = _rand((2, 32, 4, 16), 5), _rand((2, 32, 2, 16), 6), _rand((2, 32, 2, 16), 7)
    got = attention.chunked_attention(_t(q), _t(k), _t(v), causal, q_block=q_block)
    want = jax_attention.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal, q_block=q_block)
    # float32 softmax-weighted sums over 32 keys, another summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), attention_reference(_t(q), _t(k), _t(v), causal).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_chunked_attention_gradients_vs_jax():
    q, k, v = _rand((1, 16, 4, 8), 8), _rand((1, 16, 1, 8), 9), _rand((1, 16, 1, 8), 10)
    w = _rand((1, 16, 4, 8), 11)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (attention.chunked_attention(tq, tk, tv, True, q_block=4) * _t(w)).sum().backward()

    def f(q_, k_, v_):
        return jnp.sum(jax_attention.chunked_attention(q_, k_, v_, True, q_block=4) * w)

    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_attention_forward_takes_the_reference_name():
    _, pcfg = _cfgs(compute_dtype="float32")
    p = {k: _t(_rand(s, i, 0.1)) for i, (k, s) in enumerate(
        [("wq", (64, 64)), ("wk", (64, 32)), ("wv", (64, 32)), ("wo", (64, 64))])}
    x = _t(_rand((2, 16, 64), 12))
    pos = torch.arange(16)[None].expand(2, 16)
    y_xla, _ = attention.attention_forward(p, x, pcfg, pos, attn_impl="xla")
    y_chunked, _ = attention.attention_forward(p, x, pcfg, pos, attn_impl="chunked")
    assert torch.equal(y_xla, y_chunked)
    with pytest.raises(ValueError):
        attention.attention_forward(p, x, pcfg, pos, attn_impl="pallas")


# --------------------------------------------------------------------------- #
# Optimizer
# --------------------------------------------------------------------------- #
def test_lr_schedule_points_vs_jax():
    for cfg in (dict(lr=1e-3, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1),
                dict(lr=3e-4, warmup_steps=0, decay_steps=50)):
        for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 1000):
            got = float(lr_schedule(AdamConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
            want = float(jax_opt.lr_schedule(jax_opt.AdamConfig(**cfg), jnp.asarray(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (cfg, step)


def _opt_params():
    return {"a": _rand((16, 32), 20), "b": {"w": _rand((4, 8, 16), 21), "s": _rand((16,), 22)}}


# The global grad norm is summed in another order in each library (a relative
# 1e-7 difference in the clip scale scales every update); int8 moments can
# then round one value to the next q step, a change of s ~ amax / 127 in the
# moment, which Adam's normalisation passes on to the update.
ADAM_TOL = {"float32": 5e-6, "bfloat16": 5e-6, "int8": 1e-4}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
def test_adam_update_vs_jax(moment_dtype, clip):
    kw = dict(moment_dtype=moment_dtype, grad_clip=clip, warmup_steps=0, lr=1e-2,
              weight_decay=0.1)
    jcfg, pcfg = jax_opt.AdamConfig(**kw), AdamConfig(**kw)
    p0 = _opt_params()
    jp = jax.tree.map(jnp.asarray, p0)
    jo = jax_opt.adam_init(jp, jcfg)
    pp = {"a": _t(p0["a"]), "b": {k: _t(v) for k, v in p0["b"].items()}}
    po = adam_init(pp, pcfg)
    jax_step = jax.jit(lambda p, g, o, s: jax_opt.adam_update(p, g, o, s, jcfg))
    for step in range(3):
        g = jax.tree.map(lambda a, s=step: _rand(a.shape, 100 + s + a.size, 0.5), p0)
        jp, jo, jm = jax_step(jp, jax.tree.map(jnp.asarray, g), jo, jnp.int32(step))
        pp, po, pm = adam_update(pp, {"a": _t(g["a"]), "b": {k: _t(v) for k, v in g["b"].items()}},
                                 po, torch.tensor(step, dtype=torch.int32), pcfg)
        assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        if clip:
            assert float(pm["grad_norm"]) > clip          # the clip is active
    tol = ADAM_TOL[moment_dtype]
    for (path, got), want in zip(tree_items(pp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol, err_msg=path)
    for key in ("m", "v"):
        for path, got in tree_items(po[key]):
            want = np.asarray(jax_flatten(jo[key])[path])
            if moment_dtype == "int8" and path.endswith("/q"):
                assert np.abs(got.numpy().astype(int) - want).max() <= 1, path
            else:
                np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                           rtol=1e-4, atol=1e-7, err_msg=path)


def test_adam_decays_only_matrices():
    cfg = AdamConfig(warmup_steps=0, lr=0.1, weight_decay=0.5)
    p = {"m": torch.ones(3, 4), "v": torch.ones(4)}
    g = {"m": torch.zeros(3, 4), "v": torch.zeros(4)}
    adam_update(p, g, adam_init(p, cfg), torch.tensor(0, dtype=torch.int32), cfg)
    assert torch.equal(p["v"], torch.ones(4))
    torch.testing.assert_close(p["m"], torch.full((3, 4), 1 - 0.1 * 0.5), rtol=0, atol=1e-7)


def test_adam_int8_moments_are_int8_rows():
    p = {"w": torch.ones(5, 7), "s": torch.ones(7)}
    st = adam_init(p, AdamConfig(moment_dtype="int8"))
    assert st["m"]["w"]["q"].dtype == torch.int8 and tuple(st["m"]["w"]["s"].shape) == (5,)
    assert tuple(st["v"]["s"]["s"].shape) == ()


def test_stochastic_rounding_is_unbiased():
    # 1 + 2^-9 lies a quarter of the way from 1 to the next bf16 (1 + 2^-7):
    # round-to-nearest gives 1 every time, stochastic rounding 1 + 2^-7 with
    # probability 1/4. Over n draws the mean is within 5 sigma of x.
    x = torch.full((200_000,), 1 + 2 ** -9, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    r = optimizer.stochastic_round_bf16(x, gen).float()
    assert set(r.unique().tolist()) == {1.0, 1 + 2 ** -7}
    sigma = (2 ** -7) * (0.25 * 0.75 / x.numel()) ** 0.5
    assert abs(float(r.mean()) - (1 + 2 ** -9)) < 5 * sigma
    assert float(x.bfloat16().float().mean()) == 1.0        # nearest is biased
    again = optimizer.stochastic_round_bf16(x, torch.Generator().manual_seed(0))
    assert torch.equal(again.float(), r)


def test_stochastic_rounding_in_the_update_follows_rng_step_and_leaf():
    cfg = AdamConfig(warmup_steps=0, lr=1e-3, stochastic_round_params=True, weight_decay=0)
    rng = torch.tensor([7, 9], dtype=torch.uint32)

    def run(step, rng_):
        p = {"a": torch.from_numpy(_rand((64, 64), 30)).bfloat16(),
             "b": torch.from_numpy(_rand((64, 64), 30)).bfloat16()}
        g = {"a": _t(_rand((64, 64), 31)), "b": _t(_rand((64, 64), 31))}
        adam_update(p, g, adam_init(p, cfg), torch.tensor(step, dtype=torch.int32), cfg, rng=rng_)
        return p

    p1, p2 = run(3, rng), run(3, rng)
    assert p1["a"].dtype == torch.bfloat16
    assert torch.equal(p1["a"], p2["a"]) and torch.equal(p1["b"], p2["b"])
    assert not torch.equal(p1["a"], p1["b"])                # leaf index in the seed
    assert not torch.equal(run(4, rng)["a"], p1["a"])       # step in the seed
    assert not torch.equal(run(3, torch.tensor([7, 10], dtype=torch.uint32))["a"], p1["a"])


# --------------------------------------------------------------------------- #
# Train state and step
# --------------------------------------------------------------------------- #
def test_init_train_state_layout():
    _, pcfg = _cfgs()
    st = init_train_state(pcfg, AdamConfig(), seed=3, device="cpu")
    assert st.step.dtype == torch.int32 and st.step.ndim == 0 and int(st.step) == 0
    assert st.rng.dtype == torch.uint32 and tuple(st.rng.shape) == (2,)
    assert torch.equal(st.rng, init_train_state(pcfg, AdamConfig(), seed=3, device="cpu").rng)
    assert not torch.equal(st.rng, init_train_state(pcfg, AdamConfig(), seed=4, device="cpu").rng)


def _port_state_from_jax(jstate, pcfg, popt):
    params = params_from_flat(jax_flatten(jstate.params), pcfg, "cpu")
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      rng=torch.from_numpy(np.array(jstate.rng)), params=params,
                      opt=adam_init(params, popt))


def test_train_steps_f32_vs_jax():
    jcfg, pcfg = _cfgs(compute_dtype="float32")
    kw = dict(lr=1e-3, warmup_steps=0, decay_steps=100)
    jopt, popt = jax_opt.AdamConfig(**kw), AdamConfig(**kw)
    jstate = jax_init_state(jcfg, jopt, jax.random.key(0))
    pstate = _port_state_from_jax(jstate, pcfg, popt)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, JaxTrainConfig()))
    pstep = make_train_step(pcfg, popt)
    data = SyntheticLMData(jcfg.vocab_size, 32, 4, seed=0)
    for s in range(3):
        b = data.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = pstep(pstate, {k: _t(v) for k, v in b.items()})
        assert set(pm) == set(jm) == {"ce", "loss", "grad_norm", "lr"}
        # f32 forward + backward through 2 layers in another summation order
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert int(pstate.step) == int(jstate.step) == 3
    # Adam's first steps divide each gradient by its own magnitude, so a
    # gradient near zero turns a 1e-7 relative difference into up to lr per
    # step; measured 2e-5 over 3 steps at lr 1e-3
    jflat = jax_flatten(jstate.params)
    for path, got in tree_items(pstate.params):
        np.testing.assert_allclose(got.numpy(), jflat[path], rtol=0, atol=1e-4, err_msg=path)


def test_grad_accum_equivalence():
    _, pcfg = _cfgs(compute_dtype="float32")
    opt = AdamConfig(grad_clip=0, warmup_steps=0)
    data = PortData(pcfg.vocab_size, 32, 8, seed=1)
    batch = {k: _t(v) for k, v in data.batch_at(0).items()}
    s1, m1 = make_train_step(pcfg, opt, TrainConfig(grad_accum=1))(
        init_train_state(pcfg, opt, seed=0, device="cpu"), batch)
    s4, m4 = make_train_step(pcfg, opt, TrainConfig(grad_accum=4))(
        init_train_state(pcfg, opt, seed=0, device="cpu"), batch)
    assert set(m4) == set(m1)
    # the mean of 4 microbatch means of equal size is the full-batch mean,
    # summed in another order (the reference test's tolerance)
    for (path, a), (_, b) in zip(tree_items(s1.params), tree_items(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5, err_msg=path)


def test_compress_pod_grads_waits_for_the_parallelism_slice():
    """The compressed step needs a mesh with a pod axis, as the reference's
    asserts (the step itself: tests/test_torch_parallel.py)."""
    _, pcfg = _cfgs()
    with pytest.raises(ValueError, match="'pod' axis"):
        make_train_step(pcfg, AdamConfig(), TrainConfig(compress_pod_grads=True))


def test_loss_decreases_on_tiny_model():
    _, pcfg = _cfgs()
    opt = AdamConfig(lr=3e-3, warmup_steps=2, decay_steps=60)
    state = init_train_state(pcfg, opt, seed=0, device="cpu")
    data = PortData(pcfg.vocab_size, 32, 8, seed=0)
    step_fn = make_train_step(pcfg, opt)
    losses = []
    for s in range(40):
        state, m = step_fn(state, {k: _t(v) for k, v in data.batch_at(s).items()})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.2, losses
