"""The port's SSM family (Mamba-2) against the JAX reference, on the CPU at a
small size: the SSD decode step, the causal conv, the block's prefill and
decode, and ``mamba2-130m`` reduced (2 layers, d 64, 8 heads of 16, d_state
16, chunk 32, vocab 128) through forward, prefill, greedy generation, loss
and gradients.

Weights come from the reference through the weight bridge, with the leaves
the reference initialises to constants (``A_log``, ``D``, ``dt_bias``,
``conv_b``) redrawn at random so that a term left out cannot hide; inputs are
numpy arrays from fixed seeds. Everything runs in float32, where the point is
the algorithm: the two frameworks differ only in summation order, hence
2e-5 on a block, 1e-4 through a model and 2e-4 for decode against forward
(``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tce.engine import flatten_pytree, unflatten_like  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.serve.engine import greedy_generate as jax_greedy_generate  # noqa: E402
from repro.serve.engine import prefill_fn as jax_prefill_fn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import blocks, model, ssm  # noqa: E402
from repro_torch.models.params import flatten_params, params_from_flat, tree_items  # noqa: E402
from repro_torch.serve.engine import (decode_fn, greedy_generate, pad_cache,  # noqa: E402
                                      prefill_fn)
from test_torch_models import _to_port, assert_config_is_the_references  # noqa: E402

ARCH = "mamba2-130m"
RANDOM_CONSTANTS = {"A_log": 0.5, "D": 1.0, "dt_bias": 0.5, "conv_b": 0.2}


def _cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _both(seed=0, **kw):
    """Reference config and weights, and the port's, from one flat dict."""
    jcfg, pcfg = _cfgs(**kw)
    jparams = jax_model.init_params(jcfg, jax.random.key(seed))
    flat = dict(flatten_pytree(jparams))
    rng = np.random.default_rng(seed + 100)
    for path, arr in flat.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in RANDOM_CONSTANTS:
            flat[path] = (rng.standard_normal(arr.shape) * RANDOM_CONSTANTS[leaf]).astype(arr.dtype)
    jparams = unflatten_like(jparams, flat)
    return jcfg, jparams, pcfg, params_from_flat(flat, pcfg, "cpu")


def _layer0(jparams, params):
    """The first layer's mixer params in each package."""
    jp = jax.tree.map(lambda t: t[0], jparams["segments"]["stack"]["l0"]["mix"])
    pp = {k: v[0] for k, v in params["segments"]["stack"]["l0"]["mix"].items()}
    return jp, pp


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# Config, params, the weight bridge
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_mamba2_config_equals_reference(reduced):
    port, ref = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        port, ref = port.reduced(), ref.reduced()
    assert_config_is_the_references(port, ref)
    assert port.n_params() == ref.n_params()
    assert [s.n_steps for s in blocks.segments(port)] == [port.n_layers]


def test_weight_bridge_takes_the_reference_mamba2_paths():
    jcfg, pcfg = _cfgs(compute_dtype="bfloat16")
    flat = flatten_pytree(jax_model.init_params(jcfg, jax.random.key(0)))
    params = params_from_flat(flat, pcfg, "cpu")
    back = flatten_params(params)
    assert list(back) == list(flat)
    for leaf in ("w_in", "conv_w", "conv_b", "A_log", "D", "dt_bias", "w_out"):
        assert f"segments/stack/l0/mix/{leaf}" in back
    assert "segments/stack/l0/norm1/scale" in back
    assert not any("norm2" in k or "mlp" in k for k in back)
    assert all(np.array_equal(back[k].numpy(), flat[k]) for k in flat)


def test_init_params_follow_the_reference_rules():
    _, pcfg = _cfgs()
    p = flatten_params(model.init_params(pcfg, seed=0, device="cpu"))
    jflat = flatten_pytree(jax_model.init_params(_cfgs()[0], jax.random.key(0)))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jflat.items()}
    mix = "segments/stack/l0/mix/"
    for leaf, value in (("A_log", 0.0), ("D", 1.0), ("dt_bias", 0.0), ("conv_b", 0.0)):
        assert torch.equal(p[mix + leaf], torch.full_like(p[mix + leaf], value)), leaf
    # normal: std = 1/sqrt(fan_in), fan_in = shape[-2] of one layer
    assert abs(p[mix + "w_in"].std().item() * np.sqrt(pcfg.d_model) - 1.0) < 0.05


def test_cache_struct_ssm_leaves():
    _, pcfg = _cfgs(compute_dtype="bfloat16")
    cache = blocks.cache_struct(pcfg, 3, 50, device="meta")["stack"]["l0"]
    d_in, nh, conv_dim = ssm.ssm_dims(pcfg)
    assert set(cache) == {"conv", "state"}
    assert cache["conv"].shape == (2, 3, 3, conv_dim) and cache["conv"].dtype == torch.bfloat16
    assert cache["state"].shape == (2, 3, nh, 16, 16) and cache["state"].dtype == torch.float32


def test_layer_spec_builds_every_reference_kind():
    """MoE and MLA layers build (the hybrid's SSM layers take MoE MLPs), and
    so do the encoder-decoder (a ``cross`` layer spec) and VLM families: the
    port refuses no layer kind of the reference."""
    for arch in ("jamba-v0.1-52b", "olmoe-1b-7b", "deepseek-v3-671b"):
        cfg = _to_port(jax_get_config(arch).reduced())
        kinds = {(sp.kind, sp.mlp) for seg in blocks.segments(cfg) for sp in seg.specs}
        assert kinds & {("ssm", "moe"), ("attn", "moe"), ("mla", "moe")}
    for arch in ("whisper-tiny", "qwen2-vl-2b"):
        cfg = _to_port(jax_get_config(arch).reduced())
        specs = [sp for seg in blocks.segments(cfg, cross=cfg.family == "encdec")
                 for sp in seg.specs]
        assert {sp.cross for sp in specs} == {cfg.family == "encdec"}
        assert model.param_shapes(cfg)["segments"]["stack"]["l0"]["mix"]["wq"].shape[0] == 2


# --------------------------------------------------------------------------- #
# The block's pieces
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_vs_jax(g):
    b, h, p, n = 2, 4, 8, 6
    args = [_rand((b, h, p, n), 1), _rand((b, h, p), 2), np.logaddexp(_rand((b, h), 3), 0),
            -np.exp(_rand((h,), 4, 0.3)), _rand((b, g, n), 5), _rand((b, g, n), 6)]
    want_y, want_s = jax_ssm.ssd_decode_step(*(jnp.asarray(a, jnp.float32) for a in args))
    y, s = ssm.ssd_decode_step(*(torch.from_numpy(np.asarray(a, np.float32)) for a in args))
    _close(y, want_y, 1e-5)
    _close(s, want_s, 1e-5)


@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
def test_causal_conv_vs_jax(with_init):
    b, s, c, k = 2, 9, 12, 4
    xbc, w, bias = _rand((b, s, c), 1), _rand((k, c), 2), _rand((c,), 3)
    init = _rand((b, k - 1, c), 4) if with_init else None
    want_y, want_tail = jax_ssm.causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias),
                                            None if init is None else jnp.asarray(init))
    y, tail = ssm.causal_conv(torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(bias),
                              None if init is None else torch.from_numpy(init))
    _close(y, want_y, 1e-5)
    _close(tail, want_tail, 0)


@pytest.mark.parametrize("seq,with_init", [(64, False), (17, False), (32, True)],
                         ids=["two_chunks", "one_short_chunk", "init"])
def test_ssm_forward_vs_jax(seq, with_init):
    jcfg, jparams, pcfg, params = _both(1)
    jp, pp = _layer0(jparams, params)
    d_in, nh, conv_dim = ssm.ssm_dims(pcfg)
    x = _rand((2, seq, pcfg.d_model), 7)
    init_conv = _rand((2, 3, conv_dim), 8) if with_init else None
    init_state = _rand((2, nh, 16, 16), 9, 0.3) if with_init else None
    jargs = [None if a is None else jnp.asarray(a) for a in (init_conv, init_state)]
    pargs = [None if a is None else torch.from_numpy(a) for a in (init_conv, init_state)]
    want, wcache = jax.jit(lambda p_, x_, *a: jax_ssm.ssm_forward(p_, x_, jcfg, *a))(
        jp, jnp.asarray(x), *jargs)
    for use_kernel in (False, True):     # on the CPU the kernel path is the plain version
        got, cache = ssm.ssm_forward(pp, torch.from_numpy(x), pcfg, *pargs, use_kernel=use_kernel)
        _close(got, want, 2e-5)
        _close(cache["conv"], wcache["conv"], 2e-5)
        _close(cache["state"], wcache["state"], 2e-5)
        assert cache["state"].dtype == torch.float32


def test_ssm_decode_vs_jax():
    jcfg, jparams, pcfg, params = _both(2)
    jp, pp = _layer0(jparams, params)
    d_in, nh, conv_dim = ssm.ssm_dims(pcfg)
    x, conv, state = _rand((2, 1, pcfg.d_model), 1), _rand((2, 3, conv_dim), 2), _rand((2, nh, 16, 16), 3)
    want = jax_ssm.ssm_decode(jp, jnp.asarray(x), jcfg, jnp.asarray(conv), jnp.asarray(state))
    got = ssm.ssm_decode(pp, torch.from_numpy(x), pcfg, torch.from_numpy(conv),
                         torch.from_numpy(state))
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


# --------------------------------------------------------------------------- #
# mamba2-130m reduced, the whole model
# --------------------------------------------------------------------------- #
def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_forward_logits_vs_jax():
    jcfg, jparams, pcfg, params = _both(3)
    tokens = _tokens(pcfg, 2, 64, 1)
    want, _, _, _ = jax_model.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, _, _, _ = model.forward(params, pcfg, {"tokens": torch.from_numpy(tokens).long()})
    _close(got, want, 1e-4)


def test_prefill_logits_and_cache_vs_jax():
    jcfg, jparams, pcfg, params = _both(4)
    tokens = _tokens(pcfg, 2, 64, 2)
    want_logits, want_cache = jax_prefill_fn(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, cache = prefill_fn(params, pcfg, {"tokens": torch.from_numpy(tokens).long()})
    _close(logits, want_logits, 1e-4)
    want_flat = flatten_pytree(want_cache)
    got_flat = dict(tree_items(cache))
    assert sorted(got_flat) == sorted(want_flat) == ["stack/l0/conv", "stack/l0/state"]
    for path, arr in want_flat.items():
        _close(got_flat[path], arr, 1e-4)


def test_greedy_generate_matches_jax():
    """Tokens over 6 steps: a decode that read the prefill state at every step
    instead of the updated one would diverge after the first."""
    jcfg, jparams, pcfg, params = _both(5)
    tokens = _tokens(pcfg, 2, 32, 3)
    gen = jax.jit(lambda p, t: jax_greedy_generate(p, jcfg, {"tokens": t}, steps=6))
    want = gen(jparams, jnp.asarray(tokens))
    got = greedy_generate(params, pcfg, {"tokens": torch.from_numpy(tokens).long()}, steps=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_steps_update_the_cache_in_place():
    """Decode after prefill == forward over the longer sequence, 4 steps in a
    row through one cache (tests/test_models.py decodes one step)."""
    _, _, cfg, params = _both(6)
    b, s, steps = 2, 17, 4
    tokens = torch.from_numpy(_tokens(cfg, b, s + steps - 1, 4)).long()
    with torch.no_grad():
        full, _, _, _ = model.forward(params, cfg, {"tokens": tokens}, mode="train")
        _, cache = prefill_fn(params, cfg, {"tokens": tokens[:, :s - 1]})
        cache = pad_cache(cfg, cache, b, s + steps)
        state_ptr = cache["stack"]["l0"]["state"].data_ptr()
        for i in range(steps):
            pos = torch.full((b,), s - 1 + i, dtype=torch.long)
            dec, cache = decode_fn(params, cfg, tokens[:, s - 1 + i], cache, pos)
            np.testing.assert_allclose(dec.numpy(), full[:, s - 1 + i].numpy(),
                                       rtol=2e-4, atol=2e-4)
    assert cache["stack"]["l0"]["state"].data_ptr() == state_ptr


def test_pad_cache_takes_ssm_leaves_as_they_are():
    _, _, cfg, params = _both(7)
    tokens = torch.from_numpy(_tokens(cfg, 2, 16, 5)).long()
    with torch.no_grad():
        _, cache = prefill_fn(params, cfg, {"tokens": tokens})
    padded = pad_cache(cfg, cache, 2, 64)
    for leaf in ("conv", "state"):
        assert padded["stack"]["l0"][leaf] is cache["stack"]["l0"][leaf]


def test_plain_and_kernel_impls_agree_on_cpu():
    _, _, cfg, params = _both(8, compute_dtype="bfloat16")
    tokens = torch.from_numpy(_tokens(cfg, 2, 64, 6)).long()
    with torch.no_grad():
        a, ca = prefill_fn(params, cfg, {"tokens": tokens}, attn_impl="kernel")
        b, cb = prefill_fn(params, cfg, {"tokens": tokens}, attn_impl="plain")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ca, cb, rtol=0, atol=0)
    with pytest.raises(ValueError):
        prefill_fn(params, cfg, {"tokens": tokens}, attn_impl="pallas")


def test_loss_and_grads_vs_jax():
    """Training runs the plain ssd_chunked in both packages; jax.grad of the
    reference loss against torch autograd of the port's."""
    jcfg, jparams, pcfg, params = _both(9)
    tokens, labels = _tokens(pcfg, 2, 64, 7), _tokens(pcfg, 2, 64, 8)
    labels[0, :5] = -1
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, jcfg, jbatch), has_aux=True))(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in tree_items(params)}
    loss, metrics = model.loss_fn(params, pcfg, {"tokens": torch.from_numpy(tokens).long(),
                                                 "labels": torch.from_numpy(labels).long()})
    loss.backward()
    _close(loss, want_loss, 1e-5)
    want_flat = flatten_pytree(want_grads)
    assert sorted(want_flat) == sorted(leaves)
    for path, g in want_flat.items():
        scale = float(np.abs(g).max()) + 1e-12
        err = float(np.abs(leaves[path].grad.numpy() - g).max())
        assert err / scale < 1e-4, (path, err, scale)


# --------------------------------------------------------------------------- #
# The serve CLI
# --------------------------------------------------------------------------- #
def test_serve_cli_runs_mamba2_on_cpu(capsys):
    res = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--requests", "2", "--prompt-len", "64", "--gen", "4"])
    assert res["cfg"].family == "ssm" and res["tokens"].shape == (2, 4)
    toks = res["tokens"].numpy()
    assert ((toks >= 0) & (toks < res["cfg"].vocab_size)).all()
    assert torch.isfinite(res["prefill_logits"].float()).all()
    assert "prefill:" in capsys.readouterr().out


@pytest.mark.parametrize("prompt_len,ok", [(20, True), (96, True), (40, False)])
def test_serve_cli_checks_the_prompt_length_against_the_chunk(prompt_len, ok):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "1",
            "--prompt-len", str(prompt_len), "--gen", "2"]
    if ok:
        assert serve_cli.main(argv)["tokens"].shape == (1, 2)
    else:
        with pytest.raises(ValueError, match="multiple"):
            serve_cli.main(argv)
