"""The port's model stack (config, params, layers, forward) against the JAX
reference, on reduced llama3-8b (2 layers, d=64, 4 heads, 2 kv heads,
d_head 16, vocab 128). Inputs and weights are made once and handed to both:
weights through the weight bridge, inputs as numpy arrays from a fixed seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tce.engine import flatten_pytree  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from repro_torch.models.params import flatten_params, params_from_flat  # noqa: E402


def _cfg(**kw):
    return dataclasses.replace(get_config("llama3-8b").reduced(), **kw)


def _jax_cfg(**kw):
    return dataclasses.replace(jax_get_config("llama3-8b").reduced(), **kw)


def _to_port(jcfg):
    """The port's ModelConfig with the same field values as a reference one."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        val = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(val):
            val = getattr(port_config, type(val).__name__)(**dataclasses.asdict(val))
        kw[f.name] = val
    return port_config.ModelConfig(**kw)


def assert_config_is_the_references(port, ref):
    """Every field the reference's config has is equal in the port's, nested
    configs field by field, and every port-only field sits at its default
    (``models/config.py``: at their defaults they are the reference's
    behaviour)."""
    names = {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        got = getattr(port, f.name)
        if f.name not in names:
            assert got == f.default, (type(port).__name__, f.name, got)
        elif dataclasses.is_dataclass(got):
            assert_config_is_the_references(got, getattr(ref, f.name))
        else:
            assert got == getattr(ref, f.name), (type(port).__name__, f.name)
    assert names <= {f.name for f in dataclasses.fields(port)}


def _bridge(jcfg, seed=0):
    """Reference weights, and their flat {path: ndarray} form."""
    jparams = jax_model.init_params(jcfg, jax.random.key(seed))
    return flatten_pytree(jparams), jparams


# --------------------------------------------------------------------------- #
# Config
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_llama3_config_equals_reference(reduced):
    port, ref = get_config("llama3-8b"), jax_get_config("llama3-8b")
    if reduced:
        port, ref = port.reduced(), ref.reduced()
    assert_config_is_the_references(port, ref)
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()


def test_llama3_param_count():
    assert get_config("llama3-8b").n_params() == 8_030_257_152


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_config_copy_counts_every_reference_arch(arch):
    ref = jax_get_config(arch)
    port = _to_port(ref)
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()
    assert_config_is_the_references(port.reduced(), ref.reduced())


def test_every_reference_arch_resolves_and_unknown_raises():
    """The encoder-decoder and VLM archs, the last two the port took, resolve
    to the reference's configs, and only a name outside the registry raises
    (ValueError)."""
    for arch in ("whisper-tiny", "qwen2-vl-2b"):
        assert_config_is_the_references(get_config(arch), jax_get_config(arch))
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


# --------------------------------------------------------------------------- #
# Params and the weight bridge
# --------------------------------------------------------------------------- #
def test_weight_bridge_round_trip_is_bit_exact():
    jcfg = _jax_cfg()
    flat, _ = _bridge(jcfg)
    params = params_from_flat(flat, _cfg(), "cpu")
    back = flatten_params(params)
    assert list(back) == list(flat)          # same paths, same (sorted) order
    assert "segments/stack/l0/mix/wq" in back
    assert back["segments/stack/l0/mix/wq"].shape == (2, 64, 64)
    for path, arr in flat.items():
        got = back[path].numpy()
        assert got.dtype == arr.dtype and got.shape == arr.shape, path
        assert np.array_equal(got, arr), path


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_weight_bridge_rejects_mismatch(fault):
    flat, _ = _bridge(_jax_cfg())
    flat = dict(flat)
    if fault == "missing":
        flat.pop("norm_f/scale")
    elif fault == "extra":
        flat["tok/bogus"] = np.zeros(3, np.float32)
    elif fault == "shape":
        flat["tok/table"] = flat["tok/table"][:-1]
    else:
        flat["tok/head"] = flat["tok/head"].astype(np.float64)
    with pytest.raises((KeyError, ValueError)):
        params_from_flat(flat, _cfg(), "cpu")


def test_init_params_tree_scales_and_seed():
    cfg = _cfg()
    p = flatten_params(model.init_params(cfg, seed=0, device="cpu"))
    want, _ = _bridge(_jax_cfg())
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in p.values())
    # normal: std = 1/sqrt(fan_in) with fan_in = shape[-2] of one layer
    wi = p["segments/stack/l0/mlp/wi"]
    assert abs(wi.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(p["tok/table"].std().item() - 0.02) < 0.002
    assert torch.equal(p["norm_f/scale"], torch.ones(cfg.d_model))
    again = flatten_params(model.init_params(cfg, seed=0, device="cpu"))
    other = flatten_params(model.init_params(cfg, seed=1, device="cpu"))
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["tok/head"], other["tok/head"])
    bf = flatten_params(model.init_params(cfg, seed=0, device="cpu", dtype="bfloat16"))
    assert torch.equal(bf["tok/head"], p["tok/head"].bfloat16())


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(repro_torch.DeviceUnavailable):
        model.init_params(_cfg(), seed=0)


# --------------------------------------------------------------------------- #
# Layers (float32, 1e-5)
# --------------------------------------------------------------------------- #
def _arr(*shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm_vs_jax(norm):
    x = _arr(2, 5, 64) * 3
    p = {"scale": _arr(64, seed=1), "bias": _arr(64, seed=2)}
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), _cfg(norm=norm))
    want = jax_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), _jax_cfg(norm=norm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("partial", [1.0, 0.75])
def test_apply_rope_vs_jax(partial):
    x = _arr(2, 9, 4, 16)
    pos = np.random.default_rng(3).integers(0, 4096, size=(2, 9))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5, partial)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 5e5, partial)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_apply_rope_mrope_sections_must_cover_half_rot():
    """M-RoPE runs (``tests/test_torch_encdec_vlm.py`` holds it to the
    reference), and ``apply_rope`` rejects sections that do not cover half
    the rotated dims, which the reference asserts."""
    x, pos = torch.zeros(1, 2, 1, 16), torch.zeros(3, 1, 2)
    assert layers.apply_rope(x, pos, 1e4, 1.0, (2, 3, 3)).shape == x.shape
    for sections in ((2, 3, 2), (4, 3, 3)):
        with pytest.raises(ValueError, match="do not sum"):
            layers.apply_rope(x, pos, 1e4, 1.0, sections)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp_vs_jax(act):
    cfgp, cfgj = _cfg(activation=act, compute_dtype="float32"), _jax_cfg(activation=act, compute_dtype="float32")
    x = _arr(2, 5, 64)
    p = {"wi": _arr(64, 128, seed=1) / 8, "wg": _arr(64, 128, seed=2) / 8,
         "wo": _arr(128, 64, seed=3) / 11}
    if act == "gelu":
        p.pop("wg")
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), cfgp)
    want = jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfgj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# Whole forward
# --------------------------------------------------------------------------- #
def _forward_both(compute_dtype, scan_layers, mode="prefill", seed=0):
    jcfg = _jax_cfg(compute_dtype=compute_dtype, scan_layers=scan_layers)
    pcfg = _cfg(compute_dtype=compute_dtype, scan_layers=scan_layers)
    flat, jparams = _bridge(jcfg, seed)
    params = params_from_flat(flat, pcfg, "cpu")
    tokens = np.random.default_rng(seed + 5).integers(0, jcfg.vocab_size, (2, 32))
    jl, jc, _, _ = jax_model.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens, jnp.int32)}, mode=mode)
    with torch.no_grad():
        pl, pc, _, _ = model.forward(params, pcfg, {"tokens": torch.from_numpy(tokens)}, mode=mode)
    return jl, jc, pl, pc


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scan", "unrolled"])
def test_forward_f32_vs_jax(scan_layers):
    jl, jc, pl, pc = _forward_both("float32", scan_layers)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    # the prefill cache keeps the reference's stacked layout
    jflat, pflat = flatten_pytree(jc), flatten_params(pc)
    assert list(jflat) == list(pflat) == ["stack/l0/k", "stack/l0/v"]
    for path in jflat:
        np.testing.assert_allclose(pflat[path].numpy(), jflat[path], rtol=1e-4, atol=1e-4)


def test_forward_train_mode_has_no_cache():
    jl, jc, pl, pc = _forward_both("float32", False, mode="train")
    assert jc is None and pc is None
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_forward_bf16_vs_jax():
    # bf16 keeps 8 significant bits (eps 2^-8 = 3.9e-3) and the two frameworks
    # round matmul outputs, residual adds and softmax weights at different
    # places; over two layers that stays within a few eps of the logits' scale.
    jl, _, pl, _ = _forward_both("bfloat16", False)
    want = np.asarray(jl, np.float32)
    got = pl.float().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 3e-2
