"""The port's multi-head latent attention (``repro_torch.models.mla``) against
the JAX reference (``repro.models.mla``) on the CPU in float32: the latents,
the reconstructing forward, the absorbed decode over the latent cache, and
the absorbed decode against the reconstructing forward in each package.

Weights come from the reference's ``mla_params`` with the two scales redrawn
at random (the reference initialises them to ones, where a scale left out
could hide); inputs are numpy arrays from fixed seeds. rtol = atol 1e-5: the
same float32 arithmetic in other summation orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models.params import ParamBuilder as JaxParamBuilder  # noqa: E402
from repro_torch.models import blocks, mla  # noqa: E402
from repro_torch.models.params import ParamBuilder, flatten_params  # noqa: E402
from test_torch_models import _to_port  # noqa: E402

TOL = 1e-5


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config("deepseek-v3-671b").reduced(), compute_dtype=dtype)
    return jcfg, _to_port(jcfg)


def _params(jcfg, seed=0):
    jp = jax_mla.mla_params(JaxParamBuilder("init", key=jax.random.key(seed)), jcfg)
    rng = np.random.default_rng(seed + 50)
    flat = {k: np.asarray(v) for k, v in jp.items()}
    for k in ("q_scale", "kv_scale"):
        flat[k] = (1 + 0.5 * rng.standard_normal(flat[k].shape)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in flat.items()},
            {k: torch.from_numpy(v.copy()) for k, v in flat.items()})


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _positions(b, s):
    return np.broadcast_to(np.arange(s), (b, s)).copy()


def test_mla_params_match_the_reference_tree():
    jcfg, pcfg = _cfgs()
    jp, _ = _params(jcfg)
    port = flatten_params(mla.mla_params(ParamBuilder("shape"), pcfg))
    assert {k: v.shape for k, v in port.items()} == {k: tuple(v.shape) for k, v in jp.items()}


def test_rms_vs_jax():
    x = _rand((3, 5, 16), 1) * 4
    _close(mla._rms(torch.from_numpy(x)), jax_mla._rms(jnp.asarray(x)))


def test_latents_vs_jax():
    jcfg, pcfg = _cfgs()
    jp, tp = _params(jcfg, 1)
    x, pos = _rand((2, 9, pcfg.d_model), 2), _positions(2, 9) + 3
    want = jax_mla._latents(jp, jnp.asarray(x), jcfg, jnp.asarray(pos, jnp.int32))
    got = mla._latents(tp, torch.from_numpy(x), pcfg, torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)


def test_mla_forward_vs_jax():
    jcfg, pcfg = _cfgs()
    jp, tp = _params(jcfg, 2)
    x, pos = _rand((2, 24, pcfg.d_model), 3), _positions(2, 24)
    want_y, want_c = jax_mla.mla_forward(jp, jnp.asarray(x), jcfg, jnp.asarray(pos, jnp.int32))
    y, cache = mla.mla_forward(tp, torch.from_numpy(x), pcfg, torch.from_numpy(pos))
    _close(y, want_y)
    assert sorted(cache) == sorted(want_c) == ["ckv", "kpe"]
    for k in cache:
        _close(cache[k], want_c[k])


def test_mla_decode_vs_jax():
    """One absorbed step over a cache with history: the same output and the
    same caches, the new latents written at ``pos`` (different per row)."""
    jcfg, pcfg = _cfgs()
    m = pcfg.mla
    jp, tp = _params(jcfg, 3)
    b, t = 2, 12
    x = _rand((b, 1, pcfg.d_model), 4)
    ckv, kpe = _rand((b, t, m.kv_lora_rank), 5), _rand((b, t, m.qk_rope_dim), 6)
    pos = np.array([5, 9])
    want = jax_mla.mla_decode(jp, jnp.asarray(x), jcfg, jnp.asarray(ckv), jnp.asarray(kpe),
                              jnp.asarray(pos, jnp.int32))
    c_ckv, c_kpe = torch.from_numpy(ckv.copy()), torch.from_numpy(kpe.copy())
    got = mla.mla_decode(tp, torch.from_numpy(x), pcfg, c_ckv, c_kpe, torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)
    assert got[1] is c_ckv and got[2] is c_kpe          # written in place


@pytest.mark.parametrize("package", ["port", "reference"])
def test_absorbed_decode_equals_the_reconstructing_forward(package):
    """Forward over s tokens, against the latents of the first s - 1 and an
    absorbed step at position s - 1: the same output at that position."""
    jcfg, pcfg = _cfgs()
    jp, tp = _params(jcfg, 4)
    b, s = 2, 17
    x, pos = _rand((b, s, pcfg.d_model), 7), _positions(b, s)
    last = np.full((b,), s - 1)
    if package == "port":
        y, _ = mla.mla_forward(tp, torch.from_numpy(x), pcfg, torch.from_numpy(pos))
        _, c = mla.mla_forward(tp, torch.from_numpy(x[:, :-1]), pcfg, torch.from_numpy(pos[:, :-1]))
        ckv = torch.zeros(b, s + 3, pcfg.mla.kv_lora_rank)
        kpe = torch.zeros(b, s + 3, pcfg.mla.qk_rope_dim)
        ckv[:, :s - 1], kpe[:, :s - 1] = c["ckv"], c["kpe"]
        dec, _, _ = mla.mla_decode(tp, torch.from_numpy(x[:, -1:]), pcfg, ckv, kpe,
                                   torch.from_numpy(last))
    else:
        y, _ = jax_mla.mla_forward(jp, jnp.asarray(x), jcfg, jnp.asarray(pos, jnp.int32))
        _, c = jax_mla.mla_forward(jp, jnp.asarray(x[:, :-1]), jcfg,
                                   jnp.asarray(pos[:, :-1], jnp.int32))
        ckv = jnp.zeros((b, s + 3, jcfg.mla.kv_lora_rank)).at[:, :s - 1].set(c["ckv"])
        kpe = jnp.zeros((b, s + 3, jcfg.mla.qk_rope_dim)).at[:, :s - 1].set(c["kpe"])
        dec, _, _ = jax_mla.mla_decode(jp, jnp.asarray(x[:, -1:]), jcfg, ckv, kpe,
                                       jnp.asarray(last, jnp.int32))
    # the absorbed form reassociates the products: a few float32 roundings
    _close(dec[:, 0], np.asarray(y[:, -1]), 1e-4)


def test_bf16_forward_is_close_to_jax():
    jcfg, pcfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg, 5)
    x, pos = _rand((2, 16, pcfg.d_model), 8), _positions(2, 16)
    want, _ = jax_mla.mla_forward(jp, jnp.asarray(x), jcfg, jnp.asarray(pos, jnp.int32))
    got, _ = mla.mla_forward(tp, torch.from_numpy(x), pcfg, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() / np.abs(want).max() < 3e-2


def test_cache_struct_holds_the_latents():
    _, pcfg = _cfgs("bfloat16")
    cache = blocks.cache_struct(pcfg, 3, 40, device="meta")
    assert sorted(cache) == ["prefix", "stack"]
    for seg, steps in (("prefix", 1), ("stack", 3)):
        leaves = cache[seg]["l0"]
        assert sorted(leaves) == ["ckv", "kpe"]
        assert leaves["ckv"].shape == (steps, 3, 40, pcfg.mla.kv_lora_rank)
        assert leaves["kpe"].shape == (steps, 3, 40, pcfg.mla.qk_rope_dim)
        assert leaves["ckv"].dtype == torch.bfloat16
