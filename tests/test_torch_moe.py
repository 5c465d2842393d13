"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against the
JAX reference (``repro.models.moe``) on the CPU, in float32: the router, the
load-balance loss, each of the three ``impl``s (``shard_map`` with no mesh
falls through to ``scatter`` in both packages), the token-major capacity
drops, the reference's grouping of a row into sequence chunks, and the
shared expert.

Weights come from the reference's ``moe_params`` and inputs are numpy arrays
from fixed seeds. Both packages do the same float32 arithmetic in other
summation orders, hence rtol = atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.params import ParamBuilder as JaxParamBuilder  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import ParamBuilder, flatten_params  # noqa: E402
from repro_torch.models.params import unflatten as _nest  # noqa: E402
from test_torch_models import _to_port  # noqa: E402

TOL = 1e-5


def _cfgs(arch="olmoe-1b-7b", **moe_kw):
    """Reference and port configs: the arch's reduced config in float32 with
    the MoE settings overridden."""
    jcfg = jax_get_config(arch).reduced()
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32",
                               moe=dataclasses.replace(jcfg.moe, **moe_kw))
    return jcfg, _to_port(jcfg)


def _params(jcfg, seed=0):
    """The reference's MoE params, and their flat {path: tensor} copy."""
    jp = jax_moe.moe_params(JaxParamBuilder("init", key=jax.random.key(seed)), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in flatten_params(jp).items()}


def _x(b, s, d, seed=3):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _both_forward(jcfg, pcfg, x, seed=0):
    jp, tp = _params(jcfg, seed)
    want_y, want_aux = jax.jit(lambda p, x_: jax_moe.moe_forward(p, x_, jcfg))(jp, jnp.asarray(x))
    y, aux = moe.moe_forward(_nest(tp), torch.from_numpy(x), pcfg)
    return (y, aux), (want_y, want_aux)


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_params_match_the_reference_tree(arch):
    jcfg, pcfg = _cfgs(arch)
    _, tp = _params(jcfg)
    port = flatten_params(moe.moe_params(ParamBuilder("shape"), pcfg))
    assert {k: v.shape for k, v in port.items()} == {k: tuple(v.shape) for k, v in tp.items()}
    want = {"router", "wi", "wg", "wo"} | ({"shared/wi", "shared/wg", "shared/wo"}
                                          if arch.startswith("deepseek") else set())
    assert set(port) == want


def test_router_init_scale():
    _, pcfg = _cfgs(d_ff_expert=64)
    gen = torch.Generator().manual_seed(0)
    pcfg = dataclasses.replace(pcfg, d_model=256, moe=dataclasses.replace(pcfg.moe, n_experts=64))
    p = moe.moe_params(ParamBuilder("init", generator=gen), pcfg)
    # normal init, std = scale / sqrt(fan_in) with the reference's router scale 0.02
    assert abs(p["router"].std().item() * np.sqrt(256) / 0.02 - 1) < 0.05


# --------------------------------------------------------------------------- #
# Router and load-balance loss
# --------------------------------------------------------------------------- #
def test_gate_picks_the_reference_experts():
    jcfg, pcfg = _cfgs(n_experts=8, top_k=3)
    jp, tp = _params(jcfg)
    x = _x(2, 40, pcfg.d_model)
    jprobs, jw, jidx = jax_moe._gate(jp, jnp.asarray(x), jcfg)
    probs, w, idx = moe._gate(_nest(tp), torch.from_numpy(x), pcfg)
    # no ties among the probabilities, so the order of a tie cannot matter
    srt = np.sort(np.asarray(jprobs), axis=-1)
    assert (np.diff(srt, axis=-1) > 0).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(probs, jprobs)
    _close(w, jw)


def test_aux_loss_vs_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 6)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = rng.integers(0, 6, (3, 7, 2))
    want = jax_moe._aux_loss(jnp.asarray(probs), jnp.asarray(idx, jnp.int32), 6)
    got = moe._aux_loss(torch.from_numpy(probs), torch.from_numpy(idx), 6)
    _close(got, want)


# --------------------------------------------------------------------------- #
# Dispatch: which tokens are dropped
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("capacity", [1, 3, 5, 12])
def test_dispatch_drops_the_reference_tokens(capacity):
    """The same routing through both dispatches: the same slot positions, the
    same kept slots, the same slot contents, group by group."""
    rng = np.random.default_rng(capacity)
    g, k, e, d = 12, 2, 4, 8
    x = rng.standard_normal((3, g, d)).astype(np.float32)
    idx = np.stack([np.stack([rng.choice(e, k, replace=False) for _ in range(g)])
                    for _ in range(3)])
    disp, (_, flat_e, slot_pos, keep) = moe._dispatch(torch.from_numpy(x), torch.from_numpy(idx),
                                                      e, capacity)
    for i in range(3):
        jdisp, (jflat_e, jslot, jkeep, _) = jax_moe._dispatch_one_group(
            jnp.asarray(x[i]), None, jnp.asarray(idx[i], jnp.int32), e, capacity)
        np.testing.assert_array_equal(flat_e[i].numpy(), np.asarray(jflat_e))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(slot_pos[i].numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(disp[i].numpy(), np.asarray(jdisp))
    if capacity < g * k // e:
        assert not bool(keep.all())


@pytest.mark.parametrize("b,s,want", [(2, 32, 1), (1, 256, 2), (1, 254, 1), (1, 255, 1), (1, 258, 2),
                                      (1, 128, 1), (2, 1024, 1), (1, 4096, 2)])
def test_groups_follow_the_reference_loop(b, s, want):
    assert moe._n_groups(b, s) == want


def test_capacity_of_the_full_configs():
    from repro_torch.configs import get_config
    # olmoe: 1024 tokens x top-8 / 64 experts x 1.25; jamba: top-2 of 16;
    # deepseek-v3: top-8 of 256; a decode step's group of one token
    assert moe.capacity_of(1024, get_config("olmoe-1b-7b")) == 160
    assert moe.capacity_of(1024, get_config("jamba-v0.1-52b")) == 160
    assert moe.capacity_of(1024, get_config("deepseek-v3-671b")) == 40
    assert moe.capacity_of(1, get_config("deepseek-v3-671b")) == 1


# --------------------------------------------------------------------------- #
# The whole layer
# --------------------------------------------------------------------------- #
CASES = {
    "dense": dict(impl="dense"),
    "scatter": dict(impl="scatter"),
    "shard_map_no_mesh": dict(impl="shard_map"),
    "scatter_overflow": dict(impl="scatter", capacity_factor=0.5),
    "scatter_8_experts_top3": dict(impl="scatter", n_experts=8, top_k=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_vs_jax(case):
    jcfg, pcfg = _cfgs(**CASES[case])
    x = _x(2, 32, pcfg.d_model)
    (y, aux), (want_y, want_aux) = _both_forward(jcfg, pcfg, x)
    _close(y, want_y)
    _close(aux, want_aux)


@pytest.mark.parametrize("impl", ["scatter", "shard_map"])
def test_one_row_of_256_tokens_splits_into_two_groups(impl):
    """b = 1, s = 256: two groups of 128, each with its own capacity (40 at
    factor 1.25; 16 at 0.5, which overflows)."""
    for factor in (1.25, 0.5):
        jcfg, pcfg = _cfgs(impl=impl, capacity_factor=factor)
        x = _x(1, 256, pcfg.d_model, seed=5)
        (y, aux), (want_y, want_aux) = _both_forward(jcfg, pcfg, x, seed=1)
        _close(y, want_y)
        _close(aux, want_aux)


def test_overflow_drops_tokens_and_changes_the_output():
    """At capacity factor 0.5 some routing slots are dropped in both packages
    (the layer differs from the no-drop one at exactly those tokens)."""
    jcfg, pcfg = _cfgs(impl="scatter", capacity_factor=0.5)
    _, ncfg = _cfgs(impl="scatter", capacity_factor=4.0)     # capacity = group: no drops
    x = _x(2, 32, pcfg.d_model, seed=6)
    (y, _), (want_y, _) = _both_forward(jcfg, pcfg, x, seed=2)
    _close(y, want_y)
    _, tp = _params(jcfg, seed=2)
    y_full, _ = moe.moe_forward(_nest(tp), torch.from_numpy(x), ncfg)
    _, _, idx = moe._gate(_nest(tp), torch.from_numpy(x), pcfg)
    _, (_, _, _, keep) = moe._dispatch(torch.from_numpy(x), idx, 4, moe.capacity_of(32, pcfg))
    dropped_tok = ~keep.reshape(2, 32, 2).all(-1)
    assert 0 < int(dropped_tok.sum()) < 64
    diff = (y - y_full).abs().amax(-1)
    assert bool((diff[dropped_tok] > 1e-4).all())
    assert float(diff[~dropped_tok].max()) < 1e-5


def test_scatter_without_drops_equals_dense():
    """With a capacity of the whole group no slot is dropped, and scatter
    computes the dense impl's function."""
    _, dcfg = _cfgs(impl="dense")
    _, scfg = _cfgs(impl="scatter", capacity_factor=2.0)    # 32 x 2 / 4 x 2 = 32
    jcfg, _ = _cfgs()
    _, tp = _params(jcfg, seed=3)
    x = torch.from_numpy(_x(2, 32, dcfg.d_model, seed=7))
    yd, ad = moe.moe_forward(_nest(tp), x, dcfg)
    ys, as_ = moe.moe_forward(_nest(tp), x, scfg)
    torch.testing.assert_close(ys, yd, rtol=TOL, atol=TOL)
    torch.testing.assert_close(as_, ad, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["dense", "scatter"])
def test_shared_expert_vs_jax(impl):
    jcfg, pcfg = _cfgs("deepseek-v3-671b", impl=impl)
    x = _x(2, 16, pcfg.d_model, seed=8)
    (y, aux), (want_y, want_aux) = _both_forward(jcfg, pcfg, x, seed=4)
    _close(y, want_y)
    _close(aux, want_aux)


def test_bf16_layer_is_close_to_jax():
    jcfg, pcfg = _cfgs(impl="scatter")
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    pcfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    x = _x(2, 32, pcfg.d_model, seed=9)
    (y, aux), (want_y, want_aux) = _both_forward(jcfg, pcfg, x, seed=5)
    assert y.dtype == torch.bfloat16
    want = np.asarray(want_y, np.float32)
    # bf16 (eps 2^-8) rounds the products and the combine's weighted sum in
    # other places in the two packages
    assert np.abs(y.float().numpy() - want).max() / np.abs(want).max() < 3e-2
    _close(aux, want_aux)


def test_unknown_impl_raises():
    _, pcfg = _cfgs(impl="nope")
    _, tp = _params(_cfgs()[0])
    with pytest.raises(ValueError):
        moe.moe_forward(_nest(tp), torch.zeros(1, 4, pcfg.d_model), pcfg)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_a_tokens_output_depends_on_its_group_when_slots_drop(package):
    """In both packages: a token alone (a decode step's group of one:
    capacity 1, nothing dropped) and the same token last in a longer group
    whose queues overflow (capacity factor 0.5) get different outputs. So prefill + decode matches a forward over the longer
    sequence only where no slot drops: the reduced configs run ``dense``,
    and a check at scatter raises the capacity to the whole group."""
    jcfg, pcfg = _cfgs(impl="scatter", capacity_factor=0.5)
    jp, tp = _params(jcfg, seed=6)
    x = _x(1, 32, pcfg.d_model, seed=10)
    if package == "port":
        whole, _ = moe.moe_forward(_nest(tp), torch.from_numpy(x), pcfg)
        alone, _ = moe.moe_forward(_nest(tp), torch.from_numpy(x[:, -1:]), pcfg)
        whole, alone = whole.numpy(), alone.numpy()
    else:
        whole = np.asarray(jax_moe.moe_forward(jp, jnp.asarray(x), jcfg)[0])
        alone = np.asarray(jax_moe.moe_forward(jp, jnp.asarray(x[:, -1:]), jcfg)[0])
    _, _, idx = moe._gate(_nest(tp), torch.from_numpy(x), pcfg)
    _, (_, _, _, keep) = moe._dispatch(torch.from_numpy(x), idx, 4, moe.capacity_of(32, pcfg))
    assert not bool(keep[0, -2:].all())                 # the last token lost a slot
    assert moe.capacity_of(1, pcfg) == 1
    assert np.abs(whole[:, -1] - alone[:, 0]).max() > 1e-3


GRAD_CASES = ("scatter", "shard_map_no_mesh", "scatter_overflow")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_moe_grads_vs_jax(case, arch):
    """Gradients through the capacity dispatch and combine (the full configs'
    path) match ``jax.grad`` of the reference's layer on every leaf (router,
    experts, deepseek's shared expert) and on x, dropped slots included, for
    a loss that weighs the output and the load-balance term."""
    jcfg, pcfg = _cfgs(arch, **CASES[case])
    jp, tp = _params(jcfg, seed=7)
    x = _x(2, 32, pcfg.d_model, seed=11)
    w = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x_):
        y, aux = jax_moe.moe_forward(p, x_, jcfg)
        return jnp.sum(y * w) + 0.5 * aux

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_forward(_nest(leaves), xt, pcfg)
    (torch.sum(y * torch.from_numpy(w)) + 0.5 * aux).backward()
    want = {k: np.asarray(v) for k, v in flatten_params(want_p).items()}
    assert set(want) == set(leaves)
    for k, v in leaves.items():
        _close(v.grad, want[k], 1e-4)
    _close(xt.grad, want_x, 1e-4)
    if case == "scatter_overflow":
        _, _, idx = moe._gate(_nest(tp), torch.from_numpy(x), pcfg)
        keep = moe._dispatch(torch.from_numpy(x), idx, pcfg.moe.n_experts,
                             moe.capacity_of(32, pcfg))[1][3]
        assert not bool(keep.all())
