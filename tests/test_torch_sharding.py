"""The port's sharding rules against the JAX reference's, on the CPU.

``repro_torch.parallel.sharding`` copies the reference's rule tables and
``spec_for`` (first-wins, divisibility); here they are held to the
reference's entry by entry: on the reference's property over every rules
preset and mesh shape, on its first-wins and no-op cases, and on every
arch's parameter axes (``ParamBuilder``'s ``axes`` mode), cache axes and
Adam state axes at full config, through ``tree_specs`` on the production
meshes (256 and 512 chips, a ``LogicalMesh`` here, the reference's test
``_FakeMesh`` there). No process group is needed: a ``DeviceMesh`` and its
DTensors are exercised by ``tests/test_torch_parallel.py`` on gloo ranks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import param_axes as jax_param_axes  # noqa: E402
from repro.models import param_shapes as jax_param_shapes  # noqa: E402
from repro.parallel import sharding as jax_shd  # noqa: E402
from repro.train import AdamConfig as JaxAdamConfig  # noqa: E402
from repro.train import train_state_axes as jax_train_state_axes  # noqa: E402
from repro.train import train_state_shapes as jax_train_state_shapes  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import blocks, param_axes, param_shapes  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.train import AdamConfig, train_state_axes, train_state_shapes  # noqa: E402

LOGICAL = list(shd.DEFAULT_RULES.keys()) + [None, "unknown_axis"]
MESH_SHAPES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 4, "model": 2}]
PROD = {"pod256": False, "pod512": True}


class _FakeMesh:
    """The reference test's stand-in: axis names and a devices array."""

    def __init__(self, shape_map):
        self.axis_names = tuple(shape_map)
        self.devices = np.empty(tuple(shape_map.values()), object)


def _jax_ctx(shape_map, preset):
    ctx = jax_shd.ShardingContext.__new__(jax_shd.ShardingContext)
    ctx.mesh = _FakeMesh(shape_map)
    ctx.rules = dict(jax_shd.RULES_PRESETS[preset])
    return ctx


def _port_ctx(shape_map, preset):
    mesh = shd.LogicalMesh(tuple(shape_map), tuple(shape_map.values()))
    return shd.ShardingContext(mesh, shd.RULES_PRESETS[preset])


def _entries(spec):
    return tuple(spec)


# --------------------------------------------------------------------------- #
# Rule tables and spec_for
# --------------------------------------------------------------------------- #
def test_rule_tables_are_the_reference_tables():
    for name in ("PARAM_RULES", "ACT_RULES", "DEFAULT_RULES", "FSDP_RULES",
                 "MEGATRON_SP_RULES"):
        assert getattr(shd, name) == getattr(jax_shd, name), name
    assert shd.RULES_PRESETS == jax_shd.RULES_PRESETS


@st.composite
def axes_and_shape(draw):
    ndim = draw(st.integers(0, 5))
    axes = tuple(draw(st.sampled_from(LOGICAL)) for _ in range(ndim))
    shape = tuple(draw(st.sampled_from([1, 2, 3, 8, 16, 17, 64, 128, 256]))
                  for _ in range(ndim))
    return axes, shape


@given(aas=axes_and_shape(), mesh_shape=st.sampled_from(MESH_SHAPES),
       preset=st.sampled_from(sorted(shd.RULES_PRESETS)))
@settings(max_examples=150, deadline=None)
def test_spec_for_matches_the_reference_and_is_legal(aas, mesh_shape, preset):
    """The reference's property (no mesh axis twice, every used axis divides
    its dim), and the port's spec equals the reference's entry by entry."""
    axes, shape = aas
    spec = shd.spec_for(axes, shape, _port_ctx(mesh_shape, preset))
    assert _entries(spec) == _entries(jax_shd.spec_for(axes, shape, _jax_ctx(mesh_shape, preset)))
    used = []
    for dim, entry in enumerate(spec):
        total = 1
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            assert ax not in used, f"axis {ax} used twice in {spec}"
            used.append(ax)
            total *= mesh_shape[ax]
        assert shape[dim] % total == 0


def test_spec_for_first_wins_dedup():
    ctx = _port_ctx({"pod": 2, "data": 16, "model": 16}, "megatron")
    # batch takes (pod, data); cache_seq would also want them -> dropped
    spec = shd.spec_for(("batch", "cache_seq", "act_kv_heads", None), (128, 32768, 8, 128), ctx)
    assert spec[0] == ("pod", "data")
    assert len(spec) < 2 or spec[1] is None
    # with batch=1 the cache_seq dim picks them up instead
    spec = shd.spec_for(("batch", "cache_seq", "act_kv_heads", None), (1, 32768, 8, 128), ctx)
    assert spec[1] == ("pod", "data")


def test_constrain_noop_without_context_or_on_a_plain_tensor():
    x = torch.ones((4, 4))
    assert shd.constrain(x, ("batch", "act_embed")) is x
    assert shd.spec_for(("batch", "act_embed"), (4, 4)) == shd.P()
    with shd.use_sharding(make_production_mesh()) as ctx:
        assert ctx.n_devices == 256
        assert shd.constrain(x, ("batch", "act_embed")) is x


def test_production_meshes_and_n_devices():
    for multi_pod, axes, shape in ((False, ("data", "model"), (16, 16)),
                                   (True, ("pod", "data", "model"), (2, 16, 16))):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert (mesh.axis_names, mesh.axis_sizes) == (axes, shape)
        assert shd.ShardingContext(mesh).n_devices == int(np.prod(shape))


def test_multi_axis_rules_list_mesh_axes_in_mesh_order():
    """DTensor splits a dim over several mesh dims in mesh order, so every
    rule naming several axes must name them in the production mesh's order;
    ``placements`` refuses an entry that does not."""
    order = make_production_mesh(multi_pod=True).axis_names
    for preset, rules in shd.RULES_PRESETS.items():
        for name, rule in rules.items():
            if isinstance(rule, tuple):
                idx = [order.index(a) for a in rule]
                assert idx == sorted(idx), (preset, name, rule)
    mesh = make_production_mesh(multi_pod=True)
    pytest.importorskip("torch.distributed.tensor")
    from torch.distributed.tensor import Replicate, Shard
    assert shd.placements(shd.P(("pod", "data"), "model"), mesh) == [Shard(0), Shard(0), Shard(1)]
    assert shd.placements(shd.P(None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(shd.P(("data", "pod")), mesh)


def test_logical_and_device_contexts_do_not_nest():
    class _Dev:       # anything that is not a LogicalMesh is taken as a DeviceMesh
        mesh_dim_names, shape = ("data", "model"), (1, 1)

    with shd.use_sharding(make_production_mesh()):
        with pytest.raises(ValueError, match="cannot nest"):
            with shd.use_sharding(_Dev()):
                pass
        with shd.use_sharding(make_production_mesh(multi_pod=True)) as inner:
            assert inner.n_devices == 512
        assert shd.active().n_devices == 256
    assert shd.active() is None


# --------------------------------------------------------------------------- #
# Axes trees: every arch at full config
# --------------------------------------------------------------------------- #
def _flat(tree, prefix=""):
    """{path: axes tuple} of a nested dict whose leaves are axes tuples (or
    shape leaves), the reference's ``flatten_pytree`` paths."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], path))
        else:
            out[path] = tree[k]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_the_reference(arch):
    cfg = get_config(arch)
    port, ref = _flat(param_axes(cfg)), _flat(jax_param_axes(jax_get_config(arch)))
    assert port == {k: tuple(v) for k, v in ref.items()}
    shapes = dict(tree_items(param_shapes(cfg)))
    assert set(shapes) == set(port)
    for path, axes in port.items():
        assert len(axes) == len(shapes[path].shape), path


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_train_state_axes_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    enc_len = cfg.encdec.enc_len if cfg.encdec else None
    port = _flat(blocks.cache_struct(cfg, 2, 8, enc_len=enc_len, mode="axes"))
    ref = _flat(jax_blocks.cache_struct(jcfg, 2, 8, enc_len=enc_len, mode="axes"))
    assert port == ref
    for moment in ("float32", "bfloat16", "int8"):
        p = train_state_axes(cfg, AdamConfig(moment_dtype=moment))
        r = jax_train_state_axes(jcfg, JaxAdamConfig(moment_dtype=moment))
        assert (p.step, p.rng) == (r.step, r.rng)
        assert _flat(p.opt) == _flat(r.opt)
    with pytest.raises(ValueError, match="axes"):
        from repro_torch.models.params import ParamBuilder
        ParamBuilder("axes").param((4, 4), ("embed",))


def _port_specs(axes, shapes, mesh_name, preset):
    mesh = make_production_mesh(multi_pod=PROD[mesh_name])
    return _flat(shd.tree_specs(axes, shapes, mesh, shd.RULES_PRESETS[preset]))


def _ref_specs(axes, shapes, mesh_name, preset):
    shape_map = ({"pod": 2, "data": 16, "model": 16} if PROD[mesh_name]
                 else {"data": 16, "model": 16})
    specs = jax_shd.tree_specs(axes, shapes, _FakeMesh(shape_map),
                               jax_shd.RULES_PRESETS[preset])
    return {k: _entries(v) for k, v in _flat(specs).items()}


@pytest.mark.parametrize("mesh_name", sorted(PROD))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_match_the_reference_on_production_meshes(arch, mesh_name):
    """Params (serving and the train state's, moments included) and the
    decode cache, under every rules preset."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    enc_len = cfg.encdec.enc_len if cfg.encdec else None
    for preset in sorted(shd.RULES_PRESETS):
        port = _port_specs(param_axes(cfg), param_shapes(cfg), mesh_name, preset)
        ref = _ref_specs(jax_param_axes(jcfg), jax_param_shapes(jcfg), mesh_name, preset)
        assert {k: _entries(v) for k, v in port.items()} == ref, preset
        cache_p = _port_specs(blocks.cache_struct(cfg, 128, 32768, enc_len, mode="axes"),
                              blocks.cache_struct(cfg, 128, 32768, enc_len, device="meta"),
                              mesh_name, preset)
        cache_r = _ref_specs(jax_blocks.cache_struct(jcfg, 128, 32768, enc_len, mode="axes"),
                             jax_blocks.cache_struct(jcfg, 128, 32768, enc_len, mode="shape"),
                             mesh_name, preset)
        assert {k: _entries(v) for k, v in cache_p.items()} == cache_r, preset
    moment = "int8" if cfg.n_params() > 100e9 else "bfloat16"
    p_axes = train_state_axes(cfg, AdamConfig(moment_dtype=moment))
    p_state = train_state_shapes(cfg, AdamConfig(moment_dtype=moment))
    r_axes = jax_train_state_axes(jcfg, JaxAdamConfig(moment_dtype=moment))
    r_state = jax_train_state_shapes(jcfg, JaxAdamConfig(moment_dtype=moment))
    port = _port_specs(p_axes.opt, p_state.opt, mesh_name, "megatron")
    ref = _ref_specs(r_axes.opt, r_state.opt, mesh_name, "megatron")
    assert {k: _entries(v) for k, v in port.items()} == ref
    assert dict(tree_items(p_state.opt)).keys() == _flat(r_state.opt).keys()
    for path, leaf in tree_items(p_state.opt):
        want = _flat(r_state.opt)[path]
        assert (tuple(leaf.shape), str(leaf.dtype).split(".")[-1]) == (
            tuple(want.shape), jnp.dtype(want.dtype).name), path
