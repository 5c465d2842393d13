"""Stacked leaves split once per segment (``models/params.unstack``).

On reduced olmoe-1b-7b, deepseek-v2-lite-16b and mamba2-130m: the train
step's gradients against a forward that slices each layer with ``t[i]``
(written here), the autograd graph reaching every stacked leaf through one
``UnbindBackward0``, and the ``unstacked_leaves`` count of ``train.forward``.
Then the helper alone, and the backward it gives one stacked leaf.
"""
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models import blocks, init_params
from repro_torch.models.model import loss_fn
from repro_torch.models.params import tree_items, tree_like, tree_map, unstack
from repro_torch.train import AdamConfig, TrainState, adam_init, make_train_step, trainer
from repro_torch.train.state import init_rng

ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b", "mamba2-130m")
# the stacked leaves of each reduced config's segments: olmoe's one segment
# of 10, deepseek's prefix of 12 and stack of 16, mamba2's one of 8
STACKED_LEAVES = {"olmoe-1b-7b": 10, "deepseek-v2-lite-16b": 28, "mamba2-130m": 8}


def _setup(arch):
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed=7, device="cpu")
    g = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    return cfg, params, {"tokens": tokens, "labels": labels}


def _stacked_paths(params):
    return {f"segments/{p}" for p, _ in tree_items(params["segments"])}


def _sliced(tree, n):
    """The per-layer trees as one ``t[i]`` a leaf a layer."""
    return [tree_map(lambda t: t[i], tree) for i in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_a_per_layer_sliced_forward(arch, monkeypatch):
    cfg, params, batch = _setup(arch)
    got, _ = trainer._grads_and_metrics(params, cfg, batch, trainer.TrainConfig())
    monkeypatch.setattr(blocks, "unstack", _sliced)
    want, _ = trainer._grads_and_metrics(params, cfg, batch, trainer.TrainConfig())
    got, want = dict(tree_items(got)), dict(tree_items(want))
    assert set(got) == set(want) and _stacked_paths(params) <= set(got)
    for path in want:
        assert torch.equal(got[path], want[path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_each_stacked_leaf_is_reached_through_one_unbind(arch):
    cfg, params, batch = _setup(arch)
    paths, leaves = zip(*tree_items(params))
    tracked = [p.detach().requires_grad_(True) for p in leaves]
    path_of = {id(t): p for p, t in zip(paths, tracked)}
    with torch.enable_grad():
        loss, _ = loss_fn(tree_like(params, dict(zip(paths, tracked))), cfg, batch)
    consumers = {p: [] for p in paths}
    seen, todo = {id(loss.grad_fn)}, [loss.grad_fn]
    while todo:
        node = todo.pop()
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            var = getattr(nxt, "variable", None)
            if var is not None:
                consumers[path_of[id(var)]].append(node.name())
            if id(nxt) not in seen:
                seen.add(id(nxt))
                todo.append(nxt)
    stacked = _stacked_paths(params)
    assert len(stacked) == STACKED_LEAVES[arch]
    for path in stacked:
        assert consumers[path] == ["UnbindBackward0"], (path, consumers[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_counts_the_unstacked_leaves(arch):
    cfg, params, batch = _setup(arch)
    opt = AdamConfig(warmup_steps=0)
    state = TrainState(step=torch.zeros((), dtype=torch.int32), rng=init_rng(0),
                       params=params, opt=adam_init(params, opt))
    make_train_step(cfg, opt)(state, batch)
    fwd = [r for r in obs.spans() if r.name == "train.forward"][-1]
    per_segment = sum(len(list(tree_items(params["segments"][s.name])))
                      for s in blocks.segments(cfg))
    assert fwd.attrs["unstacked_leaves"] == per_segment == STACKED_LEAVES[arch]


def test_unstack_gives_the_layers_views_and_keeps_empty_subtrees():
    tree = {"a": torch.arange(12.0).reshape(3, 4).clone(), "norm": {},
            "b": {"c": torch.ones(3, 2)}}
    layers = unstack(tree, 3)
    assert len(layers) == 3
    for i, layer in enumerate(layers):
        assert layer["norm"] == {}
        assert torch.equal(layer["a"], tree["a"][i]) and layer["a"]._base is tree["a"]
        assert torch.equal(layer["b"]["c"], tree["b"]["c"][i])
    with pytest.raises(ValueError, match="leading axis 3, expected 4"):
        unstack(tree, 4)
    with obs.span("test.unstack") as s:
        unstack(tree, 3)
        unstack({"x": torch.zeros(2)}, 2)
    assert s.attrs["unstacked_leaves"] == 3


def test_backward_stacks_once_and_writes_no_zeros():
    """Under deterministic algorithms, four layers of one stacked leaf: one
    ``stack`` in the backward, where the per-layer slices give each layer a
    ``zeros`` of the whole stack and sum the four with three ``add_``; the
    gradients are equal."""
    w = torch.randn(4, 8, 8, generator=torch.Generator().manual_seed(3))
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(4))

    def grad(split):
        t = w.detach().requires_grad_(True)
        h = x
        for w_i in split({"w": t}, 4):
            h = torch.tanh(h @ w_i["w"])
        loss = h.square().sum()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            (g,) = torch.autograd.grad(loss, [t])
        return g, {e.key: e.count for e in prof.key_averages()}

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got, ops = grad(unstack)
        want, old = grad(_sliced)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(got, want)
    assert ops.get("aten::stack") == 1
    assert not {"aten::zeros", "aten::select_backward", "aten::add_"} & set(ops)
    assert old.get("aten::zeros") == 4 and old.get("aten::add_") == 3
    assert ops["aten::fill_"] < old["aten::fill_"]
