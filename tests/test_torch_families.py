"""The port's model families against the JAX reference on the CPU: every
decoder-only arch of the reference, on its reduced config.

The three dense archs (``olmo-1b``, ``phi4-mini-3.8b``, ``yi-34b``) take
the dense layers already ported, through their norms (non-parametric
LayerNorm), tied embeddings and partial RoPE; ``olmoe-1b-7b`` is the MoE
family, ``jamba-v0.1-52b`` the SSM + attention hybrid with MoE on odd
layers, and ``deepseek-v3-671b`` MLA with a dense prefix segment, a shared
expert and the MTP head.

For each, as ``tests/test_torch_models.py`` and ``tests/test_torch_ssm.py``
do for llama3 and mamba2: the config equals the reference's, the flat
parameter paths are the reference's, forward logits, ``aux`` and the prefill
cache match in float32 at 1e-4 and in bf16 within 3e-2 of the logits'
scale, ``loss_fn`` (MoE aux and MTP terms included) and its gradient on
every leaf match ``jax.grad`` of the reference's at 1e-4, greedy tokens are
equal, and decode after prefill matches the forward (2e-4,
``tests/test_models.py``). Weights come from the reference through the
weight bridge, with every leaf the reference initialises to a constant
(norm scales, the MLA scales, the SSM's ``A_log``, ``D``, ``dt_bias`` and
conv bias) redrawn at random so that a term left out cannot hide; inputs
are numpy arrays from fixed seeds. Then the serve CLI and the training
launcher on the new archs, and checkpoints of reduced ``olmoe-1b-7b`` that
cross between the two packages' ``DiskStore``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tce import sharding as jax_sharding  # noqa: E402
from repro.core.tce.engine import flatten_pytree, unflatten_like  # noqa: E402
from repro.core.tce.store import DiskStore as JaxDiskStore  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serve.engine import greedy_generate as jax_greedy_generate  # noqa: E402
from repro.serve.engine import prefill_fn as jax_prefill_fn  # noqa: E402
from repro.train import AdamConfig as JaxAdamConfig  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.tce import DiskStore, sharding  # noqa: E402
from repro_torch.core.tce.engine import flatten_pytree as port_flatten  # noqa: E402
from repro_torch.core.tce.engine import unflatten_like as port_unflatten  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import blocks, model  # noqa: E402
from repro_torch.models.params import flatten_params, params_from_flat, tree_items  # noqa: E402
from repro_torch.serve.engine import decode_fn, greedy_generate, pad_cache, prefill_fn  # noqa: E402
from repro_torch.substrate.worker import LOSSLESS_PATHS  # noqa: E402
from repro_torch.train import AdamConfig, init_train_state  # noqa: E402
from test_torch_models import assert_config_is_the_references  # noqa: E402

NEW_ARCHS = ("olmo-1b", "phi4-mini-3.8b", "yi-34b", "olmoe-1b-7b", "jamba-v0.1-52b",
             "deepseek-v3-671b")
# leaf name -> how it is redrawn: "one" ~ 1 + 0.3 N(0, 1), else scale x N(0, 1)
RANDOM_CONSTANTS = {"A_log": 0.5, "D": 1.0, "dt_bias": 0.5, "conv_b": 0.2, "bias": 0.1,
                    "scale": "one", "q_scale": "one", "kv_scale": "one"}
SEQ = 32                     # one SSD chunk of the reduced jamba


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _both(arch, seed=0, **kw):
    """Reference config and weights, and the port's, from one flat dict."""
    jcfg, pcfg = _cfgs(arch, **kw)
    jparams = jax_model.init_params(jcfg, jax.random.key(seed))
    flat = dict(flatten_pytree(jparams))
    rng = np.random.default_rng(seed + 100)
    for path, arr in flat.items():
        how = RANDOM_CONSTANTS.get(path.rsplit("/", 1)[-1])
        if how == "one":
            flat[path] = (1 + 0.3 * rng.standard_normal(arr.shape)).astype(arr.dtype)
        elif how is not None:
            flat[path] = (rng.standard_normal(arr.shape) * how).astype(arr.dtype)
    return jcfg, unflatten_like(jparams, flat), pcfg, params_from_flat(flat, pcfg, "cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                                          np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# Registry, configs, params
# --------------------------------------------------------------------------- #
def test_registry_holds_every_reference_arch():
    """The registry is the reference's: every decoder-only arch, the
    encoder-decoder and the VLM."""
    from repro.configs import ARCHS as JAX_ARCHS
    assert set(ARCHS) >= {"llama3-8b", "mamba2-130m", *NEW_ARCHS}
    assert ARCHS == JAX_ARCHS
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("whisper-large")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, reduced):
    port, ref = get_config(arch), jax_get_config(arch)
    if reduced:
        port, ref = port.reduced(), ref.reduced()
    assert_config_is_the_references(port, ref)
    assert port.n_params() == ref.n_params()
    assert port.n_active_params() == ref.n_active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_segments_equal_the_reference(arch):
    from repro.models import blocks as jax_blocks
    for cfg_of in (get_config, lambda a: get_config(a).reduced()):
        pcfg = cfg_of(arch)
        jcfg = jax_get_config(arch) if cfg_of is get_config else jax_get_config(arch).reduced()
        want = [(s.name, s.n_steps, [(sp.kind, sp.mlp) for sp in s.specs])
                for s in jax_blocks.segments(jcfg)]
        got = [(s.name, s.n_steps, [(sp.kind, sp.mlp) for sp in s.specs])
               for s in blocks.segments(pcfg)]
        assert got == want


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_flat_param_paths_equal_the_reference(arch):
    jcfg, pcfg = _cfgs(arch, compute_dtype="bfloat16")
    flat = flatten_pytree(jax_model.init_params(jcfg, jax.random.key(0)))
    back = flatten_params(params_from_flat(flat, pcfg, "cpu"))
    assert list(back) == list(flat)
    assert all(np.array_equal(back[k].numpy(), flat[k]) for k in flat)
    mine = flatten_params(model.init_params(pcfg, seed=0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in flat.items()}


def test_weight_bridge_carries_the_new_leaves():
    """The router, the stacked experts, the shared expert, the MLA
    projections and the MTP head, under the reference's names."""
    jcfg, pcfg = _cfgs("deepseek-v3-671b")
    flat = flatten_pytree(jax_model.init_params(jcfg, jax.random.key(0)))
    back = flatten_params(params_from_flat(flat, pcfg, "cpu"))
    for path in ("segments/stack/l0/mlp/router", "segments/stack/l0/mlp/wi",
                 "segments/stack/l0/mlp/shared/wo", "segments/stack/l0/mix/w_uk",
                 "segments/prefix/l0/mlp/wg", "segments/prefix/l0/mix/kv_scale",
                 "mtp/proj", "mtp/norm_e/scale", "mtp/layer/mix/w_dq", "mtp/layer/mlp/router"):
        assert path in back, path
    assert back["segments/stack/l0/mlp/wi"].shape == (3, 4, 64, 64)      # (steps, E, d, ff)
    assert back["segments/prefix/l0/mlp/wi"].shape == (1, 64, 128)
    assert back["mtp/proj"].shape == (128, 64)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_weight_bridge_rejects_a_mismatch_in_the_new_leaves(fault):
    jcfg, pcfg = _cfgs("deepseek-v3-671b")
    flat = dict(flatten_pytree(jax_model.init_params(jcfg, jax.random.key(0))))
    if fault == "missing":
        flat.pop("mtp/proj")
    elif fault == "extra":
        flat["segments/stack/l0/mlp/bogus"] = np.zeros(3, np.float32)
    else:
        flat["segments/stack/l0/mlp/router"] = flat["segments/stack/l0/mlp/router"][..., :-1]
    with pytest.raises((KeyError, ValueError)):
        params_from_flat(flat, pcfg, "cpu")


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_model_params_builds_encdec_and_vlm(family):
    """``model_params`` builds both families with the reference's parameter
    shapes (``tests/test_torch_encdec_vlm.py`` holds the rest)."""
    from test_torch_models import _to_port
    arch = {"encdec": "whisper-tiny", "vlm": "qwen2-vl-2b"}[family]
    jcfg = jax_get_config(arch).reduced()
    got = {k: v.shape for k, v in flatten_params(model.param_shapes(_to_port(jcfg))).items()}
    want = {k: tuple(v.shape) for k, v in
            flatten_pytree(jax_model.init_params(jcfg, jax.random.key(0))).items()}
    assert got == want
    assert any(k.startswith("encoder/") for k in got) == (family == "encdec")


# --------------------------------------------------------------------------- #
# Forward, prefill cache, loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_prefill_cache_f32_vs_jax(arch):
    jcfg, jparams, pcfg, params = _both(arch, 1)
    tokens = _tokens(pcfg, 2, SEQ, 1)
    jl, jc, jaux, _ = jax.jit(lambda p, t: jax_model.forward(p, jcfg, {"tokens": t},
                                                             mode="prefill"))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        pl, pc, paux, _ = model.forward(params, pcfg, {"tokens": torch.from_numpy(tokens).long()},
                                        mode="prefill")
    _close(pl, jl, 1e-4)
    _close(paux, jaux, 1e-4)
    if pcfg.moe is not None:
        assert float(paux) > 0
    jflat, pflat = flatten_pytree(jc), dict(tree_items(pc))
    assert list(pflat) == list(jflat)
    for path, arr in jflat.items():
        _close(pflat[path], arr, 1e-4)


def _record_routing(monkeypatch):
    """Each MoE layer's router output, in call order, in both packages (the
    reference runs op by op, so its values are concrete)."""
    from repro.models import moe as jax_moe
    from repro_torch.models import moe as port_moe
    seen = {"ref": [], "port": []}

    def wrap(mod, key, to_np):
        gate = mod._gate

        def recording(p, x, cfg):
            out = gate(p, x, cfg)
            seen[key].append((to_np(out[0]), to_np(out[2])))
            return out
        monkeypatch.setattr(mod, "_gate", recording)

    wrap(jax_moe, "ref", np.asarray)
    wrap(port_moe, "port", lambda t: t.numpy())
    return seen


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_bf16_vs_jax(arch, monkeypatch):
    """bf16 keeps 8 significant bits, and the two frameworks round matmul
    outputs, residual adds and softmax weights in different places (XLA
    rounds a fused elementwise chain once). Limit: 3e-2 of the logits'
    scale, or the reference's own bf16 distance from its float32 forward
    where that is larger (the reduced jamba's bf16 SSM layers: 4.4e-2 at
    this seed). An MoE router can pick another expert where two of its
    probabilities nearly tie, and the two packages' roundings then route a
    token differently: a discrete change of the output. So every routing
    that differs must be a near tie (the k-th and (k+1)-th probabilities
    within 1e-2), at most an eighth of the tokens may differ, and the
    logits are compared in each row before its first token routed
    differently in any layer (attention is causal, so those positions never
    see a differing route)."""
    seen = _record_routing(monkeypatch)
    jcfg, jparams, pcfg, params = _both(arch, 2, compute_dtype="bfloat16")
    jcfg32, jparams32, _, _ = _both(arch, 2)
    tokens = _tokens(pcfg, 2, SEQ, 2)
    exact = np.asarray(jax_model.forward(jparams32, jcfg32, {"tokens": jnp.asarray(tokens)})[0])
    seen["ref"].clear()
    jl = np.asarray(jax_model.forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})[0],
                    np.float32)
    with torch.no_grad():
        pl, _, _, _ = model.forward(params, pcfg, {"tokens": torch.from_numpy(tokens).long()})
    assert pl.dtype == torch.bfloat16
    differ = np.zeros(tokens.shape, bool)
    assert len(seen["ref"]) == len(seen["port"]) == sum(
        pcfg.mlp_kind(i) == "moe" for i in range(pcfg.n_layers))
    for (jprobs, jidx), (_, pidx) in zip(seen["ref"], seen["port"]):
        d = (np.sort(jidx, -1) != np.sort(pidx, -1)).any(-1)
        top = np.sort(jprobs, -1)[..., ::-1]
        k = pcfg.moe.top_k
        assert (top[..., k - 1] - top[..., k])[d].max(initial=0) < 1e-2
        differ |= d
    assert differ.sum() <= differ.size // 8
    first = np.where(differ.any(1), differ.argmax(1), tokens.shape[1])
    keep = np.arange(tokens.shape[1])[None, :] < first[:, None]
    scale = np.abs(exact).max()
    err = np.abs(pl.float().numpy() - jl).max(-1)[keep].max() / scale
    own = np.abs(jl - exact).max(-1)[keep].max() / scale
    assert err < max(3e-2, own), (err, own)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_and_grads_vs_jax(arch):
    jcfg, jparams, pcfg, params = _both(arch, 3)
    tokens, labels = _tokens(pcfg, 2, SEQ, 3), _tokens(pcfg, 2, SEQ, 4)
    labels[0, :5] = -1
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (want_loss, want_m), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, jcfg, jbatch), has_aux=True))(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in tree_items(params)}
    loss, metrics = model.loss_fn(params, pcfg, {"tokens": torch.from_numpy(tokens).long(),
                                                 "labels": torch.from_numpy(labels).long()})
    loss.backward()
    assert sorted(metrics) == sorted(want_m)
    for k in want_m:
        _close(metrics[k], want_m[k], 1e-4)
    _close(loss, want_loss, 1e-4)
    want_flat = flatten_pytree(want_grads)
    assert sorted(want_flat) == sorted(leaves)
    for path, g in want_flat.items():
        scale = float(np.abs(g).max()) + 1e-12
        err = float(np.abs(leaves[path].grad.numpy() - g).max())
        assert err / scale < 1e-4, (path, err, scale)


def test_loss_terms_are_the_references():
    """deepseek-v3 reduced: loss = ce + 0.01 aux + 0.3 mtp."""
    _, _, pcfg, params = _both("deepseek-v3-671b", 4)
    tokens = torch.from_numpy(_tokens(pcfg, 2, SEQ, 5)).long()
    with torch.no_grad():
        loss, m = model.loss_fn(params, pcfg, {"tokens": tokens, "labels": tokens})
    assert sorted(m) == ["aux", "ce", "loss", "mtp"]
    want = m["ce"] + pcfg.moe.aux_loss_weight * m["aux"] + 0.3 * m["mtp"]
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    assert float(m["aux"]) > 0 and float(m["mtp"]) > 0


# --------------------------------------------------------------------------- #
# Serving: greedy tokens, decode against forward, padded caches
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_greedy_generate_matches_jax(arch):
    jcfg, jparams, pcfg, params = _both(arch, 5)
    tokens = _tokens(pcfg, 2, SEQ, 6)
    gen = jax.jit(lambda p, t: jax_greedy_generate(p, jcfg, {"tokens": t}, steps=3))
    want = gen(jparams, jnp.asarray(tokens))
    got = greedy_generate(params, pcfg, {"tokens": torch.from_numpy(tokens).long()}, steps=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_logits_vs_jax(arch):
    jcfg, jparams, pcfg, params = _both(arch, 6)
    tokens = _tokens(pcfg, 2, SEQ, 7)
    want, _ = jax.jit(lambda p, t: jax_prefill_fn(p, jcfg, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = prefill_fn(params, pcfg, {"tokens": torch.from_numpy(tokens).long()})
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_forward(arch):
    """Decoded next-token logits == full-forward logits at that position, two
    steps in a row through one padded cache (``tests/test_models.py:63``
    decodes one)."""
    _, _, cfg, params = _both(arch, 7)
    b, s, steps = 2, 17, 2
    tokens = torch.from_numpy(_tokens(cfg, b, s + steps - 1, 8)).long()
    with torch.no_grad():
        full, _, _, _ = model.forward(params, cfg, {"tokens": tokens}, mode="train")
        _, cache = prefill_fn(params, cfg, {"tokens": tokens[:, :s - 1]})
        cache = pad_cache(cfg, cache, b, s + 4)
        for i in range(steps):
            pos = torch.full((b,), s - 1 + i, dtype=torch.long)
            dec, cache = decode_fn(params, cfg, tokens[:, s - 1 + i], cache, pos)
            np.testing.assert_allclose(dec.numpy(), full[:, s - 1 + i].numpy(),
                                       rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v3-671b"])
def test_pad_cache_pads_the_mixed_and_latent_leaves(arch):
    _, _, cfg, params = _both(arch, 8, compute_dtype="bfloat16")
    tokens = torch.from_numpy(_tokens(cfg, 2, 16, 9)).long()
    with torch.no_grad():
        _, cache = prefill_fn(params, cfg, {"tokens": tokens})
    padded = pad_cache(cfg, cache, 2, 40)
    want = blocks.cache_struct(cfg, 2, 40, device="meta")
    for (path, got), (_, shape) in zip(tree_items(padded), tree_items(want)):
        src = dict(tree_items(cache))[path]
        assert got.shape == shape.shape and got.dtype == shape.dtype, path
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("conv", "state"):
            assert got is src, path                    # does not grow with the length
        else:
            assert leaf in ("k", "v", "ckv", "kpe"), path
            assert torch.equal(got[:, :, :16], src.to(got.dtype)), path
            assert not bool(got[:, :, 16:].any()), path
    kinds = {path.rsplit("/", 1)[-1] for path, _ in tree_items(padded)}
    assert kinds == ({"k", "v", "conv", "state"} if arch.startswith("jamba") else {"ckv", "kpe"})


# --------------------------------------------------------------------------- #
# Entry points: the serve CLI and the training launcher
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b", "deepseek-v3-671b"])
def test_serve_cli_runs_the_new_families_on_cpu(arch, capsys):
    res = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "2", "--prompt-len", "32", "--gen", "3"])
    assert res["cfg"] == get_config(arch).reduced() and res["tokens"].shape == (2, 3)
    toks = res["tokens"].numpy()
    assert ((toks >= 0) & (toks < res["cfg"].vocab_size)).all()
    assert torch.isfinite(res["prefill_logits"].float()).all()
    assert "prefill:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_train_launcher_trains_the_reduced_arch_as_the_reference(arch, tmp_path):
    """``launch/train.py --arch ... --reduced``: the reference's launcher
    writes its step-3 checkpoint; each package's launcher resumes it to step
    6 (the MoE aux and MTP terms in the loss), and the final losses agree
    within bf16's reach (the reduced configs compute in bf16; the jitted
    reference rounds fused chains once, the port op by op)."""
    import shutil
    argv = ["--arch", arch, "--reduced", "--steps", "6", "--batch", "2", "--seq", "32",
            "--ckpt-every", "3"]
    src = tmp_path / "written"
    assert ref_train.main(argv + ["--ckpt-dir", str(src)]) == 0
    JaxDiskStore(str(src)).delete_step(6)
    for name in ("r", "p"):
        shutil.copytree(src, tmp_path / name)
    assert ref_train.main(argv + ["--resume", "--ckpt-dir", str(tmp_path / "r"), "--json",
                                  str(tmp_path / "r.json")]) == 0
    assert port_train.main(argv + ["--resume", "--device", "cpu", "--ckpt-dir",
                                   str(tmp_path / "p"), "--json",
                                   str(tmp_path / "p.json")]) == 0
    want, got = (json.loads((tmp_path / f).read_text()) for f in ("r.json", "p.json"))
    assert got["completed"] and np.isfinite(got["final_loss"])
    assert abs(got["final_loss"] - want["final_loss"]) / abs(want["final_loss"]) < 2.0 ** -8
    assert DiskStore(str(tmp_path / "p"), device="cpu").steps() == [3, 6]


def test_train_step_keeps_the_parameter_free_norms():
    """olmo-1b's ``nonparam_ln`` norms have no leaves, so a tree rebuilt from
    flat paths loses their keys; the weight bridge and the train step rebuild
    the params on the model's own tree (``params.tree_like``)."""
    from repro_torch.train import make_train_step
    cfg = get_config("olmo-1b").reduced()
    state = init_train_state(cfg, AdamConfig(lr=1e-3, warmup_steps=0), seed=0, device="cpu")
    assert state.params["segments"]["stack"]["l0"]["norm1"] == {}
    step = make_train_step(cfg, AdamConfig(lr=1e-3, warmup_steps=0))
    tokens = torch.from_numpy(_tokens(cfg, 2, 16, 11)).long()
    state, metrics = step(state, {"tokens": tokens, "labels": tokens})
    assert int(state.step) == 1 and bool(torch.isfinite(metrics["loss"]))
    assert state.params["segments"]["stack"]["l0"]["norm2"] == {}


def test_tree_like_frees_its_leaves_without_the_garbage_collector():
    """The train step rebuilds its gradients with ``tree_like`` every step; a
    reference cycle there kept each step's gradients (7.7 GB at llama3-8b
    width and 4 layers) until the cyclic collector ran, and the card ran out
    of memory a few steps in."""
    import gc
    import weakref
    from repro_torch.models.params import tree_like
    gc.disable()
    try:
        leaf = torch.zeros(4)
        ref = weakref.ref(leaf)
        tree = tree_like({"a": {"b": None}, "norm": {}}, {"a/b": leaf})
        assert tree == {"a": {"b": leaf}, "norm": {}}
        del leaf, tree
        assert ref() is None
    finally:
        gc.enable()


# --------------------------------------------------------------------------- #
# Checkpoints of the MoE family cross between the packages
# --------------------------------------------------------------------------- #
N_RANKS = 2


def _write(store, flat, step, codec_name):
    for rank, shards in enumerate(sharding.shard_state(flat, N_RANKS)):
        store.write_rank(step, rank, shards, codec=codec_name, lossless_paths=LOSSLESS_PATHS)
    store.commit(step, N_RANKS)


@pytest.mark.parametrize("codec_name", ["raw", "int8"])
def test_olmoe_checkpoints_cross_between_packages(codec_name, tmp_path):
    jstate = jax_init_state(jax_get_config("olmoe-1b-7b").reduced(), JaxAdamConfig(),
                            jax.random.key(0))
    template = init_train_state(get_config("olmoe-1b-7b").reduced(), AdamConfig(), seed=1,
                                device="cpu")
    jflat = {k: np.asarray(v) for k, v in flatten_pytree(jstate).items()}
    assert any(k.endswith("mlp/router") for k in jflat)

    # written by the reference, restored by the port
    _write(JaxDiskStore(str(tmp_path / "jax")), jflat, 3, codec_name)
    restored = port_unflatten(template, sharding.unshard_state(
        DiskStore(str(tmp_path / "jax"), device="cpu").read_all(3)))
    pflat = port_flatten(restored)
    jread = jax_sharding.unshard_state(JaxDiskStore(str(tmp_path / "jax")).read_all(3))
    assert list(pflat) == list(jflat)
    for path in jflat:
        assert np.array_equal(pflat[path], jread[path]), path

    # the port's state holding the reference's values, written by the port
    # and restored by the reference: the leaves the reference restores from
    # its own checkpoint
    own = port_flatten(port_unflatten(template, jflat))
    _write(DiskStore(str(tmp_path / "port"), device="cpu"), own, 4, codec_name)
    back = jax_sharding.unshard_state(JaxDiskStore(str(tmp_path / "port")).read_all(4))
    assert sorted(back) == sorted(jflat)
    for path in jflat:
        assert np.array_equal(back[path], jread[path]), path
