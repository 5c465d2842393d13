"""The port's encoder-decoder (``whisper-tiny``) and VLM (``qwen2-vl-2b``)
families against the JAX reference on the CPU, on their reduced configs:

* whisper-tiny reduced: 2 encoder + 2 decoder layers, d 64, 4 heads of 16,
  LayerNorm, GELU, biases, sinusoidal positions, 32 stub encoder frames,
  cross attention in every decoder layer;
* qwen2-vl-2b reduced: 2 layers, d 64, 4 heads and 2 kv heads of 16,
  8 stub vision embeddings in place of the first token embeddings, M-RoPE
  with sections (2, 3, 3).

Weights come from the reference through the weight bridge
(``params_from_flat`` on ``flatten_pytree(init_params(...))``), with every
leaf the reference initialises to a constant (norm scales and biases, the
attention biases) redrawn at random so that a term left out cannot hide.
Inputs (tokens, encoder frames, vision embeddings, M-RoPE positions) are
numpy arrays from fixed seeds.

Tolerances, as ``tests/test_torch_families.py`` holds the other families:
float32 forward logits, prefill caches, loss and metrics within 1e-4 (rtol =
atol; the same float32 arithmetic in another order); every gradient leaf
within 1e-4 of its own max |grad|; bf16 logits within 3e-2 of the float32
logits' max |logit| (bf16 keeps 8 significant bits, and the two frameworks
round in different places), or the reference's own bf16 distance from its
float32 forward where that is larger; decode against forward at 2e-4
(``tests/test_models.py``); greedy tokens equal; M-RoPE within 1e-5; the
sinusoid within two float32 ulps of its angle (its test says why).

    PYTHONPATH=src python -m pytest -q tests/test_torch_encdec_vlm.py
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.tce import sharding as jax_sharding  # noqa: E402
from repro.core.tce.engine import flatten_pytree, unflatten_like  # noqa: E402
from repro.core.tce.store import DiskStore as JaxDiskStore  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serve.engine import greedy_generate as jax_greedy_generate  # noqa: E402
from repro.serve.engine import prefill_fn as jax_prefill_fn  # noqa: E402
from repro.train import AdamConfig as JaxAdamConfig  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.tce import DiskStore, sharding  # noqa: E402
from repro_torch.core.tce.engine import flatten_pytree as port_flatten  # noqa: E402
from repro_torch.core.tce.engine import unflatten_like as port_unflatten  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import blocks, layers, model  # noqa: E402
from repro_torch.models.params import flatten_params, params_from_flat, tree_items  # noqa: E402
from repro_torch.serve.engine import decode_fn, greedy_generate, pad_cache, prefill_fn  # noqa: E402
from repro_torch.substrate.worker import LOSSLESS_PATHS  # noqa: E402
from repro_torch.train import AdamConfig, init_train_state  # noqa: E402

FAMILY_ARCHS = ("whisper-tiny", "qwen2-vl-2b")
# leaf name -> how it is redrawn: "one" ~ 1 + 0.3 N(0, 1), else scale x N(0, 1)
RANDOM_CONSTANTS = {"scale": "one", "bias": 0.1, "bq": 0.1, "bk": 0.1, "bv": 0.1, "bo": 0.1}
F32_TOL = 1e-4
GRAD_TOL = 1e-4
BF16_REL_TOL = 3e-2
DECODE_TOL = 2e-4
ROPE_TOL = 1e-5
SEQ = 16


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
    return (jcfg, jax.tree.map(jnp.asarray, unflatten_like(jparams, flat)), pcfg,
            params_from_flat(flat, pcfg, "cpu"))


def _batch(cfg, b, s, seed):
    """Numpy inputs: tokens, and the family's stub frontend output."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.encdec.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (b, min(cfg.vlm.n_vision_tokens, s), cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _grid_positions(b, s, n_vis, width):
    """Qwen2-VL's M-RoPE positions for ``n_vis`` patches on a grid ``width``
    wide, then text: patch i at (0, i // width, i % width), text token j at
    max + 1 + j in all three streams. (3, b, s) int32."""
    i = np.arange(n_vis)
    vis = np.stack([np.zeros_like(i), i // width, i % width])
    text = np.arange(s - n_vis) + vis.max() + 1
    pos = np.concatenate([vis, np.broadcast_to(text, (3, s - n_vis))], axis=1)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s))).astype(np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                                          else got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# Registry, configs, segments, params
# --------------------------------------------------------------------------- #
def test_registry_is_the_references():
    assert ARCHS == JAX_ARCHS
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("whisper-large")


@pytest.mark.parametrize("arch,n_params", [("whisper-tiny", 56.4e6), ("qwen2-vl-2b", 1.78e9)])
def test_n_params_is_the_references(arch, n_params):
    port, ref = get_config(arch), jax_get_config(arch)
    assert port.n_params() == ref.n_params()
    assert abs(port.n_params() / n_params - 1) < 5e-3, port.n_params()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decoder_segments_with_cross_equal_the_reference(arch):
    for reduce in (False, True):
        pcfg, jcfg = get_config(arch), jax_get_config(arch)
        if reduce:
            pcfg, jcfg = pcfg.reduced(), jcfg.reduced()
        cross = pcfg.family == "encdec"
        got = [(s.name, s.n_steps, [dataclasses.astuple(sp) for sp in s.specs])
               for s in blocks.segments(pcfg, cross=cross)]
        want = [(s.name, s.n_steps, [(sp.kind, sp.mlp, sp.cross) for sp in s.specs])
                for s in jax_blocks.segments(jcfg, cross=cross)]
        assert got == want
        assert all(sp.cross == cross for s in blocks.segments(pcfg, cross=cross) for sp in s.specs)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_flat_param_paths_equal_the_reference(arch):
    jcfg, pcfg = _cfgs(arch, compute_dtype="bfloat16")
    flat = flatten_pytree(jax_model.init_params(jcfg, jax.random.key(0)))
    back = flatten_params(params_from_flat(flat, pcfg, "cpu"))
    assert list(back) == list(flat)
    assert all(np.array_equal(back[k].numpy(), flat[k]) for k in flat)
    mine = flatten_params(model.init_params(pcfg, seed=0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in flat.items()}
    if arch == "whisper-tiny":
        for path in ("encoder/seg/l0/mix/wq", "encoder/seg/l0/mix/bk", "encoder/seg/l0/mlp/wi",
                     "encoder/seg/l0/norm1/bias", "encoder/norm_f/scale",
                     "segments/stack/l0/cross/wk", "segments/stack/l0/cross/bo",
                     "segments/stack/l0/norm_c/scale", "segments/stack/l0/norm_c/bias"):
            assert path in back, path
        assert back["encoder/seg/l0/mix/wq"].shape == (2, 64, 64)      # (enc layers, d, h dh)
        assert back["segments/stack/l0/cross/wv"].shape == (2, 64, 64)
    else:
        assert not any("cross" in p or p.startswith("encoder") for p in back)


# --------------------------------------------------------------------------- #
# Layers: the sinusoid and M-RoPE
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [64, 384, 2])
def test_sinusoid_is_the_references(d):
    """Up to whisper's 1,500 encoder frames. XLA's float32 exp is not
    correctly rounded (the reference's jitted and eager frequencies differ
    in 42 of 192 at d 384), so a frequency may differ by an ulp: the angle
    by up to pos x 2^-23 x freq <= pos x 2^-23. Limit: two such ulps at the
    largest position."""
    pos = np.random.default_rng(0).integers(0, 1500, size=(2, 7))
    got = model._sinusoid(torch.from_numpy(pos), d)
    want = jax_model._sinusoid(jnp.asarray(pos), d)
    assert got.dtype == torch.float32 and got.shape == (2, 7, d)
    _close(got, want, 2 * 2.0 ** -23 * pos.max())


@pytest.mark.parametrize("sections,d_head,partial", [((2, 3, 3), 16, 1.0),
                                                     ((16, 24, 24), 128, 1.0),
                                                     ((1, 2, 3), 16, 0.75)])
def test_mrope_with_distinct_streams_is_the_references(sections, d_head, partial):
    """Three different position streams (t, h, w), so that a band taken
    from the wrong stream shows."""
    rng = np.random.default_rng(d_head)
    x = rng.standard_normal((2, 9, 4, d_head)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(3, 2, 9))
    assert len({pos[i].tobytes() for i in range(3)}) == 3
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, partial, sections)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6, partial,
                                 sections)
    _close(got, want, ROPE_TOL)
    # each band really follows its own stream: moving one stream moves only
    # that stream's band
    moved = pos.copy()
    moved[1] += 7
    again = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(moved), 1e6, partial,
                              sections)
    half = sum(sections)
    changed = (again - got).abs().amax(dim=(0, 1, 2)) > 0
    t, h = sections[0], sections[1]
    for lo in (0, half):
        assert not changed[lo:lo + t].any() and changed[lo + t:lo + t + h].all()
        assert not changed[lo + t + h:lo + half].any()


# --------------------------------------------------------------------------- #
# Forward, prefill cache, loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_and_prefill_cache_f32_vs_jax(arch, impl):
    """``kernel`` runs the flash-attention kernel's plain version here."""
    jcfg, jparams, pcfg, params = _both(arch, 1)
    batch = _batch(pcfg, 2, SEQ, 1)
    jl, jc, _, _ = jax.jit(lambda p, b: jax_model.forward(p, jcfg, b, mode="prefill"))(
        jparams, _jax(batch))
    with torch.no_grad():
        pl, pc, _, _ = model.forward(params, pcfg, _torch(batch), mode="prefill", attn_impl=impl)
    _close(pl, jl, F32_TOL)
    jflat, pflat = flatten_pytree(jc), dict(tree_items(pc))
    assert list(pflat) == list(jflat)
    leaves = {p.rsplit("/", 1)[-1] for p in pflat}
    assert leaves == ({"k", "v", "ek", "ev"} if arch == "whisper-tiny" else {"k", "v"})
    for path, arr in jflat.items():
        _close(pflat[path], arr, F32_TOL)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_and_prefill_cache_bf16_vs_jax(arch, impl):
    jcfg, jparams, pcfg, params = _both(arch, 2, compute_dtype="bfloat16")
    jcfg32, jparams32, _, _ = _both(arch, 2)
    batch = _batch(pcfg, 2, SEQ, 2)
    exact = np.asarray(jax_model.forward(jparams32, jcfg32, _jax(batch))[0])
    jl, jc, _, _ = jax_model.forward(jparams, jcfg, _jax(batch), mode="prefill")
    jl = np.asarray(jl, np.float32)
    with torch.no_grad():
        pl, pc, _, _ = model.forward(params, pcfg, _torch(batch), mode="prefill", attn_impl=impl)
    assert pl.dtype == torch.bfloat16
    scale = np.abs(exact).max()
    err = np.abs(pl.float().numpy() - jl).max() / scale
    own = np.abs(jl - exact).max() / scale
    assert err < max(BF16_REL_TOL, own), (err, own)
    for path, arr in flatten_pytree(jc).items():
        got = dict(tree_items(pc))[path]
        assert got.dtype == torch.bfloat16, path
        arr = np.asarray(arr, np.float32)
        assert np.abs(got.float().numpy() - arr).max() <= BF16_REL_TOL * np.abs(arr).max(), path


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_vs_jax(arch):
    jcfg, jparams, pcfg, params = _both(arch, 3)
    batch = _batch(pcfg, 2, SEQ, 3)
    batch["labels"] = np.random.default_rng(4).integers(0, pcfg.vocab_size,
                                                        (2, SEQ)).astype(np.int32)
    batch["labels"][0, :5] = -1
    jb = _jax(batch)
    (want_loss, want_m), want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_model.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    leaves = {k: v.requires_grad_(True) for k, v in tree_items(params)}
    loss, metrics = model.loss_fn(params, pcfg, _torch(batch))
    loss.backward()
    assert sorted(metrics) == sorted(want_m)
    for k in want_m:
        _close(metrics[k], want_m[k], F32_TOL)
    _close(loss, want_loss, F32_TOL)
    want_flat = flatten_pytree(want_grads)
    assert sorted(want_flat) == sorted(leaves)
    for path, g in want_flat.items():
        got = leaves[path].grad.numpy()
        if path.endswith("/bk"):
            # zero in exact arithmetic: a key bias adds q . b_k to every
            # score of a row, which the softmax takes away; both packages
            # give rounding noise, far below the key weights' gradient
            floor = 1e-6 * float(np.abs(want_flat[path[:-2] + "wk"]).max())
            assert np.abs(g).max() < floor and np.abs(got).max() < floor, path
            continue
        scale = float(np.abs(g).max()) + 1e-12
        err = float(np.abs(got - g).max())
        assert err / scale < GRAD_TOL, (path, err, scale)
    if arch == "whisper-tiny":   # the encoder and the cross attention learn
        for path in ("encoder/seg/l0/mix/wq", "segments/stack/l0/cross/wk",
                     "segments/stack/l0/norm_c/scale"):
            assert float(leaves[path].grad.abs().max()) > 0, path


def test_forward_at_grid_positions_vs_jax():
    """qwen2-vl with (3, b, s) M-RoPE positions of a 2 x 4 patch grid, the
    ``Batch`` contract's ``positions``: the port's logits and cache are the
    reference's, and differ from those at the default positions."""
    jcfg, jparams, pcfg, params = _both("qwen2-vl-2b", 4)
    batch = _batch(pcfg, 2, SEQ, 5)
    default = dict(batch)
    batch["positions"] = _grid_positions(2, SEQ, pcfg.vlm.n_vision_tokens, 4)
    assert len({batch["positions"][i].tobytes() for i in range(3)}) == 3
    jl, jc, _, _ = jax_model.forward(jparams, jcfg, _jax(batch), mode="prefill")
    with torch.no_grad():
        pl, pc, _, _ = model.forward(params, pcfg, _torch(batch), mode="prefill")
        pd, _, _, _ = model.forward(params, pcfg, _torch(default), mode="prefill")
    _close(pl, jl, F32_TOL)
    for path, arr in flatten_pytree(jc).items():
        _close(dict(tree_items(pc))[path], arr, F32_TOL)
    assert float((pl - pd).abs().max()) > 100 * F32_TOL


def test_default_positions_are_three_equal_streams_for_the_vlm():
    _, _, pcfg, _ = _both("qwen2-vl-2b")
    tokens = torch.zeros(2, 5, dtype=torch.long)
    pos = model._default_positions(pcfg, {"tokens": tokens})
    want = jax_model._default_positions(_cfgs("qwen2-vl-2b")[0], {"tokens": jnp.zeros((2, 5))})
    assert tuple(pos.shape) == (3, 2, 5)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,h,kh", [(12, 40, 6, 6), (40, 12, 12, 2)])
def test_cross_attention_impls_vs_the_references_chunked(s, t, h, kh, dtype):
    """Not causal, S != T: the port's three implementations (the kernel's
    plain version here, ``chunked_attention``, the plain version) against
    the reference's ``chunked_attention``, which its cross attention runs."""
    from repro.models import attention as jax_attention
    from repro_torch.models import attention
    rng = np.random.default_rng(s * t)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, s, h, 16), (2, t, kh, 16), (2, t, kh, 16))]
    want = np.asarray(jax_attention.chunked_attention(
        *[jnp.asarray(a).astype(dtype) for a in arrs], causal=False), np.float32)
    q, k, v = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    tol = F32_TOL if dtype == "float32" else BF16_REL_TOL
    for impl in ("kernel", "chunked", "plain"):
        got = attention._attend(q, k, v, False, impl)
        assert got.shape == q.shape and got.dtype == q.dtype
        _close(got, want, tol)


def test_kernel_prefill_sends_every_attention_to_the_kernel(monkeypatch):
    """Under ``attn_impl="kernel"`` whisper's prefill sends its encoder
    (bidirectional, S = T = enc_len), decoder self-attention (causal) and
    cross attention (S decoder rows against T encoder rows, not causal) to
    the flash-attention wrapper, with contiguous operands (what the card's
    kernel reads in place); ``chunked`` and decode send none."""
    calls = []
    wrapped = fa_ops.flash_attention

    def recording(q, k, v, causal=True):
        calls.append((q.shape[1], k.shape[1], causal,
                      q.is_contiguous() and k.is_contiguous() and v.is_contiguous()))
        return wrapped(q, k, v, causal=causal)

    monkeypatch.setattr(fa_ops, "flash_attention", recording)
    _, _, cfg, params = _both("whisper-tiny", 5, compute_dtype="bfloat16")
    batch = _torch(_batch(cfg, 2, SEQ, 6))
    t = cfg.encdec.enc_len
    with torch.no_grad():
        _, cache = prefill_fn(params, cfg, batch)
        assert calls == ([(t, t, False, True)] * 2
                         + [(SEQ, SEQ, True, True), (SEQ, t, False, True)] * 2)
        calls.clear()
        model.forward(params, cfg, batch, attn_impl="chunked")
        cache = pad_cache(cfg, cache, 2, SEQ + 2)
        decode_fn(params, cfg, batch["tokens"][:, -1], cache, torch.full((2,), SEQ))
    assert calls == []


# --------------------------------------------------------------------------- #
# Serving: greedy tokens, prefill logits, decode against forward, pad_cache
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_greedy_generate_matches_jax(arch):
    jcfg, jparams, pcfg, params = _both(arch, 6)
    batch = _batch(pcfg, 2, SEQ, 7)
    gen = jax.jit(lambda p, b: jax_greedy_generate(p, jcfg, b, steps=3))
    want = gen(jparams, _jax(batch))
    got = greedy_generate(params, pcfg, _torch(batch), steps=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_logits_vs_jax(arch):
    jcfg, jparams, pcfg, params = _both(arch, 7)
    batch = _batch(pcfg, 2, SEQ, 8)
    want, _ = jax.jit(lambda p, b: jax_prefill_fn(p, jcfg, b))(jparams, _jax(batch))
    with torch.no_grad():
        got, _ = prefill_fn(params, pcfg, _torch(batch))
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_matches_forward(arch):
    """Decoded next-token logits == full-forward logits at that position, two
    steps in a row through one padded cache: the sinusoid at ``pos``, the
    cached ``ek`` / ``ev``, M-RoPE at ``pos`` in all three streams."""
    _, _, cfg, params = _both(arch, 8)
    b, s, steps = 2, 17, 2
    batch = _torch(_batch(cfg, b, s + steps - 1, 9))
    tokens = batch["tokens"]
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    with torch.no_grad():
        full, _, _, _ = model.forward(params, cfg, batch, mode="train")
        _, cache = prefill_fn(params, cfg, {**extras, "tokens": tokens[:, :s - 1]})
        cache = pad_cache(cfg, cache, b, s + 4)
        for i in range(steps):
            pos = torch.full((b,), s - 1 + i, dtype=torch.long)
            dec, cache = decode_fn(params, cfg, tokens[:, s - 1 + i], cache, pos)
            np.testing.assert_allclose(dec.numpy(), full[:, s - 1 + i].numpy(),
                                       rtol=DECODE_TOL, atol=DECODE_TOL)


def test_pad_cache_takes_the_encoder_leaves_as_they_are():
    _, _, cfg, params = _both("whisper-tiny", 9, compute_dtype="bfloat16")
    with torch.no_grad():
        _, cache = prefill_fn(params, cfg, _torch(_batch(cfg, 2, SEQ, 10)))
    padded = pad_cache(cfg, cache, 2, 40)
    want = blocks.cache_struct(cfg, 2, 40, enc_len=cfg.encdec.enc_len, device="meta")
    src = dict(tree_items(cache))
    kinds = set()
    for (path, got), (wpath, shape) in zip(tree_items(padded), tree_items(want)):
        assert path == wpath
        assert got.shape == shape.shape and got.dtype == shape.dtype, path
        leaf = path.rsplit("/", 1)[-1]
        kinds.add(leaf)
        if leaf in ("ek", "ev"):
            assert got is src[path], path                  # fixed length: no copy
            assert got.shape[2] == cfg.encdec.enc_len
        else:
            assert torch.equal(got[:, :, :SEQ], src[path]), path
            assert not bool(got[:, :, SEQ:].any()), path
    assert kinds == {"k", "v", "ek", "ev"}
    with pytest.raises(ValueError, match="enc_len"):
        blocks.cache_struct(cfg, 2, 40, device="meta")


# --------------------------------------------------------------------------- #
# Entry points: the serve CLI and the training launcher
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_cli_runs_the_family_on_cpu(arch, capsys):
    res = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "2", "--prompt-len", str(SEQ), "--gen", "3"])
    cfg = res["cfg"]
    assert cfg == get_config(arch).reduced() and res["tokens"].shape == (2, 3)
    toks = res["tokens"].numpy()
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert torch.isfinite(res["prefill_logits"].float()).all()
    extras = res["extras"]
    if arch == "whisper-tiny":
        assert tuple(extras["enc_embeds"].shape) == (2, cfg.encdec.enc_len, cfg.d_model)
    else:
        assert tuple(extras["vision_embeds"].shape) == (2, cfg.vlm.n_vision_tokens, cfg.d_model)
    assert all(v.dtype == torch.float32 for v in extras.values())
    # the warm wave with the same extras repeats the tokens
    again = serve_cli.serve_wave(res["params"], cfg, res["prompts"], 3, extras)
    assert torch.equal(again["tokens"], res["tokens"])
    assert "prefill:" in capsys.readouterr().out


def test_serve_extras_are_the_same_for_a_seed_and_clip_to_the_prompt():
    cfg = get_config("qwen2-vl-2b").reduced()
    a = serve_cli.make_extras(cfg, 2, 5, 3, "cpu")
    b = serve_cli.make_extras(cfg, 2, 5, 3, "cpu")
    assert tuple(a["vision_embeds"].shape) == (2, 5, cfg.d_model)
    assert torch.equal(a["vision_embeds"], b["vision_embeds"])
    assert serve_cli.make_extras(get_config("llama3-8b").reduced(), 2, 5, 3, "cpu") == {}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_launcher_trains_the_reduced_arch_as_the_reference(arch, tmp_path):
    """``launch/train.py --arch ... --reduced`` with the reference's zero
    ``enc_embeds`` / ``vision_embeds``: the reference's launcher writes its
    step-3 checkpoint; each package's launcher resumes it to step 6, and the
    final losses agree within bf16's reach (the reduced configs compute in
    bf16)."""
    argv = ["--arch", arch, "--reduced", "--steps", "6", "--batch", "2", "--seq", str(SEQ),
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


def test_zero_extras_are_the_references_batch_extras():
    for arch, key, shape in (("whisper-tiny", "enc_embeds", (3, 32, 64)),
                             ("qwen2-vl-2b", "vision_embeds", (3, 8, 64))):
        out = model.zero_extras(get_config(arch).reduced(), 3, SEQ, "cpu")
        assert list(out) == [key] and tuple(out[key].shape) == shape
        assert out[key].dtype == torch.float32 and not bool(out[key].any())
    assert model.zero_extras(get_config("qwen2-vl-2b").reduced(), 3, 4, "cpu")[
        "vision_embeds"].shape[1] == 4
    assert model.zero_extras(get_config("llama3-8b").reduced(), 3, SEQ, "cpu") == {}


# --------------------------------------------------------------------------- #
# Checkpoints of the encoder-decoder cross between the packages
# --------------------------------------------------------------------------- #
N_RANKS = 2


def _write(store, flat, step, codec_name):
    for rank, shards in enumerate(sharding.shard_state(flat, N_RANKS)):
        store.write_rank(step, rank, shards, codec=codec_name, lossless_paths=LOSSLESS_PATHS)
    store.commit(step, N_RANKS)


@pytest.mark.parametrize("codec_name", ["raw", "int8"])
def test_whisper_checkpoints_cross_between_packages(codec_name, tmp_path):
    jstate = jax_init_state(jax_get_config("whisper-tiny").reduced(), JaxAdamConfig(),
                            jax.random.key(0))
    template = init_train_state(get_config("whisper-tiny").reduced(), AdamConfig(), seed=1,
                                device="cpu")
    jflat = {k: np.asarray(v) for k, v in flatten_pytree(jstate).items()}
    assert any("/encoder/" in k for k in jflat) and any("/cross/" in k for k in jflat)

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
    # and restored by the reference
    own = port_flatten(port_unflatten(template, jflat))
    _write(DiskStore(str(tmp_path / "port"), device="cpu"), own, 4, codec_name)
    back = jax_sharding.unshard_state(JaxDiskStore(str(tmp_path / "port")).read_all(4))
    assert sorted(back) == sorted(jflat)
    for path in jflat:
        assert np.array_equal(back[path], jread[path]), path
