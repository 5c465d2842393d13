"""The fused AdamW kernel (``repro_torch.kernels.adamw``) and the optimizer's
choice of route.

On the CPU: the kernel's plain version (``ref.adamw_reference``, its two
passes over a list of leaves) against the per-leaf path of
``train/optimizer.py`` and against the JAX reference's ``adam_update``; the
route as a function of the state's dtypes and devices (fake CUDA tensors
carry the metadata), and the float32 copy through which the kernel reads an
odd gradient. On a card (skipped elsewhere): the kernel against the plain
version, odd gradients, bit-equal repeats, launch counts and storage.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.adamw import ops, ref  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402
from repro_torch.train import AdamConfig, adam_init, adam_update  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)

# leaves of ndim 1, 2 and 3 (the 3-d one a stacked leaf of 4 layers), sizes
# that are and are not multiples of the kernel's 4-wide vectors
SHAPES = {"a": (16, 32), "b": {"w": (4, 8, 16), "s": (16,)}, "c": (3, 5)}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tree(shapes, fn, prefix=""):
    return {k: _tree(v, fn, f"{prefix}{k}/") if isinstance(v, dict) else fn(f"{prefix}{k}", v)
            for k, v in shapes.items()}


def _grads(step, kind):
    def one(path, shape):
        if kind == "zero" or (kind == "one_zero_leaf" and path == "b/s"):
            return np.zeros(shape, np.float32)
        return _rand(shape, 100 + 7 * step + len(path) + int(np.prod(shape)), 0.5)
    return _tree(SHAPES, one)


def _leaves(tree):
    return [t for _, t in tree_items(tree)]


def _to_torch(tree, device="cpu"):
    return _tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _fused_plain(p, opt, g, step, cfg):
    """One step through ``ops.adamw_`` (the plain version for CPU leaves)."""
    lr, c1, c2 = optimizer.step_scalars(cfg, torch.tensor(step, dtype=torch.int32),
                                        _leaves(p)[0].device)
    return ops.adamw_(_leaves(p), _leaves(g), _leaves(opt["m"]), _leaves(opt["v"]), lr, c1, c2,
                      b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay,
                      grad_clip=cfg.grad_clip)


def _cfg(clip):
    return AdamConfig(lr=1e-2, warmup_steps=0, grad_clip=clip, **HYPER)


# --------------------------------------------------------------------------- #
# CPU: the plain version of the two passes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grads", ["random", "one_zero_leaf", "zero"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
def test_reference_vs_per_leaf_path(clip, grads):
    cfg = _cfg(clip)
    p0 = _tree(SHAPES, lambda path, s: _rand(s, len(path) + sum(s)))
    fp, pp = _to_torch(p0), _to_torch(p0)
    fo, po = adam_init(fp, cfg), adam_init(pp, cfg)
    for step in range(3):
        g = _grads(step, grads)
        gf = _to_torch(g)
        norm_f = _fused_plain(fp, fo, gf, step, cfg)
        assert all(np.array_equal(t.numpy(), a) for t, a in zip(_leaves(gf), _leaves(g))), \
            "the fused passes wrote a gradient"
        _, _, pm = adam_update(pp, _to_torch(g), po, torch.tensor(step, dtype=torch.int32), cfg)
        # float64 squares here, float32 in the per-leaf path's norm
        assert float(norm_f) == pytest.approx(float(pm["grad_norm"]), rel=1e-6)
        if clip and grads != "zero":
            assert float(norm_f) > clip                 # the clip is engaged
    for tree_f, tree_p in ((fp, pp), (fo["m"], po["m"]), (fo["v"], po["v"])):
        for (path, got), (_, want) in zip(tree_items(tree_f), tree_items(tree_p)):
            if clip and grads != "zero":
                # the clip scales differ by the norms' last bits: a relative
                # ~1e-7 in every term; p's own rounding near 0 by up to ~1e-9
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9, msg=path)
            else:
                # a scale of 1 on both sides: the same terms, the same roundings
                assert torch.equal(got, want), path


@pytest.mark.parametrize("grads", ["random", "zero"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
def test_reference_vs_jax(clip, grads):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.tce.engine import flatten_pytree as jax_flatten
    from repro.train import optimizer as jax_opt

    kw = dict(grad_clip=clip, warmup_steps=0, lr=1e-2, **HYPER)
    jcfg, cfg = jax_opt.AdamConfig(**kw), AdamConfig(**kw)
    p0 = _tree(SHAPES, lambda path, s: _rand(s, len(path) + sum(s)))
    jp = jax.tree.map(jnp.asarray, p0)
    jo = jax_opt.adam_init(jp, jcfg)
    fp = _to_torch(p0)
    fo = adam_init(fp, cfg)
    jax_step = jax.jit(lambda p, g, o, s: jax_opt.adam_update(p, g, o, s, jcfg))
    for step in range(3):
        g = _grads(step, grads)
        jp, jo, jm = jax_step(jp, jax.tree.map(jnp.asarray, g), jo, jnp.int32(step))
        norm = _fused_plain(fp, fo, _to_torch(g), step, cfg)
        assert float(norm) == pytest.approx(float(jm["grad_norm"]), rel=1e-6, abs=1e-12)
    # float32 across two libraries, the test_torch_train tolerance: the norm's
    # order of summation and XLA's fusion of the update's terms
    jflat = {"p": jax_flatten(jp), "m": jax_flatten(jo["m"]), "v": jax_flatten(jo["v"])}
    for key, tree in (("p", fp), ("m", fo["m"]), ("v", fo["v"])):
        for path, got in tree_items(tree):
            np.testing.assert_allclose(got.numpy(), np.asarray(jflat[key][path]),
                                       rtol=1e-4 if key != "p" else 0, atol=5e-6, err_msg=path)


# --------------------------------------------------------------------------- #
# CPU: the route is a function of the tree
# --------------------------------------------------------------------------- #
def _fake_tree(param_dtype="float32", grad="contiguous", device="cuda", moment_dtype="float32",
               second_device=None):
    """Params, grads and an Adam state of fake tensors (metadata only). The
    fake mode makes a real tensor on each CUDA device it meets where a card
    is present (``init_gpu_context``); that is skipped, so that a second
    card's leaves can be made on a host with one card or none."""
    from unittest import mock

    from torch._subclasses import fake_tensor

    with mock.patch.object(fake_tensor, "init_gpu_context", lambda device: None), \
            fake_tensor.FakeTensorMode():
        def leaf(path, shape, dtype):
            dev = second_device if second_device and path == "a" else device
            return torch.zeros(shape, dtype=getattr(torch, dtype), device=dev)
        p = _tree(SHAPES, lambda path, s: leaf(path, s, param_dtype))
        if grad == "transposed":
            g = _tree(SHAPES, lambda path, s: leaf(path, s[::-1], "float32").mT
                      if len(s) == 2 else leaf(path, s, "float32"))
        else:
            g = _tree(SHAPES, lambda path, s: leaf(path, s, grad if grad != "contiguous"
                                                   else "float32"))
        opt = adam_init(p, AdamConfig(moment_dtype=moment_dtype))
    leaves = [_leaves(p), _leaves(g),
              [optimizer._node(opt["m"], path) for path, _ in tree_items(p)],
              [optimizer._node(opt["v"], path) for path, _ in tree_items(p)]]
    return leaves, AdamConfig(moment_dtype=moment_dtype)


# The route is the state's: the gradients' dtype and layout do not choose it
# (the kernel reads an odd gradient through a float32 copy).
ROUTES = [
    ("cuda float32", {}, True),
    ("bfloat16 moments", {"moment_dtype": "bfloat16"}, False),
    ("int8 moments", {"moment_dtype": "int8"}, False),
    ("bfloat16 params", {"param_dtype": "bfloat16"}, False),
    ("bfloat16 grads", {"grad": "bfloat16"}, True),
    ("a transposed grad", {"grad": "transposed"}, True),
    ("cpu", {"device": "cpu"}, False),
    ("one leaf off the card", {"second_device": "meta"}, False),
    ("one leaf on a second card", {"device": "cuda:0", "second_device": "cuda:1"}, False),
]


@pytest.mark.parametrize("kw,fused", [c[1:] for c in ROUTES], ids=[c[0] for c in ROUTES])
def test_route_by_dtypes_layout_and_device(kw, fused):
    (p, g, m, v), cfg = _fake_tree(**kw)
    assert optimizer.fused_route(p, m, v, cfg) is fused
    if not fused and kw.get("device") != "cpu" and cfg.moment_dtype == "float32":
        # the wrapper raises on a state it does not take, before any build
        with pytest.raises(ValueError, match="AdamW kernel"):
            ops.adamw_(p, g, m, v, *(torch.zeros(()),) * 3, grad_clip=1.0, **HYPER)


def _odd(kind, p):
    if kind == "transposed":
        return p.mT.contiguous().mT + 1.0
    if kind == "bfloat16":
        return (p + 1.0).to(torch.bfloat16)
    if kind == "float64":
        return (p + 1.0).to(torch.float64)
    return p + 1.0


@pytest.mark.parametrize("kind", ["float32", "transposed", "bfloat16", "float64"])
def test_kernel_reads_an_odd_grad_through_a_float32_copy(kind):
    p = torch.from_numpy(_rand((16, 32), 5))
    g = _odd(kind, p)
    got = ops.kernel_grad(p, g)
    assert got.dtype == torch.float32 and got.is_contiguous() and got.device == p.device
    assert (got is g) is (kind == "float32"), "a float32 contiguous grad is read as it is"
    assert torch.equal(got, g.to(torch.float32))


@pytest.mark.parametrize("g_shape,g_device", [((32, 16), "cpu"), ((16, 32), "meta")],
                         ids=["shape", "device"])
def test_kernel_grad_raises_off_its_param(g_shape, g_device):
    p = torch.zeros(16, 32)
    with pytest.raises(ValueError, match="AdamW kernel"):
        ops.kernel_grad(p, torch.zeros(g_shape, device=g_device))


def test_cpu_tree_takes_the_per_leaf_path():
    cfg = _cfg(1.0)
    p = _to_torch(_tree(SHAPES, lambda path, s: _rand(s, sum(s))))
    g = _to_torch(_grads(0, "random"))
    before = dict(ops.LAUNCHES)
    with obs.span("test.adam") as sp:
        _, _, m = adam_update(p, g, adam_init(p, cfg), torch.tensor(0, dtype=torch.int32), cfg)
    assert "fused_leaves" not in sp.attrs and ops.LAUNCHES == before
    # the per-leaf path consumes the gradients: scaled in place by the clip
    scale = cfg.grad_clip / float(m["grad_norm"])
    np.testing.assert_allclose(g["a"].numpy(), _grads(0, "random")["a"] * scale, rtol=1e-6)


def test_kernel_package_builds_from_its_source():
    assert "adamw" in _build.KERNELS
    assert [s.name for s in _build.sources("adamw")] == ["adamw.cu"]
    assert _build.library_path("adamw").parent == _build.BUILD_DIR


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


# Card cases: the CPU shapes; 50 leaves (two launches of each pass at 48
# leaves a launch); a large leaf with a ragged tail; leaves that start 4 bytes into their
# storage (the scalar path).
CARD_CASES = {
    "shapes": [(16, 32), (4, 8, 16), (16,), (3, 5)],
    "fifty_leaves": [(7, 9)] * 25 + [(33,)] * 25,
    "large": [(3, 1000, 1001), (1000,)],
}


def _card_leaves(shapes, seed, device, scale, offset=False, positive=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for shape in shapes:
        n = int(np.prod(shape))
        x = torch.randn(n + 1, generator=gen, device=device) * scale
        x = x.abs() if positive else x
        out.append((x[1:] if offset else x[:n]).reshape(shape))
    return out


def _card_state(shapes, seed, device, offset=False):
    return (_card_leaves(shapes, seed, device, 1.0, offset),
            _card_leaves(shapes, seed + 1, device, 1e-2, offset),
            _card_leaves(shapes, seed + 2, device, 1e-4, offset, positive=True))


def _step(p, g, m, v, step, clip, kernel):
    cfg = _cfg(clip)
    lr, c1, c2 = optimizer.step_scalars(cfg, torch.tensor(step, dtype=torch.int32), p[0].device)
    fn = ops.adamw_ if kernel else ref.adamw_reference
    return fn(p, g, m, v, lr, c1, c2, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
              weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("clip", [1.0, 0.0], ids=["clip", "noclip"])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_cuda_kernel_vs_reference(case, clip, offset, cuda_device):
    shapes = CARD_CASES[case]
    k = _card_state(shapes, 1, cuda_device, offset)
    assert (k[0][0].data_ptr() % 16 == 4) is offset
    r = tuple([t.clone() for t in ts] for ts in k)
    for step in range(3):
        g = _card_leaves(shapes, 10 + step, cuda_device, 0.5, offset)
        nk = _step(*k[:1], g, *k[1:], step, clip, kernel=True)
        nr = _step(*r[:1], g, *r[1:], step, clip, kernel=False)
        torch.cuda.synchronize()
        # both sum float64 squares, in another order: the float32 norms agree
        # to the last bit but for a rounding tie, so every term agrees to a
        # few ulp (the update's terms are the same IEEE operations)
        assert float(nk) == pytest.approx(float(nr), rel=1e-6)
        if clip:
            assert float(nr) > clip
    for name, got, want in zip("pmv", k, r):
        for i, (a, b) in enumerate(zip(got, want)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9, msg=f"{name}[{i}]")


def test_cuda_two_calls_are_bit_equal(cuda_device):
    shapes = CARD_CASES["fifty_leaves"] + CARD_CASES["large"]
    runs = []
    for _ in range(2):
        p, m, v = _card_state(shapes, 2, cuda_device)
        g = _card_leaves(shapes, 3, cuda_device, 0.5)
        norm = _step(p, g, m, v, 5, 1.0, kernel=True)
        torch.cuda.synchronize()
        runs.append((norm, p, m, v))
    (n1, *a), (n2, *b) = runs
    assert n1.view(torch.int32).item() == n2.view(torch.int32).item()
    for x, y in zip(a, b):
        assert all(torch.equal(s.view(torch.int32), t.view(torch.int32)) for s, t in zip(x, y))


@pytest.mark.parametrize("kind", ["float32", "transposed", "bfloat16"])
def test_cuda_launches_storage_and_span(kind, cuda_device):
    """A float32 state on the card takes the kernel whatever its gradients'
    layout and dtype (an odd leaf is read through a float32 copy): one launch
    of each pass, ``fused_leaves`` on the span, the same storage, gradients
    untouched, and the plain version's step fed the float32 gradients."""
    cfg = _cfg(1.0)
    p = _tree_map(lambda a: a.to(cuda_device),
                  _to_torch(_tree(SHAPES, lambda path, s: _rand(s, sum(s)))))
    g = _tree_map(lambda a: a.to(cuda_device), _to_torch(_grads(0, "random")))
    g["a"] = _odd(kind, g["a"])                      # the (16, 32) leaf
    g0 = _tree_map(torch.clone, g)
    r = _tree_map(torch.clone, p)
    opt, r_opt = adam_init(p, cfg), adam_init(r, cfg)
    ptrs = [t.data_ptr() for tree in (p, opt["m"], opt["v"]) for t in _leaves(tree)]
    before = dict(ops.LAUNCHES)
    with obs.span("test.adam") as sp:
        _, _, met = adam_update(p, g, opt, torch.tensor(0, dtype=torch.int32,
                                                        device=cuda_device), cfg)
    lr, c1, c2 = optimizer.step_scalars(cfg, torch.tensor(0, dtype=torch.int32), cuda_device)
    norm = ref.adamw_reference(_leaves(r), [t.float().contiguous() for t in _leaves(g0)],
                               _leaves(r_opt["m"]), _leaves(r_opt["v"]), lr, c1, c2,
                               b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                               weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)
    torch.cuda.synchronize()
    assert sp.attrs["fused_leaves"] == len(_leaves(p)) == 4
    assert {k: ops.LAUNCHES[k] - before[k] for k in before} == \
        {"sumsq": 1, "norm_scale": 1, "update": 1}
    assert [t.data_ptr() for tree in (p, opt["m"], opt["v"]) for t in _leaves(tree)] == ptrs
    for a, b in zip(_leaves(g), _leaves(g0)):
        assert a.dtype == b.dtype and a.stride() == b.stride() and torch.equal(a, b), \
            "a grad was written"
    assert float(met["grad_norm"]) == pytest.approx(float(norm), rel=1e-6)
    for tree, want in ((p, r), (opt["m"], r_opt["m"]), (opt["v"], r_opt["v"])):
        for (path, x), (_, y) in zip(tree_items(tree), tree_items(want)):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9, msg=path)
    assert any(bool(t.any()) for t in _leaves(opt["m"]))
