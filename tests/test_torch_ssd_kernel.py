"""The port's SSD chunked-scan kernel, its wrapper and its plain version.

Inputs are made with numpy from a fixed seed. On a host with JAX, the plain
version (``repro_torch.models.ssm.ssd_chunked``) is held against the JAX
``ssd_chunked`` and the Pallas kernel in interpret mode, on the reference's
``SSD_CASES`` and its init-state continuation. On a host with a card, the
CUDA kernel is held against the plain version (these tests skip elsewhere).
JAX is imported only inside the tests that need it, so that the card tests
also run where JAX is missing:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_kernel.py

Tolerances are the reference tests' own (``tests/test_kernels.py``): y within
1e-4 (f32) or 3e-2 (bf16) of max |y|; the final state at rtol = atol = 1e-4
(f32) or 1e-2 (bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402

# (b, s, nh, p, g, n, chunk, dtype): SSD_CASES of tests/test_kernels.py
SSD_CASES = [
    (2, 128, 8, 32, 1, 16, 64, "float32"),
    (1, 256, 4, 16, 2, 8, 32, "float32"),
    (1, 64, 2, 64, 1, 32, 64, "float32"),
    (2, 128, 4, 32, 1, 16, 32, "bfloat16"),
]
CASE_IDS = [f"s{c[1]}nh{c[2]}p{c[3]}g{c[4]}n{c[5]}c{c[6]}{c[7]}" for c in SSD_CASES]
Y_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STATE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _inputs(case, seed):
    """x, dt, A, B, C as float32 numpy arrays (x, B, C rounded to the case's
    dtype by the caller), with the reference test's scales."""
    b, s, nh, p, g, n = case[:6]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, p)) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, s, nh)), 0.0)          # softplus
    A = -np.exp(rng.standard_normal(nh) * 0.3)
    B = rng.standard_normal((b, s, g, n)) * 0.3
    C = rng.standard_normal((b, s, g, n)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def _torch(arrs, dtype_name, device="cpu"):
    """x, dt, A, B, C as tensors: x, B, C in the case's dtype, dt and A in f32."""
    dt = getattr(torch, dtype_name)
    x, d, A, B, C = (torch.from_numpy(a).to(device) for a in arrs)
    return x.to(dt), d, A, B.to(dt), C.to(dt)


def _np(t):
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _assert_y(got, want, name):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) / scale < Y_TOL[name]


def _assert_state(got, want, name):
    np.testing.assert_allclose(_np(got), _np(want), rtol=STATE_TOL[name], atol=STATE_TOL[name])


# --------------------------------------------------------------------------- #
# Plain version vs the JAX reference (host with JAX)
# --------------------------------------------------------------------------- #
def test_ssd_cases_are_the_reference_cases():
    pytest.importorskip("jax")
    from test_kernels import SSD_CASES as JAX_CASES
    assert [c[:7] + (c[7].__name__,) for c in JAX_CASES] == SSD_CASES


@pytest.mark.parametrize("case", SSD_CASES, ids=CASE_IDS)
def test_ssd_chunked_vs_jax_and_pallas_interpret(case):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked

    chunk, name = case[6], case[7]
    arrs = _inputs(case, seed=case[1] + case[2] * case[3])
    jdt = getattr(jnp, name)
    jx, jd, jA, jB, jC = (jnp.asarray(a) for a in arrs)
    jx, jB, jC = jx.astype(jdt), jB.astype(jdt), jC.astype(jdt)
    want_y, want_h = jax_ssd_chunked(jx, jd, jA, jB, jC, chunk=chunk)
    pallas_y, pallas_h = jax_ssd_scan(jx, jd, jA, jB, jC, chunk=chunk, interpret=True)
    jax.block_until_ready(pallas_y)

    y, h = ref.ssd_reference(*_torch(arrs, name), chunk=chunk)
    assert y.dtype == getattr(torch, name) and h.dtype == torch.float32
    assert tuple(h.shape) == (case[0], case[2], case[3], case[5])
    for wy, wh in ((want_y, want_h), (pallas_y, pallas_h)):
        _assert_y(y, wy, name)
        _assert_state(h, wh, name)


def test_ssd_init_state_continuation_vs_jax():
    """The reference's continuation case: scan(x[:half]) then scan(x[half:],
    init_state) == scan(x), and the port's halves == the JAX halves."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan

    case = (1, 128, 4, 16, 1, 8, 32, "float32")
    arrs = _inputs(case, seed=7)
    half = case[1] // 2
    first = [a[:, :half] if a.ndim > 1 else a for a in arrs]
    second = [a[:, half:] if a.ndim > 1 else a for a in arrs]
    j1_y, j1_h = jax_ssd_scan(*(jnp.asarray(a) for a in first), chunk=32, interpret=True)
    j2_y, j2_h = jax_ssd_scan(*(jnp.asarray(a) for a in second), chunk=32,
                              init_state=j1_h, interpret=True)
    jax.block_until_ready(j2_y)

    y_full, h_full = ops.ssd_scan(*_torch(arrs, "float32"), chunk=32)
    y1, h1 = ops.ssd_scan(*_torch(first, "float32"), chunk=32)
    y2, h2 = ops.ssd_scan(*_torch(second, "float32"), chunk=32, init_state=h1)
    np.testing.assert_allclose(_np(y2), _np(y_full[:, half:]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h2), _np(h_full), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(y2), np.asarray(j2_y), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h2), np.asarray(j2_h), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# The wrapper on the CPU
# --------------------------------------------------------------------------- #
def test_cpu_wrapper_takes_plain_path_without_launching():
    case = SSD_CASES[0]
    inputs = _torch(_inputs(case, seed=1), "float32")
    before = ops.LAUNCHES
    y, h = ops.ssd_scan(*inputs, chunk=64)
    want_y, want_h = ref.ssd_reference(*inputs, chunk=64)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    # a chunk longer than the sequence is cut to it, as the Pallas wrapper does
    y_long, _ = ops.ssd_scan(*inputs, chunk=1024)
    assert torch.equal(y_long, ref.ssd_reference(*inputs, chunk=case[1])[0])
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("bad", ["chunk", "dt", "groups", "init", "devices"])
def test_wrapper_rejects_bad_inputs(bad):
    x, dt, A, B, C = _torch(_inputs((1, 64, 4, 16, 2, 8), seed=2), "float32")
    kw = {"chunk": 32}
    if bad == "chunk":
        kw["chunk"] = 24                        # 64 is not a multiple of 24
    elif bad == "dt":
        dt = dt[:, :, :2]
    elif bad == "groups":
        B, C = B[:, :, :1].expand(1, 64, 3, 8), C[:, :, :1].expand(1, 64, 3, 8)
    elif bad == "init":
        kw["init_state"] = torch.zeros(1, 4, 16, 4)
    else:
        A = A.to("meta")
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, B, C, **kw)


def test_build_lists_the_kernel_and_names_its_library_by_source():
    assert "ssd_scan" in _build.KERNELS
    assert [p.name for p in _build.sources("ssd_scan")] == [
        "ssd_scan_f32_sm90.cu", "ssd_scan_mma_sm90.cu", "ssd_scan_sm90.cu"]
    # the shared Hopper and TF32x3 headers are hashed into the name (and
    # reach nvcc by -I)
    assert _build.shared_include() / "hopper.cuh" in _build.headers("ssd_scan")
    assert _build.shared_include() / "tf32x3.cuh" in _build.headers("ssd_scan")
    lib = _build.library_path("ssd_scan")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libssd_scan-")


# --------------------------------------------------------------------------- #
# The CUDA kernel vs its plain version (host with a card)
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# SSD_CASES, the chunks of a 17-token forward and a 16-token prefill, and a
# ragged chunk of 96 (one full and one partial 64-row tile).
CARD_CASES = SSD_CASES + [
    (2, 17, 8, 16, 1, 16, 32, "float32"),
    (2, 16, 8, 16, 1, 16, 32, "float32"),
    (1, 192, 4, 32, 2, 128, 96, "bfloat16"),
]


@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_cuda_kernel_vs_plain(case, cuda_device):
    b, s, nh, p, g, n, chunk, name = case
    inputs = _torch(_inputs(case, seed=s + nh), name, cuda_device)
    before = ops.LAUNCHES
    y, h = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want_y, want_h = ref.ssd_reference(*inputs, chunk=min(chunk, s))
    _assert_y(y, want_y, name)
    _assert_state(h, want_h, name)


def test_cuda_kernel_reads_strided_views_and_init_state(cuda_device):
    """x, B, C as views into one (b, s, conv_dim) tensor, as the model passes
    them, and a continuation from an init state."""
    b, s, nh, p, g, n = 2, 128, 4, 32, 1, 16
    d_in = nh * p
    rng = np.random.default_rng(3)
    xbc = torch.from_numpy(rng.standard_normal((b, s, d_in + 2 * g * n)).astype(np.float32) * 0.4)
    xbc = xbc.to(cuda_device, torch.bfloat16)
    x = xbc[..., :d_in].reshape(b, s, nh, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    assert not x.is_contiguous() and x.data_ptr() == xbc.data_ptr()
    _, dt, A, _, _ = _torch(_inputs((b, s, nh, p, g, n), seed=4), "float32", cuda_device)
    init = torch.from_numpy(rng.standard_normal((b, nh, p, n)).astype(np.float32)).to(cuda_device)
    y, h = ops.ssd_scan(x, dt, A, B, C, chunk=64, init_state=init)
    want_y, want_h = ref.ssd_reference(x, dt, A, B, C, chunk=64, init_state=init)
    _assert_y(y, want_y, "bfloat16")
    _assert_state(h, want_h, "bfloat16")


def test_cuda_kernel_refuses_what_it_cannot_take(cuda_device):
    x, dt, A, B, C = _torch(_inputs((1, 64, 2, 48, 1, 16), seed=5), "float32", cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        ops.ssd_scan(x, dt, A, B, C, chunk=32)
    x, dt, A, B, C = _torch(_inputs((1, 64, 2, 16, 1, 16), seed=5), "float32", cuda_device)
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        ops.ssd_scan(x, dt, A, B, C, chunk=32)
