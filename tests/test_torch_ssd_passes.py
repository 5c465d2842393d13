"""The SSD scan's three passes (chunk states, state recurrence, outputs), the
variant table that picks the ``sm90``, ``tf32x3`` or ``mma`` kernel, and the
``sm90`` (bf16), ``tf32x3`` (float32) and ``mma`` (bf16) kernels on the card.

Inputs are made with numpy from a fixed seed. On the CPU the composition of
the plain passes (``repro_torch.models.ssm``: ``chunk_state``,
``state_pass``, ``chunk_scan``) is held against the JAX ``ssd_chunked`` and
the Pallas kernel in interpret mode. On a host with a card each ``sm90``,
``tf32x3`` and ``mma`` pass is held against its own plain pass, and the whole
scan against ``ssd_chunked`` (these tests skip elsewhere):

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_passes.py

Tolerances are the reference tests' own (``tests/test_kernels.py``): y within
1e-4 (f32) or 3e-2 (bf16) of max |y|; states at rtol = atol = 1e-4 (f32) or
1e-2 (bf16: the sm90 kernel rounds x dt exp(.) and each chunk's starting
state to bf16 as wgmma operands). The card tests of the three kernels:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_passes.py -k "sm90 or tf32x3 or mma"
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402

# (b, s, nh, p, g, n, chunk, dtype): SSD_CASES of tests/test_kernels.py, one
# more case with g > 1 (4 groups of 2 heads), and jamba-v0.1-52b's head
# layout (p 64, one group, n 16, chunks of 256) cut to 8 heads and 2 chunks.
CASES = [
    (2, 128, 8, 32, 1, 16, 64, "float32"),
    (1, 256, 4, 16, 2, 8, 32, "float32"),
    (1, 64, 2, 64, 1, 32, 64, "float32"),
    (2, 128, 4, 32, 1, 16, 32, "bfloat16"),
    (2, 128, 8, 16, 4, 16, 64, "float32"),
    (1, 512, 8, 64, 1, 16, 256, "float32"),
    (1, 512, 8, 64, 1, 16, 256, "bfloat16"),
]
CASE_IDS = [f"s{c[1]}nh{c[2]}p{c[3]}g{c[4]}n{c[5]}c{c[6]}{c[7]}" for c in CASES]
Y_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STATE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# The serving main path: mamba2-130m prefill, 8 x 4096 tokens.
MAIN = (8, 4096, 24, 64, 1, 128, 256, "bfloat16")


def _inputs(case, seed):
    """x, dt, A, B, C as float32 numpy arrays, with the reference test's scales."""
    b, s, nh, p, g, n = case[:6]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, p)) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, s, nh)), 0.0)          # softplus
    A = -np.exp(rng.standard_normal(nh) * 0.3)
    B = rng.standard_normal((b, s, g, n)) * 0.3
    C = rng.standard_normal((b, s, g, n)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def _torch(arrs, dtype_name, device="cpu"):
    dt = getattr(torch, dtype_name)
    x, d, A, B, C = (torch.from_numpy(a).to(device) for a in arrs)
    return x.to(dt), d, A, B.to(dt), C.to(dt)


def _np(t):
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _assert_y(got, want, name):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max()) + 1e-6
    assert float(np.abs(got - want).max()) / scale < Y_TOL[name]


def _assert_close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _passes(x, dt, A, B, C, chunk, init_state=None):
    """The three plain passes composed, as ``ssd_chunked`` composes them."""
    states, cum = ref.chunk_state_reference(x, dt, A, B, chunk)
    h_in, final = ref.state_pass_reference(states, cum, chunk, init_state)
    return ref.chunk_scan_reference(x, dt, B, C, cum, h_in, chunk), final


# --------------------------------------------------------------------------- #
# The plain passes vs the JAX reference (host with JAX)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_passes_vs_jax_and_pallas_interpret(case):
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

    y, h = _passes(*_torch(arrs, name), chunk)
    assert y.dtype == getattr(torch, name) and h.dtype == torch.float32
    for wy, wh in ((want_y, want_h), (pallas_y, pallas_h)):
        _assert_y(y, wy, name)
        _assert_close(h, wh, STATE_TOL[name])


def test_passes_continue_from_an_init_state_vs_jax():
    """scan(x[:half]) then scan(x[half:], init_state) through the plain
    passes == the JAX ssd_chunked and Pallas kernel on the same halves."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked

    case = (2, 128, 8, 16, 2, 16, 32, "float32")
    arrs = _inputs(case, seed=11)
    half = case[1] // 2
    first = [a[:, :half] if a.ndim > 1 else a for a in arrs]
    second = [a[:, half:] if a.ndim > 1 else a for a in arrs]
    _, h1 = _passes(*_torch(first, "float32"), 32)
    y2, h2 = _passes(*_torch(second, "float32"), 32, init_state=h1)

    j1 = jax_ssd_chunked(*(jnp.asarray(a) for a in first), chunk=32)[1]
    jy, jh = jax_ssd_chunked(*(jnp.asarray(a) for a in second), chunk=32, init_state=j1)
    p1 = jax_ssd_scan(*(jnp.asarray(a) for a in first), chunk=32, interpret=True)[1]
    py, ph = jax_ssd_scan(*(jnp.asarray(a) for a in second), chunk=32, init_state=p1,
                          interpret=True)
    jax.block_until_ready(py)
    for wy, wh in ((jy, jh), (py, ph)):
        _assert_y(y2, wy, "float32")
        _assert_close(h2, wh, 1e-4)


def test_ssd_chunked_is_the_composition_of_the_passes():
    case = CASES[4]
    inputs = _torch(_inputs(case, seed=3), "float32")
    init = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (case[0], case[2], case[3], case[5])).astype(np.float32))
    y, h = ref.ssd_reference(*inputs, chunk=case[6], init_state=init)
    py, ph = _passes(*inputs, case[6], init_state=init)
    assert torch.equal(y, py) and torch.equal(h, ph)


def test_pass_shapes_and_cpu_wrappers_take_the_plain_passes():
    b, s, nh, p, g, n, chunk, _ = CASES[4]
    x, dt, A, B, C = _torch(_inputs(CASES[4], seed=5), "float32")
    before = dict(ops.LAUNCHES_BY_VARIANT), ops.LAUNCHES
    states, cum = ops.chunk_state(x, dt, A, B, chunk)
    assert tuple(states.shape) == (b, s // chunk, nh, p, n) and tuple(cum.shape) == (b, nh, s)
    # cum is the prefix sum of dt * A within each chunk, restarting at each chunk
    dA = (dt * A).transpose(1, 2).reshape(b, nh, s // chunk, chunk)
    assert torch.allclose(cum.reshape(dA.shape), torch.cumsum(dA, -1), rtol=1e-6, atol=1e-6)
    h_in, final = ops.state_pass(states, cum, chunk)
    assert tuple(h_in.shape) == tuple(states.shape) and not h_in[:, 0].any()
    y = ops.chunk_scan(x, dt, B, C, cum, h_in, chunk)
    want_y, want_h = ref.ssd_reference(x, dt, A, B, C, chunk=chunk)
    assert torch.equal(y, want_y) and torch.equal(final, want_h)
    assert (dict(ops.LAUNCHES_BY_VARIANT), ops.LAUNCHES) == before


def test_chunk_scan_of_zero_x_is_the_inter_chunk_term():
    """With x = 0 only the starting states speak: y_i = exp(cum_i) C_i . h_in."""
    b, s, nh, p, g, n, chunk, _ = CASES[4]
    x, dt, A, B, C = _torch(_inputs(CASES[4], seed=12), "float32")
    h_in = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (b, s // chunk, nh, p, n)).astype(np.float32))
    _, cum = ops.chunk_state(x, dt, A, B, chunk)
    y = ops.chunk_scan(torch.zeros_like(x), dt, B, C, cum, h_in, chunk)
    rep, l = nh // g, s // chunk
    Cg = C.repeat_interleave(rep, dim=2).reshape(b, l, chunk, nh, n)
    want = torch.einsum("blchn,blhpn->blchp", Cg, h_in)
    want = want * torch.exp(cum).reshape(b, nh, l, chunk).permute(0, 2, 3, 1)[..., None]
    _assert_close(y, want.reshape(b, s, nh, p), 1e-5)


def test_state_pass_of_zero_chunk_states_decays_the_init_state():
    """With every chunk's own state 0, chunk k starts from the init state
    decayed by exp(cum_last) of the chunks before it."""
    b, s, nh, p, g, n, chunk, _ = CASES[1]
    x, dt, A, B, C = _torch(_inputs(CASES[1], seed=14), "float32")
    states, cum = ops.chunk_state(x, dt, A, B, chunk)
    init = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (b, nh, p, n)).astype(np.float32))
    h_in, final = ops.state_pass(torch.zeros_like(states), cum, chunk, init)
    last = cum.reshape(b, nh, s // chunk, chunk)[..., -1]                  # (b, nh, l)
    before = torch.cumsum(last, -1) - last                                 # exclusive
    want = init[:, None] * torch.exp(before).transpose(1, 2)[..., None, None]
    _assert_close(h_in, want, 1e-5)
    _assert_close(final, init * torch.exp(last.sum(-1))[..., None, None], 1e-5)


# --------------------------------------------------------------------------- #
# The variant table (chosen by shape before the launch, never by a failure)
# --------------------------------------------------------------------------- #
# (dtype, p, n, chunk, aligned, want)
VARIANT_TABLE = [
    ("bfloat16", 64, 128, 256, True, "sm90"),      # the serving main path
    ("bfloat16", 64, 64, 64, True, "sm90"),
    ("bfloat16", 64, 128, 128, True, "sm90"),
    ("bfloat16", 64, 64, 256, True, "sm90"),
    ("float32", 64, 128, 256, True, "tf32x3"),    # mamba2's shape in float32
    ("bfloat16", 16, 128, 256, True, "mma"),
    ("bfloat16", 32, 128, 256, True, "mma"),
    ("bfloat16", 64, 8, 256, True, "mma"),
    ("bfloat16", 64, 16, 256, True, "sm90"),       # jamba-v0.1-52b's SSM layers
    ("bfloat16", 64, 16, 128, True, "sm90"),
    ("bfloat16", 64, 16, 64, True, "sm90"),
    ("bfloat16", 64, 32, 256, True, "mma"),
    ("float32", 64, 16, 256, True, "tf32x3"),     # jamba's, in float32
    ("bfloat16", 64, 16, 256, False, "mma"),
    ("bfloat16", 64, 128, 96, True, "mma"),
    ("bfloat16", 64, 128, 17, True, "mma"),
    ("bfloat16", 64, 128, 256, False, "mma"),
    ("float32", 16, 16, 32, True, "tf32x3"),      # every float32 shape: tf32x3
    ("float32", 32, 16, 64, True, "tf32x3"),
    ("float32", 64, 8, 64, True, "tf32x3"),
    ("float32", 64, 128, 17, True, "tf32x3"),
    ("float32", 64, 128, 256, False, "tf32x3"),
    ("float32", 16, 8, 17, False, "tf32x3"),
]


@pytest.mark.parametrize("name,p,n,chunk,aligned,want", VARIANT_TABLE, ids=str)
def test_variant_table(name, p, n, chunk, aligned, want):
    assert ops.variant(getattr(torch, name), p, n, chunk, aligned) == want


def test_tma_alignment_of_the_models_views_and_of_a_misaligned_stride():
    """x, B, C as the model's views into the conv output (row stride 1792
    bf16 = 3584 bytes, offsets 0, 3072 and 3328 bytes) are TMA-aligned; a row
    stride of 1796 bf16 (3592 bytes) or a start 2 bytes in is not."""
    b, s, nh, p, g, n = 1, 8, 24, 64, 1, 128
    d_in = nh * p

    def views(width, start=0):
        xbc = torch.zeros(b, s, width + start, dtype=torch.bfloat16)[..., start:]
        x = xbc[..., :d_in].reshape(b, s, nh, p)
        B = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
        C = xbc[..., d_in + g * n:d_in + 2 * g * n].reshape(b, s, g, n)
        return x, B, C

    assert ops.tma_aligned(*views(d_in + 2 * g * n))
    assert ops.variant(torch.bfloat16, p, n, 256, ops.tma_aligned(*views(d_in + 2 * g * n))) == "sm90"
    assert not ops.tma_aligned(*views(d_in + 2 * g * n + 4))
    assert ops.variant(torch.bfloat16, p, n, 256, ops.tma_aligned(*views(d_in + 2 * g * n + 4))) == "mma"
    assert not ops.tma_aligned(*views(d_in + 2 * g * n, start=1))


def test_tma_alignment_of_jambas_conv_output_views():
    """jamba-v0.1-52b's x, B, C as views into its conv output: d_inner 8192
    + 2 g n = 8224 bf16 a row (16,448 bytes), B at byte 16,384 and C at
    16,416, each 16 columns (32 bytes) wide. TMA reads all three in place, so
    the scan runs on sm90."""
    b, s, nh, p, g, n = 1, 8, 128, 64, 1, 16
    d_in = nh * p
    xbc = torch.zeros(b, s, d_in + 2 * g * n, dtype=torch.bfloat16)
    x = xbc[..., :d_in].reshape(b, s, nh, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    assert xbc.stride(1) * 2 == 16448
    assert (B.data_ptr() - xbc.data_ptr(), C.data_ptr() - xbc.data_ptr()) == (16384, 16416)
    assert ops.tma_aligned(x, B, C)
    assert ops.variant(torch.bfloat16, p, n, 256, ops.tma_aligned(x, B, C)) == "sm90"


def test_variant_counts_cover_both_kernels():
    assert set(ops.LAUNCHES_BY_VARIANT) == {"sm90", "tf32x3", "mma"}


# --------------------------------------------------------------------------- #
# The sm90 kernel on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# One chunk of 64 at n 64, then n 128; chunks of 128 and 256 over several
# chunks; g 2 with nh 8; a head tile of 8 heads out of 24. Then n 16 (32-byte
# rows): one chunk of 64, chunks of 128 with g 2, and jamba's layout (128
# heads in one group) over 4 chunks of 256.
SM90_CASES = [
    (1, 64, 4, 64, 1, 64, 64, "bfloat16"),
    (1, 64, 4, 64, 1, 128, 64, "bfloat16"),
    (2, 512, 4, 64, 1, 128, 128, "bfloat16"),
    (2, 1024, 4, 64, 1, 128, 256, "bfloat16"),
    (2, 512, 8, 64, 2, 64, 128, "bfloat16"),
    (1, 512, 24, 64, 1, 128, 256, "bfloat16"),
    (1, 64, 4, 64, 1, 16, 64, "bfloat16"),
    (2, 512, 8, 64, 2, 16, 128, "bfloat16"),
    (2, 1024, 128, 64, 1, 16, 256, "bfloat16"),
]


def _card_inputs(case, seed, device):
    return _torch(_inputs(case, seed), case[7], device)


@pytest.mark.parametrize("case", SM90_CASES, ids=str)
def test_sm90_scan_vs_plain(case, cuda_device):
    b, s, nh, p, g, n, chunk, name = case
    inputs = _card_inputs(case, s + nh + n, cuda_device)
    assert ops.variant(inputs[0].dtype, p, n, chunk, ops.tma_aligned(inputs[0], *inputs[3:])) == "sm90"
    ops.LAUNCHES_BY_VARIANT.update(sm90=0, tf32x3=0, mma=0)
    y, h = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_VARIANT == {"sm90": 1, "tf32x3": 0, "mma": 0}
    want_y, want_h = ref.ssd_reference(*inputs, chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _assert_y(y, want_y, name)
    _assert_close(h, want_h, STATE_TOL[name])


@pytest.mark.parametrize("case", SM90_CASES, ids=str)
def test_sm90_passes_each_vs_its_plain_pass(case, cuda_device):
    b, s, nh, p, g, n, chunk, name = case
    x, dt, A, B, C = _card_inputs(case, s + nh + n + 1, cuda_device)
    states, cum = ops.chunk_state(x, dt, A, B, chunk)
    torch.cuda.synchronize()
    want_states, want_cum = ref.chunk_state_reference(x, dt, A, B, chunk)
    _assert_close(cum, want_cum, 1e-4)
    _assert_close(states, want_states, STATE_TOL[name])

    init = torch.randn(b, nh, p, n, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(1))
    h_in, final = ops.state_pass(want_states, want_cum, chunk, init)
    torch.cuda.synchronize()
    assert h_in.dtype == torch.bfloat16
    want_h_in, want_final = ref.state_pass_reference(want_states, want_cum, chunk, init)
    _assert_close(h_in, want_h_in, STATE_TOL[name])
    _assert_close(final, want_final, 1e-4)

    h_bf16 = want_h_in.to(torch.bfloat16)
    y = ops.chunk_scan(x, dt, B, C, want_cum, h_bf16, chunk)
    torch.cuda.synchronize()
    _assert_y(y, ref.chunk_scan_reference(x, dt, B, C, want_cum, h_bf16.float(), chunk), name)


@pytest.mark.parametrize("nh,n", [(8, 128), (128, 16)], ids=str)
def test_sm90_reads_conv_output_views_with_an_init_state(nh, n, cuda_device):
    """x, B, C as views into one (b, s, conv_dim) tensor, as the model passes
    them (TMA reads them in place), and a continuation from an init state:
    at mamba2's n 128 and at jamba's n 16 with 128 heads in one group."""
    b, s, p, g, chunk = 2, 1024, 64, 1, 256
    d_in = nh * p
    rng = np.random.default_rng(3)
    xbc = torch.from_numpy(rng.standard_normal((b, s, d_in + 2 * g * n)).astype(np.float32) * 0.4)
    xbc = xbc.to(cuda_device, torch.bfloat16)
    x = xbc[..., :d_in].reshape(b, s, nh, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    C = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    assert not x.is_contiguous() and ops.tma_aligned(x, B, C)
    _, dt, A, _, _ = _card_inputs((b, s, nh, p, g, n, chunk, "float32"), 4, cuda_device)
    init = torch.from_numpy(rng.standard_normal((b, nh, p, n)).astype(np.float32)).to(cuda_device)
    ops.LAUNCHES_BY_VARIANT.update(sm90=0, tf32x3=0, mma=0)
    y, h = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, init_state=init)
    assert ops.LAUNCHES_BY_VARIANT == {"sm90": 1, "tf32x3": 0, "mma": 0}
    want_y, want_h = ref.ssd_reference(x, dt, A, B, C, chunk=chunk, init_state=init)
    _assert_y(y, want_y, "bfloat16")
    _assert_close(h, want_h, STATE_TOL["bfloat16"])


def test_sm90_main_shape(cuda_device):
    b, s, nh, p, g, n, chunk, name = MAIN
    inputs = _card_inputs(MAIN, 8, cuda_device)
    y, h = ops.ssd_scan(*inputs, chunk=chunk)
    want_y, want_h = ref.ssd_reference(*inputs, chunk=chunk)
    _assert_y(y, want_y, name)
    _assert_close(h, want_h, STATE_TOL[name])


@pytest.mark.parametrize("case", [SM90_CASES[1], (1, 64, 4, 64, 1, 128, 64, "float32"),
                                  (1, 96, 4, 64, 1, 128, 96, "bfloat16"),
                                  (1, 64, 4, 32, 1, 128, 64, "bfloat16"),
                                  SM90_CASES[6], (1, 64, 4, 64, 1, 16, 64, "float32"),
                                  (1, 64, 4, 64, 1, 32, 64, "bfloat16")], ids=str)
def test_launches_by_variant_follow_the_table(case, cuda_device):
    b, s, nh, p, g, n, chunk, name = case
    inputs = _card_inputs(case, 9, cuda_device)
    want = ops.variant(getattr(torch, name), p, n, chunk, ops.tma_aligned(inputs[0], *inputs[3:]))
    ops.LAUNCHES_BY_VARIANT.update(sm90=0, tf32x3=0, mma=0)
    y, h = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_VARIANT == {k: int(k == want) for k in ("sm90", "tf32x3", "mma")}
    want_y, want_h = ref.ssd_reference(*inputs, chunk=chunk)
    _assert_y(y, want_y, name)
    _assert_close(h, want_h, STATE_TOL[name])


def test_sm90_passes_refuse_what_they_cannot_take(cuda_device):
    # bf16 at p 48: neither sm90 nor mma takes it
    x, dt, A, B, C = _card_inputs((1, 64, 2, 48, 1, 128, 64, "bfloat16"), 10, cuda_device)
    with pytest.raises(ValueError, match="sm90"):
        ops.chunk_state(x, dt, A, B, 64)
    # float32 at p 48, or with B in another dtype than x
    x, dt, A, B, C = _card_inputs((1, 64, 2, 48, 1, 16, 64, "float32"), 10, cuda_device)
    with pytest.raises(ValueError, match="tf32x3"):
        ops.chunk_state(x, dt, A, B, 64)
    x, dt, A, B, C = _card_inputs((1, 64, 2, 64, 1, 16, 64, "float32"), 10, cuda_device)
    with pytest.raises(ValueError, match="one dtype"):
        ops.chunk_scan(x, dt, B.to(torch.bfloat16), C, torch.zeros(1, 2, 64, device=cuda_device),
                       torch.zeros(1, 1, 2, 64, 16, device=cuda_device), 64)


# --------------------------------------------------------------------------- #
# The tf32x3 kernel on the card (float32, three TF32 products a product)
# --------------------------------------------------------------------------- #
# Every float32 case of chip_smoke.py's SSD_CASES (p 16 / 32 / 64, n 8 to
# 128, chunks 16, 17, 32, 64), the reference's p-64 case at n 32, mamba2's
# layout cut to 2 x 512, jamba's head layout (128 heads, n 16) cut to 8
# heads, a ragged chunk of 96 (one full and one partial tile), n 8 with g 2,
# and a d_state that is no power of two (n 48, padded to 64 in the tiles).
TF32X3_CASES = [
    (2, 128, 8, 32, 1, 16, 64, "float32"),
    (1, 256, 4, 16, 2, 8, 32, "float32"),
    (1, 64, 2, 64, 1, 32, 64, "float32"),
    (2, 16, 24, 64, 1, 128, 16, "float32"),
    (2, 17, 24, 64, 1, 128, 17, "float32"),
    (2, 512, 24, 64, 1, 128, 256, "float32"),
    (2, 512, 8, 64, 1, 16, 256, "float32"),
    (2, 17, 8, 64, 1, 16, 17, "float32"),
    (1, 192, 4, 32, 2, 128, 96, "float32"),
    (2, 128, 8, 16, 2, 8, 64, "float32"),
    (1, 128, 4, 64, 1, 48, 64, "float32"),
]


@pytest.mark.parametrize("case", TF32X3_CASES, ids=str)
def test_tf32x3_scan_vs_plain(case, cuda_device):
    b, s, nh, p, g, n, chunk, name = case
    inputs = _card_inputs(case, s + nh + n + 2, cuda_device)
    assert ops.variant(torch.float32, p, n, chunk) == "tf32x3"
    ops.LAUNCHES_BY_VARIANT.update(sm90=0, tf32x3=0, mma=0)
    y, h = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_VARIANT == {"sm90": 0, "tf32x3": 1, "mma": 0}
    want_y, want_h = ref.ssd_reference(*inputs, chunk=min(chunk, s))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _assert_y(y, want_y, name)
    _assert_close(h, want_h, STATE_TOL[name])


@pytest.mark.parametrize("case", TF32X3_CASES, ids=str)
def test_tf32x3_passes_each_vs_its_plain_pass(case, cuda_device):
    b, s, nh, p, g, n, chunk, name = case
    chunk = min(chunk, s)
    x, dt, A, B, C = _card_inputs(case, s + nh + n + 3, cuda_device)
    states, cum = ops.chunk_state(x, dt, A, B, chunk)
    torch.cuda.synchronize()
    want_states, want_cum = ref.chunk_state_reference(x, dt, A, B, chunk)
    _assert_close(cum, want_cum, 1e-4)
    _assert_close(states, want_states, 1e-4)

    init = torch.randn(b, nh, p, n, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(2))
    h_in, final = ops.state_pass(want_states, want_cum, chunk, init, dtype=torch.float32)
    torch.cuda.synchronize()
    assert h_in.dtype == torch.float32
    want_h_in, want_final = ref.state_pass_reference(want_states, want_cum, chunk, init)
    _assert_close(h_in, want_h_in, 1e-4)
    _assert_close(final, want_final, 1e-4)

    y = ops.chunk_scan(x, dt, B, C, want_cum, want_h_in, chunk)
    torch.cuda.synchronize()
    _assert_y(y, ref.chunk_scan_reference(x, dt, B, C, want_cum, want_h_in, chunk), name)


@pytest.mark.parametrize("pad", [0, 1], ids=["aligned", "padded"])
def test_tf32x3_reads_conv_output_views_with_an_init_state(pad, cuda_device):
    """x, B, C as views into one (b, s, conv_dim) float32 tensor, as the model
    passes them, rows padded by one float or not (4-byte or 16-byte copies),
    and a continuation from an init state."""
    b, s, nh, p, g, n, chunk = 2, 256, 8, 64, 1, 128, 128
    d_in = nh * p
    rng = np.random.default_rng(5)
    xbc = torch.from_numpy(rng.standard_normal((b, s, d_in + 2 * g * n + pad)).astype(np.float32)
                           * 0.4).to(cuda_device)
    x = xbc[..., :d_in].reshape(b, s, nh, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    C = xbc[..., d_in + g * n:d_in + 2 * g * n].reshape(b, s, g, n)
    assert not x.is_contiguous() and ops._vec(x, B, C) == (pad == 0)
    _, dt, A, _, _ = _card_inputs((b, s, nh, p, g, n, chunk, "float32"), 6, cuda_device)
    init = torch.from_numpy(rng.standard_normal((b, nh, p, n)).astype(np.float32)).to(cuda_device)
    ops.LAUNCHES_BY_VARIANT.update(sm90=0, tf32x3=0, mma=0)
    y, h = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, init_state=init)
    assert ops.LAUNCHES_BY_VARIANT == {"sm90": 0, "tf32x3": 1, "mma": 0}
    want_y, want_h = ref.ssd_reference(x, dt, A, B, C, chunk=chunk, init_state=init)
    _assert_y(y, want_y, "float32")
    _assert_close(h, want_h, STATE_TOL["float32"])


def test_tf32x3_is_deterministic(cuda_device):
    inputs = _card_inputs(TF32X3_CASES[5], 7, cuda_device)
    y1, h1 = ops.ssd_scan(*inputs, chunk=256)
    y2, h2 = ops.ssd_scan(*inputs, chunk=256)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


# --------------------------------------------------------------------------- #
# The mma kernel on the card (bf16 at the shapes sm90 does not take)
# --------------------------------------------------------------------------- #
# chip_smoke.py's bf16 p-32 case, the serve demo's reduced mamba2 (p 16, n 16,
# chunks of 32), p 32 at n 128 over two chunks of 256, n 8 with g 2, n 32 at
# p 64, a d_state that is no power of two (n 48, padded to 64 in the tiles),
# ragged chunks of 17 (jamba's decode forward's, cut to 8 heads) and 96 (one
# full and one partial tile), and chunks of 16.
MMA_CASES = [
    (2, 128, 4, 32, 1, 16, 32, "bfloat16"),
    (4, 32, 8, 16, 1, 16, 32, "bfloat16"),
    (1, 512, 8, 32, 1, 128, 256, "bfloat16"),
    (1, 256, 4, 16, 2, 8, 32, "bfloat16"),
    (1, 64, 4, 64, 1, 32, 64, "bfloat16"),
    (1, 128, 4, 64, 1, 48, 64, "bfloat16"),
    (2, 17, 8, 64, 1, 16, 17, "bfloat16"),
    (1, 192, 4, 32, 2, 128, 96, "bfloat16"),
    (2, 16, 24, 64, 1, 128, 16, "bfloat16"),
]


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_mma_scan_vs_plain(case, cuda_device):
    b, s, nh, p, g, n, chunk, name = case
    inputs = _card_inputs(case, s + nh + n + 4, cuda_device)
    assert ops.variant(torch.bfloat16, p, n, chunk, ops.tma_aligned(inputs[0], *inputs[3:])) == "mma"
    ops.LAUNCHES_BY_VARIANT.update(sm90=0, tf32x3=0, mma=0)
    y, h = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES_BY_VARIANT == {"sm90": 0, "tf32x3": 0, "mma": 1}
    want_y, want_h = ref.ssd_reference(*inputs, chunk=min(chunk, s))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _assert_y(y, want_y, name)
    _assert_close(h, want_h, STATE_TOL[name])


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_mma_passes_each_vs_its_plain_pass(case, cuda_device):
    b, s, nh, p, g, n, chunk, name = case
    chunk = min(chunk, s)
    x, dt, A, B, C = _card_inputs(case, s + nh + n + 5, cuda_device)
    states, cum = ops.chunk_state(x, dt, A, B, chunk)
    torch.cuda.synchronize()
    want_states, want_cum = ref.chunk_state_reference(x, dt, A, B, chunk)
    _assert_close(cum, want_cum, 1e-4)
    _assert_close(states, want_states, STATE_TOL[name])

    init = torch.randn(b, nh, p, n, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(3))
    h_in, final = ops.state_pass(want_states, want_cum, chunk, init, dtype=torch.float32)
    torch.cuda.synchronize()
    want_h_in, want_final = ref.state_pass_reference(want_states, want_cum, chunk, init)
    _assert_close(h_in, want_h_in, 1e-4)
    _assert_close(final, want_final, 1e-4)

    y = ops.chunk_scan(x, dt, B, C, want_cum, want_h_in, chunk)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    _assert_y(y, ref.chunk_scan_reference(x, dt, B, C, want_cum, want_h_in, chunk), name)


@pytest.mark.parametrize("pad,start,elems", [(0, 0, 8), (4, 0, 2), (0, 1, 1)],
                         ids=["aligned", "padded", "odd_start"])
def test_mma_reads_conv_output_views_with_an_init_state(pad, start, elems, cuda_device):
    """x, B, C as views into one (b, s, conv_dim) bf16 tensor, as the model
    passes them: rows as they are (16-byte copies), padded by 4 bf16 (4-byte
    copies) or starting one bf16 in (2-byte loads); and a continuation from
    an init state."""
    b, s, nh, p, g, n, chunk = 2, 256, 8, 32, 1, 16, 128
    d_in = nh * p
    rng = np.random.default_rng(7)
    width = d_in + 2 * g * n + pad
    xbc = torch.from_numpy(rng.standard_normal((b, s, width + start)).astype(np.float32) * 0.4)
    xbc = xbc.to(cuda_device, torch.bfloat16)[..., start:]
    x = xbc[..., :d_in].reshape(b, s, nh, p)
    B = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    C = xbc[..., d_in + g * n:d_in + 2 * g * n].reshape(b, s, g, n)
    assert not x.is_contiguous() and ops._elems(x, B, C) == elems
    _, dt, A, _, _ = _card_inputs((b, s, nh, p, g, n, chunk, "float32"), 8, cuda_device)
    init = torch.from_numpy(rng.standard_normal((b, nh, p, n)).astype(np.float32)).to(cuda_device)
    ops.LAUNCHES_BY_VARIANT.update(sm90=0, tf32x3=0, mma=0)
    y, h = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, init_state=init)
    assert ops.LAUNCHES_BY_VARIANT == {"sm90": 0, "tf32x3": 0, "mma": 1}
    want_y, want_h = ref.ssd_reference(x, dt, A, B, C, chunk=chunk, init_state=init)
    _assert_y(y, want_y, "bfloat16")
    _assert_close(h, want_h, STATE_TOL["bfloat16"])


def test_mma_is_deterministic(cuda_device):
    inputs = _card_inputs(MMA_CASES[2], 9, cuda_device)
    y1, h1 = ops.ssd_scan(*inputs, chunk=256)
    y2, h2 = ops.ssd_scan(*inputs, chunk=256)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
