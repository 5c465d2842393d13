"""The port's blockwise int8 quantise / dequantise: plain version, wrappers and
CUDA kernels.

Inputs are made with numpy from fixed seeds and handed to both packages.
Every comparison is exact (``array_equal``), as ``tests/test_kernels.py``
holds the Pallas kernel to its oracle: the function is a division, a round
half to even and a clip in float32, with no sum whose order could differ.
On a host with a card the CUDA kernels are held against the plain version,
bit for bit (those tests skip elsewhere):

    PYTHONPATH=src python -m pytest -q tests/test_torch_quant.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.quant_blockwise import ops, ref  # noqa: E402

# (n, d, block, row_tile): the cases of tests/test_kernels.py::test_quant_2d_vs_oracle
CASES_2D = [(64, 512, 128, 32), (256, 256, 256, 256), (32, 1024, 512, 16)]
# the leaf shapes of tests/test_kernels.py::test_quant_roundtrip_error_bound
LEAF_SHAPES = [(33,), (7, 129), (4, 4, 100), (1000,)]
TIE_VALUES = [0.5, -0.5, 2.5, -3.5, 127.0, 1.5, -1.5]     # amax 127 -> s = 1


def _normal(shape, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tie_block(block=256):
    x = np.zeros((1, block), np.float32)
    x[0, :len(TIE_VALUES)] = TIE_VALUES
    return x


def _np(t):
    return t.cpu().numpy()


def _equal(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


# --------------------------------------------------------------------------- #
# Plain version vs the JAX reference and the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------- #
def _jax_2d(x, block, rt):
    import jax.numpy as jnp
    from repro.kernels.quant_blockwise.quant_blockwise import (dequantize_blockwise_2d,
                                                               quantize_blockwise_2d)
    from repro.kernels.quant_blockwise.ref import quantize_reference
    q, s = quantize_blockwise_2d(jnp.asarray(x), block=block, row_tile=rt, interpret=True)
    # The eager oracle divides by 127 where the compiled kernel multiplies by
    # the float32 reciprocal: q agrees, s within one ulp (rtol 1e-6 there).
    qr, sr = quantize_reference(jnp.asarray(x), block=block)
    assert _equal(q, qr)
    np.testing.assert_array_max_ulp(np.asarray(s), np.asarray(sr), maxulp=1)
    xd = dequantize_blockwise_2d(q, s, block=block, row_tile=rt, interpret=True)
    return np.asarray(q), np.asarray(s), np.asarray(xd)


def _port_2d(x, block):
    tx = torch.from_numpy(x)
    q, s = ops.quantize_blockwise_2d(tx, block)
    qr, sr = ref.quantize_reference(tx, block)
    assert _equal(_np(q), _np(qr)) and _equal(_np(s), _np(sr))
    return _np(q), _np(s), _np(ops.dequantize_blockwise_2d(q, s, block))


@pytest.mark.parametrize("n,d,block,rt", CASES_2D)
def test_plain_2d_vs_jax(n, d, block, rt):
    pytest.importorskip("jax")
    x = _normal((n, d), seed=n + d)
    for got, want in zip(_port_2d(x, block), _jax_2d(x, block, rt)):
        assert got.dtype == want.dtype and _equal(got, want)


@pytest.mark.parametrize("kind", ["tie", "zero"])
def test_plain_tie_and_zero_blocks_vs_jax(kind):
    pytest.importorskip("jax")
    x = _tie_block() if kind == "tie" else np.zeros((1, 256), np.float32)
    got = _port_2d(x, 256)
    for g, w in zip(got, _jax_2d(x, 256, 1)):
        assert _equal(g, w)
    q, s, xd = got
    if kind == "tie":       # round half to even: 0.5 -> 0, 2.5 -> 2, -3.5 -> -4
        assert s[0, 0] == 1.0
        assert q[0, :len(TIE_VALUES)].tolist() == [0, 0, 2, -4, 127, 2, -2]
    else:                   # amax 0 -> s = 1e-12 * f32(1/127), q = 0
        assert s[0, 0] == np.float32(1e-12) * np.float32(1 / 127)
        assert not q.any() and not xd.any()


def test_plain_non_finite_blocks_vs_jax():
    """A NaN block gives s = NaN, an infinite one s = +inf; both give q = 0 and
    dequantise to NaN, as the reference (jnp.max propagates NaN)."""
    pytest.importorskip("jax")
    x = np.tile(np.linspace(-1, 1, 256, dtype=np.float32), (4, 1))
    x[0, 3] = np.nan
    x[1, 5] = np.inf
    x[2, 7] = -np.inf
    x[3, 9] = np.nan
    x[3, 11] = np.inf
    q, s, xd = _port_2d(x, 256)
    for g, w in zip((q, s, xd), _jax_2d(x, 256, 4)):
        assert _equal(g, w)
    assert np.isnan(s[[0, 3], 0]).all() and (s[[1, 2], 0] == np.inf).all()
    assert not q.any() and np.isnan(xd).all()


# --------------------------------------------------------------------------- #
# Any-shape wrappers vs repro.kernels.quant_blockwise.ops
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", LEAF_SHAPES, ids=str)
def test_wrappers_vs_jax_ops(shape):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.quant_blockwise import ops as jops
    x = _normal(shape, seed=sum(shape), scale=2.0)
    before = dict(ops.LAUNCHES)
    q, s = ops.quantize_blockwise(torch.from_numpy(x), block=256)
    xd = ops.dequantize_blockwise(q, s, shape, block=256)
    assert ops.LAUNCHES == before               # the CPU path launches nothing
    jq, js = jops.quantize_blockwise(jnp.asarray(x), block=256)
    jxd = jops.dequantize_blockwise(jq, js, shape, block=256)
    assert _equal(_np(q), jq) and _equal(_np(s), js) and _equal(_np(xd), jxd)
    assert tuple(xd.shape) == shape and xd.dtype == torch.float32
    amax = float(np.abs(x).max())               # the reference test's error bound
    assert float(np.abs(_np(xd) - x).max()) <= amax / 127 * 0.51 + 1e-6


def test_301_blocks_where_the_reference_wrapper_asserts():
    """76,805 values = 301 blocks of 256: the reference's ops tiles rows by 256
    and asserts; the port takes it, and equals the reference oracle on the
    zero-padded array."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.quant_blockwise import ops as jops
    from repro.kernels.quant_blockwise.ref import dequantize_reference, quantize_reference
    n = 76_805
    x = _normal((n,), seed=301)
    with pytest.raises(AssertionError):
        jops.quantize_blockwise(jnp.asarray(x), block=256)
    q, s = ops.quantize_blockwise(torch.from_numpy(x), block=256)
    assert tuple(q.shape) == (301, 256) and tuple(s.shape) == (301,)
    padded = np.concatenate([x, np.zeros(301 * 256 - n, np.float32)]).reshape(301, 256)
    jq, js = quantize_reference(jnp.asarray(padded), block=256)
    assert _equal(_np(q), jq)
    np.testing.assert_array_max_ulp(_np(s), np.asarray(js)[:, 0], maxulp=1)   # see _jax_2d
    # the compiled reference takes the 301 blocks as 301 rows of one tile
    from repro.kernels.quant_blockwise.quant_blockwise import quantize_blockwise_2d
    kq, ks = quantize_blockwise_2d(jnp.asarray(padded), block=256, row_tile=301,
                                   interpret=True)
    assert _equal(_np(q), kq) and _equal(_np(s), np.asarray(ks)[:, 0])
    xd = ops.dequantize_blockwise(q, s, (n,), block=256)
    jxd = np.asarray(dequantize_reference(kq, ks, block=256)).reshape(-1)[:n]
    assert _equal(_np(xd), jxd)


@pytest.mark.parametrize("dtype", ["float64", "float16", "bfloat16"])
def test_other_float_inputs_quantise_as_float32(dtype):
    x = torch.from_numpy(_normal((5, 256), seed=9)).to(getattr(torch, dtype))
    q, s = ops.quantize_blockwise_2d(x, 256)
    qr, sr = ref.quantize_reference(x.float(), 256)
    assert torch.equal(q, qr) and torch.equal(s, sr)


@pytest.mark.parametrize("bad", ["ragged", "rank", "int", "block", "scales"])
def test_wrappers_reject_bad_inputs(bad):
    x = torch.zeros(4, 256)
    with pytest.raises((ValueError, TypeError)):
        if bad == "ragged":
            ops.quantize_blockwise_2d(torch.zeros(4, 200), 256)
        elif bad == "rank":
            ops.quantize_blockwise_2d(torch.zeros(256), 256)
        elif bad == "int":
            ops.quantize_blockwise(torch.zeros(256, dtype=torch.int32))
        elif bad == "block":
            ops.quantize_blockwise(x, block=0)
        else:
            q, s = ops.quantize_blockwise(x)
            ops.dequantize_blockwise(q, s[:-1], (4, 256))


def test_build_registers_the_source():
    assert "quant_blockwise" in _build.KERNELS
    assert [p.name for p in _build.sources("quant_blockwise")] == ["quant_blockwise.cu"]
    assert _build.library_path("quant_blockwise").parent == _build.BUILD_DIR


# --------------------------------------------------------------------------- #
# The CUDA kernels vs the plain version (host with a card)
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _card_2d(x, block, dev, out_dtype=torch.float32):
    t = x.to(dev)
    before = dict(ops.LAUNCHES)
    q, s = ops.quantize_blockwise_2d(t, block)
    xd = ops.dequantize_blockwise_2d(q, s, block, out_dtype)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {k: v + 1 for k, v in before.items()}
    qr, sr = ref.quantize_reference(t, block)
    xr = ref.dequantize_reference(qr, sr, block, out_dtype)
    assert torch.equal(q, qr)
    assert _equal(_np(s), _np(sr)) and _equal(_np(xd.float()), _np(xr.float()))


# 2-D cases: the reference's, which are the blocks of the vector path (128,
# 256, 512), and blocks that take the generic path (every other size).
CARD_2D = CASES_2D + [(3, 96, 96, 0), (5, 300, 100, 0), (2, 2048, 2048, 0),
                      (4, 384 * 2, 384, 0), (3, 640, 640, 0), (2, 768, 768, 0), (2, 1792, 896, 0),
                      (2, 1024, 1024, 0)]


@pytest.mark.parametrize("n,d,block,rt", CARD_2D)
def test_cuda_2d_vs_plain(n, d, block, rt, cuda_device):
    _card_2d(torch.from_numpy(_normal((n, d), seed=n * d)), block, cuda_device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bf16_in_and_out(dtype, cuda_device):
    x = torch.from_numpy(_normal((16, 512), seed=4)).to(getattr(torch, dtype))
    _card_2d(x, 256, cuda_device, out_dtype=torch.bfloat16)


def test_cuda_tie_zero_and_non_finite_blocks(cuda_device):
    x = np.zeros((6, 256), np.float32)
    x[0] = _tie_block()[0]
    x[2] = np.linspace(-1, 1, 256)
    x[2, 3] = np.nan
    x[3] = np.linspace(-1, 1, 256)
    x[3, 5] = -np.inf
    x[4] = _normal((256,), seed=5)
    x[5, 0] = 1e-30                     # amax below the 1e-12 floor
    _card_2d(torch.from_numpy(x), 256, cuda_device)
    q, s = ops.quantize_blockwise_2d(torch.from_numpy(x).to(cuda_device), 256)
    assert q[0, :len(TIE_VALUES)].tolist() == [0, 0, 2, -4, 127, 2, -2]


@pytest.mark.parametrize("n_blocks", [1, 37, 256, 301])
@pytest.mark.parametrize("tail", [0, 77])
def test_cuda_codec_layout_vs_plain(n_blocks, tail, cuda_device):
    n = n_blocks * 256 - (tail if n_blocks > 1 else 0)
    x = torch.from_numpy(_normal((n,), seed=n))
    q, s = ops.quantize_blockwise(x.to(cuda_device))
    xd = ops.dequantize_blockwise(q, s, (n,))
    qr, sr = ops.quantize_blockwise(x)
    xr = ops.dequantize_blockwise(qr, sr, (n,))
    assert torch.equal(q.cpu(), qr) and torch.equal(s.cpu(), sr) and torch.equal(xd.cpu(), xr)


def test_cuda_unaligned_view_takes_the_generic_path(cuda_device):
    x = torch.from_numpy(_normal((1025,), seed=8)).to(cuda_device)[1:]   # 4-byte offset
    q, s = ops.quantize_blockwise(x)
    qr, sr = ref.quantize_reference(x.reshape(4, 256), 256)
    assert torch.equal(q, qr) and torch.equal(s, sr[:, 0])
