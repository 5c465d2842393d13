"""The port's flash-attention kernel, its wrapper and its plain version.

Inputs are made with numpy from a fixed seed. On a host with JAX, the plain
version is held against the JAX reference and the Pallas kernel (interpret
mode). On a host with a card, the CUDA kernel is held against the plain
version (these tests skip elsewhere). The module imports JAX only inside the
tests that need it, so that the card tests also run where JAX is missing:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# (b, s, t, h, kh, d, causal, dtype, bq, bk): FA_CASES of tests/test_kernels.py
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, "float32", 64, 64),
    (1, 256, 256, 8, 8, 64, True, "float32", 128, 128),
    (2, 128, 128, 4, 1, 128, False, "float32", 64, 32),
    (1, 128, 128, 2, 2, 64, True, "bfloat16", 64, 64),
    (1, 64, 64, 4, 4, 32, False, "bfloat16", 32, 32),
]
# head dim 16, which every reduced config has: causal GQA, f32 and bf16
D16_CASES = [
    (2, 128, 128, 4, 2, 16, True, "float32", 64, 64),
    (2, 128, 128, 4, 2, 16, True, "bfloat16", 64, 64),
]
CASE_IDS = [f"s{c[1]}h{c[3]}kh{c[4]}d{c[5]}c{int(c[6])}{c[7]}" for c in FA_CASES + D16_CASES]

# f32: both sides compute in float32, in another summation order.
# bf16: the oracles round the normalised softmax weights to bf16 before P.V,
# the sm90 kernel the unnormalised ones and the simt kernel none (the
# tolerance of tests/test_kernels.py).
TOL = {"float32": 5e-5, "bfloat16": 2.5e-2}


def _numpy_inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv)]


def _torch_inputs(arrs, dtype_name, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype_name)) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------- #
# Plain version vs the JAX reference (host with JAX)
# --------------------------------------------------------------------------- #
def test_fa_cases_are_the_reference_cases():
    pytest.importorskip("jax")
    from test_kernels import FA_CASES as JAX_CASES
    assert [c[:7] + (c[7].__name__,) + c[8:] for c in JAX_CASES] == FA_CASES


@pytest.mark.parametrize("case", FA_CASES + D16_CASES, ids=CASE_IDS)
def test_torch_reference_vs_jax(case):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import attention_reference as jax_reference
    from repro.kernels.flash_attention import flash_attention as jax_flash_attention

    b, s, t, h, kh, d, causal, name, bq, bk = case
    arrs = _numpy_inputs((b, s, h, d), (b, t, kh, d), seed=s * h + d)
    tq, tk, tv = _torch_inputs(arrs, name)
    got = ref.attention_reference(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[name]
    # JAX on the CPU in full f32 precision, wherever this runs: on a GPU its
    # f32 matmuls would default to TF32 and miss the f32 tolerance.
    with jax.default_device(jax.devices("cpu")[0]):
        jq, jk, jv = [jnp.asarray(a).astype(name) for a in arrs]
        want_ref = jax_reference(jq, jk, jv, causal=causal)
        want_kernel = jax_flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                          block_k=bk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want_ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(want_kernel), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# The wrapper on the CPU
# --------------------------------------------------------------------------- #
def test_cpu_wrapper_takes_plain_path_without_launching():
    q, k, v = _torch_inputs(_numpy_inputs((2, 33, 4, 16), (2, 33, 2, 16), seed=3), "float32")
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES == before
    torch.testing.assert_close(got, ref.attention_reference(q, k, v, causal=True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["heads", "dtype", "rank", "mixed"])
def test_wrapper_rejects_bad_inputs(bad):
    q = torch.zeros(1, 8, 4, 32)
    k = v = torch.zeros(1, 8, 2, 32)
    if bad == "heads":
        k = v = torch.zeros(1, 8, 3, 32)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "rank":
        q = q[0]
    else:
        k = k.bfloat16()
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v)


# The kernel each (dtype, head dim) takes on the card: the tensor-core kernel
# for bf16 at D 64 and 128, the CUDA-core kernel for the rest.
VARIANT_TABLE = [
    ("float32", 16, "simt"), ("bfloat16", 16, "simt"),
    ("float32", 32, "simt"), ("float32", 64, "simt"), ("float32", 128, "simt"),
    ("bfloat16", 32, "simt"), ("bfloat16", 64, "sm90"), ("bfloat16", 128, "sm90"),
]


@pytest.mark.parametrize("name,d,want", VARIANT_TABLE)
def test_variant_table(name, d, want):
    assert ops.variant(getattr(torch, name), d) == want


def test_variant_table_covers_every_supported_input():
    assert sorted((n, d) for n, d, _ in VARIANT_TABLE) == sorted(
        (str(t).split(".")[1], d) for t in ops._DTYPE_CODE for d in ops.SUPPORTED_D)
    assert set(ops.LAUNCHES_BY_VARIANT) == {"sm90", "simt"} == set(ops._VARIANT_CODE)


def test_cpu_wrapper_counts_no_variant_launch():
    before = dict(ops.LAUNCHES_BY_VARIANT)
    q, k, v = _torch_inputs(_numpy_inputs((1, 16, 2, 64), (1, 16, 2, 64), seed=4), "bfloat16")
    ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES_BY_VARIANT == before


def test_build_names_libraries_by_source_and_needs_nvcc():
    srcs = _build.sources("flash_attention")
    assert [p.name for p in srcs] == ["flash_attention.cu", "flash_attention_sm90.cu"]
    assert _build.headers("flash_attention") == [_build.shared_include() / "hopper.cuh"]
    lib = _build.library_path("flash_attention")
    assert lib.parent == _build.BUILD_DIR and lib == _build.library_path("flash_attention")
    try:
        _build.nvcc()
    except _build.KernelBuildError:
        if not lib.exists():   # no toolchain and nothing built: fail loudly, no fallback
            with pytest.raises(_build.KernelBuildError, match="nvcc"):
                _build.build(["flash_attention"])


def test_build_hashes_headers_but_compiles_only_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "k" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    header = csrc / "k.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu"]
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    header.write_text("// two\n")
    assert _build.library_path("k") != first
    # a header in the shared directory is hashed into every library's name
    second = _build.library_path("k")
    shared = tmp_path / "csrc"
    shared.mkdir()
    (shared / "common.cuh").write_text("// shared\n")
    assert _build.headers("k") == [shared / "common.cuh", header]
    assert _build.library_path("k") != second


# --------------------------------------------------------------------------- #
# The CUDA kernels vs their plain version (host with a card)
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# FA_CASES, ragged cases the reference cannot take, the serving shape, and
# for the tensor-core kernel: one q and one kv tile at D 64 and 128, a ragged
# causal case (S not a multiple of 128, so the last tile's second consumer
# holds no row), GQA with rep 4 at D 64, and D 128 without the mask; then
# the encoder-decoder's and the VLM's prefill shapes: whisper-tiny's encoder
# (not causal, S = T = 1500: a last q tile of 92 rows, its second consumer
# holding 28, and a last kv tile of 92 columns), decoder self-attention and
# cross attention (S = 384 decoder rows against T = 1500 encoder rows), and
# qwen2-vl-2b's GQA at rep 6; S != T in float32 (the simt kernel: the
# cross attention of whisper's float32 decode check); and D 16 (the reduced
# configs' head dim) causal GQA and ragged, in both dtypes.
CARD_CASES = [c[:8] for c in FA_CASES] + [
    (2, 200, 200, 8, 2, 128, True, "bfloat16"),
    (1, 77, 77, 4, 4, 64, False, "float32"),
    (8, 1024, 1024, 32, 8, 128, True, "bfloat16"),
    (1, 128, 128, 2, 2, 64, False, "bfloat16"),
    (1, 128, 128, 2, 2, 128, False, "bfloat16"),
    (1, 1000, 1000, 32, 8, 128, True, "bfloat16"),
    (2, 384, 384, 16, 4, 64, True, "bfloat16"),
    (2, 300, 300, 8, 2, 128, False, "bfloat16"),
    (8, 1500, 1500, 6, 6, 64, False, "bfloat16"),
    (8, 384, 384, 6, 6, 64, True, "bfloat16"),
    (8, 384, 1500, 6, 6, 64, False, "bfloat16"),
    (8, 2048, 2048, 12, 2, 128, True, "bfloat16"),
    (2, 17, 1500, 6, 6, 64, False, "float32"),
] + [c[:8] for c in D16_CASES] + [
    (1, 200, 200, 4, 4, 16, False, "float32"),
    (1, 200, 200, 4, 4, 16, False, "bfloat16"),
]


@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_cuda_kernel_vs_plain(case, cuda_device):
    b, s, t, h, kh, d, causal, name = case
    # On the card, f32 differs from the plain version only in summation order.
    tol = {"float32": 1e-4, "bfloat16": 2.5e-2}[name]
    arrs = _numpy_inputs((b, s, h, d), (b, t, kh, d), seed=s + d)
    q, k, v = _torch_inputs(arrs, name, cuda_device)
    before, by_variant = ops.LAUNCHES, dict(ops.LAUNCHES_BY_VARIANT)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    kind = ops.variant(q.dtype, d)
    by_variant[kind] += 1
    assert ops.LAUNCHES_BY_VARIANT == by_variant, f"{case} did not run {kind}"
    want = ref.attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_cuda_kernel_rejects_unsupported_head_dim(cuda_device):
    q = torch.zeros(1, 8, 2, 8, device=cuda_device)
    k = v = torch.zeros(1, 8, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, k, v)
