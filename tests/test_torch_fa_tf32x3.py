"""The arithmetic of the float32 flash-attention kernel (``tf32x3``), on the CPU.

The kernel (``csrc/flash_attention_f32_sm90.cu``) runs both products of
attention on the tensor cores, which take float32 only as TF32 (a 10-bit
mantissa). It splits every operand x = hi + lo and sums three TF32 products,
lo*hi + hi*lo + hi*hi, in float32. The kernel itself runs only on a card;
here a torch model of that arithmetic, accumulated in float64, is held
against the port's plain version (``ref.attention_reference``) and the JAX
reference at every float32 shape of ``chip_smoke.py``'s ``FA_CASES``, with
the card's float32 limit (1e-4 abs + 1e-4 rel):

* the kernel's split (hi = x truncated to TF32, lo = x - hi, of which a
  tensor core reads the top 19 bits) and a round-to-nearest split both stay
  under 5% of the limit;
* one TF32 product per product misses the limit at D 128, which is why the
  kernel takes three.

    PYTHONPATH=src python -m pytest -q tests/test_torch_fa_tf32x3.py
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (b, s, t, h, kh, d, causal): the float32 rows of chip_smoke.py's FA_CASES
F32_CASES = [
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 64, True),
    (2, 128, 128, 4, 1, 128, False),
    (1, 77, 77, 4, 4, 64, False),
    (2, 17, 17, 32, 8, 128, True),
    (2, 16, 16, 32, 8, 128, True),
    (2, 17, 1500, 6, 6, 64, False),
    (2, 128, 128, 4, 2, 16, True),
    (1, 200, 200, 4, 4, 16, False),
]
CASE_IDS = [f"b{c[0]}s{c[1]}t{c[2]}h{c[3]}kh{c[4]}d{c[5]}c{int(c[6])}" for c in F32_CASES]
LIMIT = 1e-4                 # chip_smoke.py's float32 TOL, abs and rel
THREE_SHARE = 0.05           # the share of the limit three products may use
SPLITS = ("kernel", "nearest")


def tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """float32 x as TF32: its low 13 bits cleared (``trunc``) or rounded to
    nearest with ties away from zero (``nearest``, PTX cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    if rounding == "nearest":
        bits = bits + 0x1000
    bits = (bits & 0xFFFFE000) - ((bits & 0x80000000) << 1)   # back to a signed int32
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor, how: str):
    """x = hi + lo as the tensor core reads them. ``kernel``: hi truncated,
    lo = x - hi exact in float32, read truncated; ``nearest``: both rounded
    to nearest (cvt.rna)."""
    rounding = "trunc" if how == "kernel" else "nearest"
    hi = tf32(x, rounding)
    return hi, tf32(x - hi, rounding)


def product(a: torch.Tensor, b: torch.Tensor, how: str, terms: int = 3) -> torch.Tensor:
    """a @ b (float32 operands, last dims contracted) as TF32 products summed
    in float64: three (lo*hi + hi*lo + hi*hi) or one (hi*hi)."""
    ah, al = split(a, how)
    bh, bl = split(b, how)
    out = ah.double() @ bh.double()
    if terms == 3:
        out = out + al.double() @ bh.double() + ah.double() @ bl.double()
    return out


def attention_model(q, k, v, causal: bool, how: str, terms: int = 3) -> torch.Tensor:
    """The kernel's function with its products as TF32 products: scores from
    q k^T, the causal mask to -1e30, unnormalised weights exp(s - max)
    rounded to float32 (the kernel holds them in float32), P V, then the
    division by the weights' sum. q: (B, S, H, D); k, v: (B, T, KH, D)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    rep = h // kh
    qh = q.permute(0, 2, 1, 3)                                       # (B, H, S, D)
    kt = k.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)         # (B, H, D, T)
    vh = v.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)         # (B, H, T, D)
    scores = product(qh, kt, how, terms) / math.sqrt(d)
    if causal:
        mask = torch.arange(s)[:, None] >= torch.arange(t)[None, :]
        scores = torch.where(mask, scores, torch.tensor(-1e30, dtype=torch.float64))
    w = torch.exp(scores - scores.amax(-1, keepdim=True)).float()
    o = product(w, vh, how, terms) / w.double().sum(-1, keepdim=True)
    return o.permute(0, 2, 1, 3)


def _inputs(case, seed):
    b, s, t, h, kh, d, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d))]


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error as a share of the limit |want| * 1e-4 + 1e-4."""
    want = want.double()
    return float(((got - want).abs() / (LIMIT + LIMIT * want.abs())).max())


def test_cases_are_chip_smokes_float32_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert [c[:7] for c in smoke.FA_CASES if c[7] == torch.float32] == F32_CASES
    assert smoke.TOL[torch.float32] == LIMIT


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
def test_tf32_keeps_ten_mantissa_bits(rounding):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 1e3)
    hi = tf32(x, rounding)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    rel = ((hi.double() - x.double()).abs() / x.double().abs()).max()
    assert rel < (2.0 ** -10 if rounding == "trunc" else 2.0 ** -11)
    assert bool((torch.sign(hi) == torch.sign(x)).all())
    assert torch.equal(tf32(hi, rounding), hi)


@pytest.mark.parametrize("how", SPLITS)
def test_split_leaves_a_rest_below_2_to_the_minus_20(how):
    """hi + lo reproduces x to 2^-21 (kernel: lo read truncated) or 2^-22
    (nearest) of |x|: the lo*lo term left out is below 2^-20 |a| |b|."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    hi, lo = split(x, how)
    rest = (x.double() - hi.double() - lo.double()).abs() / x.double().abs()
    assert float(rest.max()) < (2.0 ** -21 if how == "kernel" else 2.0 ** -22)
    assert float((lo.double().abs() / x.double().abs()).max()) <= 2.0 ** -10


@pytest.mark.parametrize("how", SPLITS)
@pytest.mark.parametrize("case", F32_CASES, ids=CASE_IDS)
def test_three_tf32_products_keep_float32s_limit(case, how):
    q, k, v = _inputs(case, seed=case[1] + case[5])
    causal = case[6]
    got = attention_model(q, k, v, causal, how)
    share = _share(got, ref.attention_reference(q, k, v, causal=causal))
    assert share < THREE_SHARE, f"three TF32 products use {share:.4f} of the float32 limit"
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import attention_reference as jax_reference

    with jax.default_device(jax.devices("cpu")[0]):
        want = jax_reference(*[jnp.asarray(x.numpy()) for x in (q, k, v)], causal=causal)
    assert _share(got, torch.from_numpy(np.array(want))) < THREE_SHARE


@pytest.mark.parametrize("case", [c for c in F32_CASES if c[5] == 128],
                         ids=[i for c, i in zip(F32_CASES, CASE_IDS) if c[5] == 128])
def test_one_tf32_product_misses_the_limit_at_d128(case):
    q, k, v = _inputs(case, seed=case[1] + case[5])
    causal = case[6]
    want = ref.attention_reference(q, k, v, causal=causal)
    one = _share(attention_model(q, k, v, causal, "nearest", terms=1), want)
    three = _share(attention_model(q, k, v, causal, "nearest"), want)
    assert one > 1.0, f"one TF32 product uses only {one:.3f} of the limit"
    assert three < one / 20
