"""The arithmetic of the bf16 flash-attention kernel (``sm90``) at small head
dims, on the CPU.

The kernel (``csrc/flash_attention_sm90.cu``) runs in 128-column kv tiles:
float32 scores from bf16 q and k, a running max and sum in float32, the
unnormalised weights exp2((s - m) * log2(e) / sqrt(D)) rounded to bf16 for
the P.V product (float32 sums), the accumulator rescaled tile by tile, and
the division by the clamped sum at the end, then bf16. The plain versions
round the normalised weights instead. The kernel runs only on a card; here a
torch model of that arithmetic is held against the port's plain version
(``ref.attention_reference``) and the JAX reference's plain version
(``repro.kernels.flash_attention.ref``) at the bf16 D 16 and 32 shapes of
``chip_smoke.py``'s ``FA_CASES`` and at 1 x 1024, causal, GQA 32 / 8, within
the card's bf16 limit (2.5e-2 abs + 2.5e-2 rel):

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_fa_bf16.py

(``-s`` prints each case's share of the limit.)
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (b, s, t, h, kh, d, causal): the bf16 rows of chip_smoke.py's FA_CASES at
# D 16 and 32, then 1 x 1024 causal GQA 32 / 8 at D 16 and 32
SMOKE_CASES = [
    (1, 64, 64, 4, 4, 32, False),
    (2, 128, 128, 4, 2, 16, True),
    (1, 200, 200, 4, 4, 16, False),
]
CASES = SMOKE_CASES + [(1, 1024, 1024, 32, 8, 16, True), (1, 1024, 1024, 32, 8, 32, True)]
CASE_IDS = [f"b{c[0]}s{c[1]}t{c[2]}h{c[3]}kh{c[4]}d{c[5]}c{int(c[6])}" for c in CASES]
LIMIT = 2.5e-2               # chip_smoke.py's bf16 TOL, abs and rel
BN = 128                     # kv rows a tile
LOG2E = 1.4426950408889634


def kernel_model(q, k, v, causal: bool) -> torch.Tensor:
    """The kernel's function in its own arithmetic. q: (B, S, H, D); k, v:
    (B, T, KH, D), all bf16; returns bf16 (B, S, H, D)."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    rep = h // kh
    qh = q.float().permute(0, 2, 1, 3)                                   # (B, H, S, D)
    kh_ = k.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)    # (B, H, T, D)
    vh = v.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)             # bf16
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), ref.NEG_INF)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    for k0 in range(0, t, BN):
        sc = torch.full((b, h, s, BN), -math.inf)
        kt = kh_[:, :, k0:k0 + BN]
        sc[..., :kt.shape[2]] = qh @ kt.transpose(-1, -2)                 # past T: -inf
        if causal:
            sc = torch.where(k0 + torch.arange(BN)[None, :] > rows,
                             torch.tensor(ref.NEG_INF), sc)
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2((m - mx) * scale_log2)
        p = torch.exp2(sc * scale_log2 - mx * scale_log2)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = torch.zeros(b, h, BN, d, dtype=torch.bfloat16)
        vt[:, :, :kt.shape[2]] = vh[:, :, k0:k0 + BN]
        acc = acc * corr + p.to(torch.bfloat16).float() @ vt.float()
        m = mx
    o = acc / l.clamp_min(1e-20)
    return o.permute(0, 2, 1, 3).to(torch.bfloat16)


def _inputs(case, seed):
    b, s, t, h, kh, d, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d))]


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error as a share of the limit |want| * 2.5e-2 + 2.5e-2."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (LIMIT + LIMIT * want.abs())).max())


def test_cases_are_chip_smokes_small_d_bf16_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert [c[:7] for c in smoke.FA_CASES
            if c[7] == torch.bfloat16 and c[5] < 64] == SMOKE_CASES
    assert smoke.TOL[torch.bfloat16] == LIMIT


@pytest.mark.parametrize("oracle", ["port", "jax"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_arithmetic_keeps_the_bf16_limit(case, oracle):
    arrs = _inputs(case, seed=case[1] + case[5])
    q, k, v = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    causal = case[6]
    got = kernel_model(q, k, v, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    if oracle == "port":
        want = ref.attention_reference(q, k, v, causal=causal).float()
    else:
        jax = pytest.importorskip("jax")
        import jax.numpy as jnp
        from repro.kernels.flash_attention.ref import attention_reference as jax_reference

        with jax.default_device(jax.devices("cpu")[0]):
            jq, jk, jv = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
            want = torch.from_numpy(np.array(
                jax_reference(jq, jk, jv, causal=causal).astype(jnp.float32)))
    share = _share(got.float(), want)
    print(f"{case} vs {oracle}: {share:.3f} of the bf16 limit")
    assert share <= 1.0, f"the kernel's arithmetic uses {share:.3f} of the bf16 limit"
