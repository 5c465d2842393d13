"""The least time ``chip_smoke.py`` holds a flash-attention kernel against
(``fa_bound``), on the CPU.

The bound is the largest of three terms: the products on the tensor cores,
one exponential per kept (q, k) pair on the special-function units
(``H100_SFU_OPS``: 16 a clock per SM, 132 SMs, 1.98 GHz), and the bytes of
q, k, v and o. At head dims 16 and 32 the exponentials bound attention;
at 64 and 128 the products do. These cases pin the values quoted in
PERF.md:

    PYTHONPATH=src python -m pytest -q tests/test_torch_fa_bound.py
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32

# (case, bound in ms, bound_by): the small-D rate cases at the main path's 8 x
# 1024, causal, GQA 32 / 8; MAIN_FA and MAIN_FA_F32; whisper-tiny's encoder
# (not causal, S = T = 1,500, 6 heads at D 64), where the products still lead
CASES = [
    ((8, 1024, 1024, 32, 8, 16, True, BF16), 0.0321, "exponentials"),
    ((8, 1024, 1024, 32, 8, 32, True, BF16), 0.0321, "exponentials"),
    ((8, 1024, 1024, 32, 8, 128, True, BF16), 0.0696, "operations"),
    ((8, 1024, 1024, 32, 8, 128, True, F32), 0.4169, "operations"),
    ((8, 1500, 1500, 6, 6, 64, False, BF16), 0.0280, "operations"),
]
IDS = ["d16", "d32", "main_fa", "main_fa_f32", "whisper_encoder"]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sfu_rate_is_16_a_clock_on_132_sms_at_1980_mhz():
    assert mesh.H100_SFU_OPS == pytest.approx(4.18176e12)


@pytest.mark.parametrize("case,ms,by", CASES, ids=IDS)
def test_fa_bound(smoke, case, ms, by):
    bound_s, bound_by, flops, nbytes = smoke.fa_bound(case)
    assert bound_by == by
    assert bound_s * 1e3 == pytest.approx(ms, abs=5e-5)
    b, s, t, h, kh, d, causal, dt = case
    pairs = s * (s + 1) // 2 if causal else s * t
    # every term stays below the bound, which is one of them
    assert b * h * pairs / mesh.H100_SFU_OPS <= bound_s
    assert nbytes / mesh.H100_HBM_BYTES_S <= bound_s
    assert flops == 4 * b * h * d * pairs


def test_main_shapes_are_the_chip_smoke_ones(smoke):
    assert [c for c, _, _ in CASES[2:4]] == [smoke.MAIN_FA, smoke.MAIN_FA_F32]
    assert [c for c, _, _ in CASES[:2]] == smoke.FA_RATE_CASES_SMALL_D[:2]
    assert CASES[4][0] in smoke.FA_CASES
