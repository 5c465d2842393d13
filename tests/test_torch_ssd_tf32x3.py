"""The arithmetic of the float32 SSD scan kernel (``tf32x3``), on the CPU.

The kernel (``csrc/ssd_scan_f32_sm90.cu``) runs every product of the chunked
scan on the tensor cores, which take float32 only as TF32 (a 10-bit
mantissa). It splits every operand x = hi + lo (hi: x with its low 13 bits
cleared; lo = x - hi, read truncated too) and sums three TF32 products,
lo*hi + hi*lo + hi*hi. The kernel itself runs only on a card; here a torch
model of its three passes, every product as three TF32 products of the
kernel's own split accumulated in float64, is held against the JAX
``ssd_chunked``, the Pallas kernel in interpret mode and the port's plain
``ssd_reference``, at every float32 case of ``chip_smoke.py``'s ``SSD_CASES``,
mamba2's float32 layout cut to 1 x 512, jamba's float32 decode shape cut to
8 heads, and an init-state continuation. The limits are the reference tests'
own (``tests/test_kernels.py``): y within 1e-4 of max |y|, the final state
at rtol = atol = 1e-4.

What the TF32 products cost is the model against the same model with exact
products of the same float32 operands: three products use under 5% of the
limits there, one product misses them (``-s`` prints both shares). Against
each reference the model keeps the limits, and its products add under 5% of
them to the exact-product model's own distance. At chunks of 256 (mamba2's
layout) every float32 evaluation, the references included, lies several
percent of the limits from a float64 one (``float64_scan``): float32's
rounding of cum and of the exponentials, which the kernel shares with them.

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_ssd_tf32x3.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (b, s, nh, p, g, n, chunk): the float32 rows of chip_smoke.py's SSD_CASES,
# then mamba2-130m's float32 layout (p 64, n 128, chunks of 256) cut to 1 x
# 512 tokens, and jamba-v0.1-52b's float32 decode check's forward (17 tokens,
# one ragged chunk, n 16) cut to 8 heads.
SMOKE_F32_CASES = [
    (2, 128, 8, 32, 1, 16, 64),
    (1, 256, 4, 16, 2, 8, 32),
    (1, 64, 2, 64, 1, 32, 64),
    (2, 16, 24, 64, 1, 128, 16),
    (2, 17, 24, 64, 1, 128, 17),
]
CASES = SMOKE_F32_CASES + [
    (1, 512, 24, 64, 1, 128, 256),
    (2, 17, 8, 64, 1, 16, 17),
]
CASE_IDS = [f"b{c[0]}s{c[1]}nh{c[2]}p{c[3]}g{c[4]}n{c[5]}c{c[6]}" for c in CASES]
Y_LIMIT = 1e-4               # of max |y| (tests/test_kernels.py, float32)
STATE_LIMIT = 1e-4           # rtol = atol
THREE_SHARE = 0.05           # the share of the limits three products may use


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x as the tensor core reads it: its low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits & 0xFFFFE000) - ((bits & 0x80000000) << 1)   # back to a signed int32
    return bits.to(torch.int32).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """einsum(eq, a, b) of float32 operands as TF32 products summed in
    float64: three (lo*hi + hi*lo + hi*hi of the kernel's split), one
    (hi*hi), or none (0: the exact products)."""
    if terms == 0:
        return torch.einsum(eq, a.double(), b.double())
    ah, bh = tf32(a), tf32(b)
    out = torch.einsum(eq, ah.double(), bh.double())
    if terms == 3:
        al, bl = tf32(a - ah), tf32(b - bh)
        out = out + torch.einsum(eq, al.double(), bh.double()) \
            + torch.einsum(eq, ah.double(), bl.double())
    return out


def ssd_model(x, dt, A, B, C, chunk, init=None, terms=3):
    """The kernel's three passes with its products as TF32 products. What
    it holds in float32 is rounded to float32 here: cum, the weights w and x
    w (pass 1), the chunk and starting states (pass 2), S = C B^T and P = S o
    dt_j o exp(cum_i - cum_j) (pass 3); y's sum stays float64.
    x (b, s, h, p), dt (b, s, h), A (h,), B, C (b, s, g, n), float32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep, l = h // g, s // chunk
    dtc = dt.reshape(b, l, chunk, h)
    cum = torch.cumsum(dtc * A, dim=2)                                       # (b,l,c,h)
    # pass 1: states = (x w)^T B, w_j = dt_j exp(cum_last - cum_j)
    w = dtc * torch.exp(cum[:, :, -1:] - cum)
    xw = x.reshape(b, l, chunk, h, p) * w[..., None]
    Bh = B.reshape(b, l, chunk, g, n).repeat_interleave(rep, dim=3)         # (b,l,c,h,n)
    states = product("blchp,blchn->blhpn", xw, Bh, terms).float()
    # pass 2: the float32 recurrence
    decay = torch.exp(cum[:, :, -1])                                         # (b,l,h)
    h_cur = torch.zeros((b, h, p, n)) if init is None else init.float()
    h_ins = []
    for k in range(l):
        h_ins.append(h_cur)
        h_cur = h_cur * decay[:, k, :, None, None] + states[:, k]
    h_in = torch.stack(h_ins, dim=1)                                         # (b,l,h,p,n)
    # pass 3: S once per group, P masked to j <= i before the exponential
    Cg = C.reshape(b, l, chunk, g, n)
    S = product("blign,bljgn->blgij", Cg, B.reshape(b, l, chunk, g, n), terms).float()
    S = S.repeat_interleave(rep, dim=2)                                      # (b,l,h,i,j)
    cl = cum.permute(0, 1, 3, 2)                                             # (b,l,h,c)
    mask = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    decay_ij = torch.exp(torch.where(mask, cl[..., :, None] - cl[..., None, :], -torch.inf))
    P = S * dtc.permute(0, 1, 3, 2)[..., None, :] * decay_ij
    y = product("blhij,bljhp->blihp", P, x.reshape(b, l, chunk, h, p), terms)
    Ch = Cg.repeat_interleave(rep, dim=3)                                    # (b,l,c,h,n)
    inter = product("blhpn,blihn->blihp", h_in, Ch, terms)
    y = y + inter * torch.exp(cum).double()[..., None]
    return y.reshape(b, s, h, p), h_cur


def float64_scan(x, dt, A, B, C, chunk):
    """The scan in float64 throughout, chunk by chunk (y, final state)."""
    x, dt, A, B, C = (torch.as_tensor(a).double() for a in (x, dt, A, B, C))
    rep = x.shape[2] // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, dim=2), C.repeat_interleave(rep, dim=2)
    state = torch.zeros(x.shape[0], x.shape[2], x.shape[3], B.shape[3], dtype=torch.float64)
    mask = torch.ones((chunk, chunk), dtype=torch.bool).tril()[None, :, :, None]
    ys = []
    for t0 in range(0, x.shape[1], chunk):
        c = slice(t0, t0 + chunk)
        cum = torch.cumsum(dt[:, c] * A, dim=1)                                # (b,c,h)
        decay = torch.where(mask, torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
        xdt = x[:, c] * dt[:, c, :, None]
        y = torch.einsum("bihn,bjhn,bijh,bjhp->bihp", Ch[:, c], Bh[:, c], decay, xdt)
        ys.append(y + torch.einsum("bihn,bhpn->bihp", Ch[:, c], state)
                  * torch.exp(cum)[..., None])
        w = torch.exp(cum[:, -1:] - cum)
        state = state * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("bjhp,bjh,bjhn->bhpn", xdt, w, Bh[:, c])
    return torch.cat(ys, dim=1).numpy(), state.numpy()


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


def _shares(got, want):
    """(y's error as a share of 1e-4 max |y|, the final state's as a share
    of 1e-4 + 1e-4 |h|), the largest over all elements."""
    (y, h), (wy, wh) = got, want
    wy = torch.as_tensor(np.asarray(wy, dtype=np.float64))
    wh = torch.as_tensor(np.asarray(wh, dtype=np.float64))
    y_share = float((y.double() - wy).abs().max() / (Y_LIMIT * wy.abs().max()))
    h_share = float(((h.double() - wh).abs() / (STATE_LIMIT + STATE_LIMIT * wh.abs())).max())
    return y_share, h_share


def _references(arrs, chunk, init=None):
    """The JAX ssd_chunked's, the Pallas kernel's (interpret mode) and the
    port's plain version's (y, final state) on the same inputs."""
    j = [jnp.asarray(a) for a in arrs]
    ji = None if init is None else jnp.asarray(init)
    with jax.default_device(jax.devices("cpu")[0]):
        chunked = jax_ssd_chunked(*j, chunk=chunk, init_state=ji)
        pallas = jax_ssd_scan(*j, chunk=chunk, init_state=ji, interpret=True)
        jax.block_until_ready(pallas)
    t = [torch.from_numpy(a) for a in arrs]
    plain = ref.ssd_reference(*t, chunk=chunk,
                              init_state=None if init is None else torch.from_numpy(init))
    return {"jax ssd_chunked": [np.asarray(v) for v in chunked],
            "pallas interpret": [np.asarray(v) for v in pallas],
            "plain": [v.numpy() for v in plain]}


def test_cases_are_chip_smokes_float32_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert [c[:7] for c in smoke.SSD_CASES if c[7] == torch.float32] == SMOKE_F32_CASES
    assert smoke.SSD_Y_TOL[torch.float32] == Y_LIMIT
    assert smoke.SSD_STATE_TOL[torch.float32] == STATE_LIMIT
    assert smoke.MAIN_SSD_F32[2:7] == CASES[5][2:]
    assert smoke.JAMBA_DECODE_SSD_F32[:2] + smoke.JAMBA_DECODE_SSD_F32[3:7] == \
        CASES[6][:2] + CASES[6][3:]


def test_tf32_truncation_keeps_ten_mantissa_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert float(((hi.double() - x.double()).abs() / x.double().abs()).max()) < 2.0 ** -10
    # what the three products leave out: below 2^-21 |x|
    rest = (x.double() - hi.double() - lo.double()).abs() / x.double().abs()
    assert float(rest.max()) < 2.0 ** -21


def _hold(case, three, exact, refs):
    """Three products' own share (against exact products) under 5% of the
    limits; against each reference within the limits, adding under 5% of
    them to the exact-product model's distance."""
    own = _shares(three, exact)
    assert max(own) < THREE_SHARE, (
        f"three TF32 products use {own[0]:.4f} (y), {own[1]:.4f} (state) of the limits")
    for name, want in refs.items():
        got, base = _shares(three, want), _shares(exact, want)
        print(f"{case} vs {name}: {got[0]:.4f} (y), {got[1]:.4f} (state) of the limits; "
              f"exact products {base[0]:.4f}, {base[1]:.4f}")
        assert max(got) < 1.0, f"against {name}: {got}"
        assert got[0] < base[0] + THREE_SHARE and got[1] < base[1] + THREE_SHARE, (
            f"the products add more than {THREE_SHARE} of the limits against {name}: "
            f"{got} against {base}")
    return own


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_three_tf32_products_keep_float32s_limits(case):
    arrs = _inputs(case, seed=case[1] + case[2] * case[3])
    chunk = min(case[6], case[1])
    t = [torch.from_numpy(a) for a in arrs]
    exact = ssd_model(*t, chunk, terms=0)
    own = _hold(case, ssd_model(*t, chunk), exact, _references(arrs, chunk))
    one = _shares(ssd_model(*t, chunk, terms=1), exact)
    print(f"{case}: three TF32 products {own[0]:.4f} (y), {own[1]:.4f} (state) of the "
          f"limits; one {one[0]:.4f}, {one[1]:.4f}")
    assert max(one) > 1.0, f"one TF32 product uses only {one} of the limits"


def test_three_tf32_products_continue_from_an_init_state():
    """scan(x[:half]) then scan(x[half:], init_state) through the model ==
    the references over the same halves, chained the same way."""
    case = (2, 128, 8, 32, 2, 16, 32)
    arrs = _inputs(case, seed=17)
    half = case[1] // 2
    first = [a[:, :half] if a.ndim > 1 else a for a in arrs]
    second = [a[:, half:].copy() if a.ndim > 1 else a for a in arrs]
    t1 = [torch.from_numpy(a) for a in first]
    t2 = [torch.from_numpy(a) for a in second]
    init = _references(first, 32)["pallas interpret"][1]
    three = ssd_model(*t2, 32, init=ssd_model(*t1, 32)[1])
    exact = ssd_model(*t2, 32, init=ssd_model(*t1, 32, terms=0)[1], terms=0)
    _hold(case, three, exact, _references(second, 32, init=np.array(init)))


@pytest.mark.parametrize("case", [CASES[0], CASES[5]], ids=[CASE_IDS[0], CASE_IDS[5]])
def test_float32_evaluations_lie_alike_from_float64(case):
    """Against the scan in float64, the float32 evaluations (the references
    and the model with exact or three TF32 products) keep the limits, and
    the three-product model lies no further from it than the references
    do, give or take 5% of the limits."""
    arrs = _inputs(case, seed=case[1] + case[2] * case[3])
    chunk = min(case[6], case[1])
    truth = float64_scan(*arrs, chunk)
    t = [torch.from_numpy(a) for a in arrs]
    shares = {"three TF32 products": _shares(ssd_model(*t, chunk), truth),
              "exact products": _shares(ssd_model(*t, chunk, terms=0), truth)}
    for name, want in _references(arrs, chunk).items():
        shares[name] = _shares([torch.from_numpy(np.asarray(v)) for v in want], truth)
    for name, (y_share, h_share) in shares.items():
        print(f"{case} {name} vs float64: {y_share:.4f} (y), {h_share:.4f} (state) of the limits")
        assert max(y_share, h_share) < 1.0, name
    three = shares.pop("three TF32 products")
    assert max(three) < max(max(v) for v in shares.values()) + THREE_SHARE
