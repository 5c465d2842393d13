"""The arithmetic of the bf16 SSD scan kernel (``mma``), on the CPU.

The kernel (``csrc/ssd_scan_mma_sm90.cu``, with tf32x3's float32 pass 2)
takes bf16 x, B and C at every shape the ``sm90`` kernel does not. Its
products are ``mma.sync`` m16n8k16 with bf16 operands and float32
accumulation: a product of two bf16 inputs is exact before the sum, and a
float32 operand goes in as two bf16 parts, hi = bf16(v) and lo = bf16(v -
hi), two products. That is x w in pass 1 (w_j = dt_j exp(cum_last - cum_j)),
and in pass 3 P = S o exp(cum_i - cum_j) o dt_j and the float32 starting
states. The kernel runs only on a card; here a torch model of its three
passes (bf16 x, B, C; x w, P and the starting states split hi + lo; the
products exact, summed in float64) is held against the JAX ``ssd_chunked``,
the Pallas kernel in interpret mode and the port's plain ``ssd_reference``
on the same bf16 inputs: at every bf16 case of ``chip_smoke.py``'s
``SSD_CASES`` that ``ops.variant`` sends to ``mma``, the serve demo's
reduced mamba2, jamba-v0.1-52b's layout cut to 8 heads at s 512, a ragged
chunk of 17, n 8 and n 32, and an init-state continuation. The limits are
the reference tests' own (``tests/test_kernels.py``, bf16): y within 3e-2 of
max |y|, the final state at rtol = atol = 1e-2.

The same model with one bf16 P (no lo part) lies further from a float64
scan; that is the split's reason, which matters through mamba2's 24 layers
(one bf16 P on the ``sm90`` kernel read 0.43 of the 0.456 prefill logits
limit) more than in one scan. ``-s`` prints each share of the limits, and
the float64 distances of both models.

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_ssd_bf16.py
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
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (b, s, nh, p, g, n, chunk): the bf16 rows of chip_smoke.py's SSD_CASES that
# ops.variant sends to mma (its views are TMA-aligned, so the shape decides),
# then the serve demo's reduced mamba2 (4 x 32 tokens, p 16, n 16, chunks of
# 32), jamba-v0.1-52b's layout (p 64, n 16, chunks of 256) cut to 8 heads and
# 512 tokens, jamba's decode forward's ragged chunk of 17 cut to 8 heads, n 8
# with g 2, and n 32 at p 64.
SMOKE_MMA_CASES = [
    (2, 128, 4, 32, 1, 16, 32),
]
CASES = SMOKE_MMA_CASES + [
    (4, 32, 8, 16, 1, 16, 32),
    (1, 512, 8, 64, 1, 16, 256),
    (2, 17, 8, 64, 1, 16, 17),
    (1, 256, 4, 16, 2, 8, 32),
    (1, 64, 4, 64, 1, 32, 64),
]
CASE_IDS = [f"b{c[0]}s{c[1]}nh{c[2]}p{c[3]}g{c[4]}n{c[5]}c{c[6]}" for c in CASES]
Y_LIMIT = 3e-2               # of max |y| (tests/test_kernels.py, bf16)
STATE_LIMIT = 1e-2           # rtol = atol


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).float()


def parts(x: torch.Tensor, split: bool = True):
    """A float32 operand as the kernel hands it to the tensor cores: hi =
    bf16(x) and lo = bf16(x - hi), or hi alone."""
    hi = bf16(x)
    return (hi, bf16(x - hi)) if split else (hi,)


def product(eq: str, a, b) -> torch.Tensor:
    """einsum(eq) over the parts of a and b: exact bf16 products summed in
    float64."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return sum(torch.einsum(eq, u.double(), v.double()) for u in a for v in b)


def ssd_model(x, dt, A, B, C, chunk, init=None, split=True, out_f64=False):
    """The kernel's three passes. x, B, C hold bf16 values (float32 tensors);
    dt, A float32. What the kernel holds in float32 is rounded to float32
    here: cum, w, x w (pass 1), the chunk and starting states (pass 2), S and
    P (pass 3); y's sum stays float64 until it is rounded to bf16 (or not,
    with ``out_f64``). ``split``: x w, P and the starting states as hi + lo
    (the kernel), else P alone as one bf16 (x w and the states still split).
    x (b, s, h, p), dt (b, s, h), A (h,), B, C (b, s, g, n)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep, l = h // g, s // chunk
    dtc = dt.reshape(b, l, chunk, h)
    cum = torch.cumsum(dtc * A, dim=2)                                       # (b,l,c,h)
    # pass 1: states = (x w)^T B, w_j = dt_j exp(cum_last - cum_j), x w split
    w = dtc * torch.exp(cum[:, :, -1:] - cum)
    xw = x.reshape(b, l, chunk, h, p) * w[..., None]
    Bh = B.reshape(b, l, chunk, g, n).repeat_interleave(rep, dim=3)         # (b,l,c,h,n)
    states = product("blchp,blchn->blhpn", parts(xw), Bh).float()
    # pass 2: the float32 recurrence
    decay = torch.exp(cum[:, :, -1])                                         # (b,l,h)
    h_cur = torch.zeros((b, h, p, n)) if init is None else init.float()
    h_ins = []
    for k in range(l):
        h_ins.append(h_cur)
        h_cur = h_cur * decay[:, k, :, None, None] + states[:, k]
    h_in = torch.stack(h_ins, dim=1)                                         # (b,l,h,p,n)
    # pass 3: S once per group (exact), P masked to j <= i before the
    # exponential, P and the starting states split
    Cg = C.reshape(b, l, chunk, g, n)
    S = product("blign,bljgn->blgij", Cg, B.reshape(b, l, chunk, g, n)).float()
    S = S.repeat_interleave(rep, dim=2)                                      # (b,l,h,i,j)
    cl = cum.permute(0, 1, 3, 2)                                             # (b,l,h,c)
    mask = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    decay_ij = torch.exp(torch.where(mask, cl[..., :, None] - cl[..., None, :], -torch.inf))
    P = S * dtc.permute(0, 1, 3, 2)[..., None, :] * decay_ij
    y = product("blhij,bljhp->blihp", parts(P, split), x.reshape(b, l, chunk, h, p))
    Ch = Cg.repeat_interleave(rep, dim=3)                                    # (b,l,c,h,n)
    inter = product("blhpn,blihn->blihp", parts(h_in), Ch)
    y = (inter * torch.exp(cum).double()[..., None] + y).reshape(b, s, h, p)
    return (y if out_f64 else y.float().to(torch.bfloat16)), h_cur


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
    return torch.cat(ys, dim=1), state


def _inputs(case, seed):
    """x, dt, A, B, C as float32 numpy arrays, with the reference test's
    scales; x, B and C rounded to bf16 values (the kernel's inputs)."""
    b, s, nh, p, g, n = case[:6]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, p)) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, s, nh)), 0.0)          # softplus
    A = -np.exp(rng.standard_normal(nh) * 0.3)
    B = rng.standard_normal((b, s, g, n)) * 0.3
    C = rng.standard_normal((b, s, g, n)) * 0.3
    x, dt, A, B, C = (torch.from_numpy(a.astype(np.float32)) for a in (x, dt, A, B, C))
    return [a.numpy() for a in (bf16(x), dt, A, bf16(B), bf16(C))]


def _shares(got, want):
    """(y's error as a share of 3e-2 max |y|, the final state's as a share of
    1e-2 + 1e-2 |h|), the largest over all elements."""
    (y, h), (wy, wh) = got, want
    wy = torch.as_tensor(np.asarray(wy, dtype=np.float64))
    wh = torch.as_tensor(np.asarray(wh, dtype=np.float64))
    y_share = float((y.double() - wy).abs().max() / (Y_LIMIT * wy.abs().max()))
    h_share = float(((h.double() - wh).abs() / (STATE_LIMIT + STATE_LIMIT * wh.abs())).max())
    return y_share, h_share


def _references(arrs, chunk, init=None):
    """The JAX ssd_chunked's, the Pallas kernel's (interpret mode) and the
    port's plain version's (y, final state) on the same bf16 inputs."""
    j = [jnp.asarray(a) for a in arrs]
    j[0], j[3], j[4] = (a.astype(jnp.bfloat16) for a in (j[0], j[3], j[4]))
    ji = None if init is None else jnp.asarray(init)
    with jax.default_device(jax.devices("cpu")[0]):
        chunked = jax_ssd_chunked(*j, chunk=chunk, init_state=ji)
        pallas = jax_ssd_scan(*j, chunk=chunk, init_state=ji, interpret=True)
        jax.block_until_ready(pallas)
    t = [torch.from_numpy(a) for a in arrs]
    t[0], t[3], t[4] = (a.to(torch.bfloat16) for a in (t[0], t[3], t[4]))
    plain = ref.ssd_reference(*t, chunk=chunk,
                              init_state=None if init is None else torch.from_numpy(init))
    as_np = lambda v: np.asarray(v, dtype=np.float32)  # noqa: E731
    return {"jax ssd_chunked": [as_np(v) for v in chunked],
            "pallas interpret": [as_np(v) for v in pallas],
            "plain": [v.float().numpy() for v in plain]}


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_cases_are_chip_smokes_mma_cases():
    smoke = _load_smoke()
    mma = [c[:7] for c in smoke.SSD_CASES if c[7] == torch.bfloat16
           and ops.variant(c[7], c[3], c[5], min(c[6], c[1])) == "mma"]
    assert mma == SMOKE_MMA_CASES
    assert smoke.SSD_Y_TOL[torch.bfloat16] == Y_LIMIT
    assert smoke.SSD_STATE_TOL[torch.bfloat16] == STATE_LIMIT
    assert smoke.DEMO_SSD[:7] == CASES[1]
    assert smoke.JAMBA_SSD[2:7] == (128,) + CASES[2][3:]


def test_split_keeps_sixteen_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = parts(x)
    assert torch.equal(hi, bf16(hi)) and torch.equal(lo, bf16(lo))
    rel = lambda r: float((r.double().abs() / x.double().abs()).max())  # noqa: E731
    assert rel(hi - x) <= 2.0 ** -8
    # what the two parts leave out: at most 2^-16 |x|
    assert rel(x.double() - hi.double() - lo.double()) <= 2.0 ** -16


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_mma_model_keeps_bf16_limits(case):
    arrs = _inputs(case, seed=case[1] + case[2] * case[3])
    chunk = min(case[6], case[1])
    t = [torch.from_numpy(a) for a in arrs]
    got = ssd_model(*t, chunk)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for name, want in _references(arrs, chunk).items():
        shares = _shares(got, want)
        print(f"{case} vs {name}: {shares[0]:.4f} (y), {shares[1]:.4f} (state) of the limits")
        assert max(shares) < 1.0, f"against {name}: {shares}"
    # the split's reason: one bf16 P lies further from the float64 scan
    truth = float64_scan(*arrs, chunk)
    two = _shares(ssd_model(*t, chunk, out_f64=True), truth)
    one = _shares(ssd_model(*t, chunk, split=False, out_f64=True), truth)
    print(f"{case} vs float64 before y's bf16 rounding: hi + lo P {two[0]:.5f} (y), "
          f"{two[1]:.5f} (state); one bf16 P {one[0]:.5f} (y) of the limits")
    assert two[0] < one[0], f"one bf16 P {one} is no further from float64 than hi + lo {two}"


def test_mma_model_continues_from_an_init_state():
    """scan(x[:half]) then scan(x[half:], init_state) through the model ==
    the references over the same halves, chained the same way."""
    case = (2, 128, 8, 32, 2, 16, 32)
    arrs = _inputs(case, seed=19)
    half = case[1] // 2
    first = [a[:, :half] if a.ndim > 1 else a for a in arrs]
    second = [a[:, half:].copy() if a.ndim > 1 else a for a in arrs]
    t1 = [torch.from_numpy(np.ascontiguousarray(a)) for a in first]
    t2 = [torch.from_numpy(a) for a in second]
    init = np.array(_references(first, 32)["pallas interpret"][1])
    got = ssd_model(*t2, 32, init=ssd_model(*t1, 32)[1])
    for name, want in _references(second, 32, init=init).items():
        shares = _shares(got, want)
        print(f"continuation vs {name}: {shares[0]:.4f} (y), {shares[1]:.4f} (state)")
        assert max(shares) < 1.0, f"against {name}: {shares}"


# ssd_bound at chip_smoke.py's mma timing cases: (flops, bytes), each input
# read once and each output written once; all four are bound by bytes at
# 3.35 TB/s. And the mma passes' bytes there: pass 2 writes, and pass 3 reads,
# float32 starting states.
MMA_TIMING_BOUNDS = {
    "JAMBA_SSD": (21575630848, 277348864),
    "SSD_CASES[3]": (3313664, 167952),
    "DEMO_SSD": (1656832, 110624),
    "MAIN_SSD": (39782973440, 227541088),
}
MMA_PASS_BYTES = {   # (chunk_state, state_pass, chunk_scan) at jamba's shape
    "JAMBA_SSD": (159646208, 37765120, 294125568),
}


@pytest.mark.parametrize("name", sorted(MMA_TIMING_BOUNDS))
def test_ssd_bound_is_pinned_at_the_mma_timing_cases(name):
    smoke = _load_smoke()
    case = eval(name, {}, vars(smoke))
    flops, nbytes = MMA_TIMING_BOUNDS[name]
    t, by, got_flops, got_bytes = smoke.ssd_bound(case)
    assert (got_flops, got_bytes, by) == (flops, nbytes, "bytes")
    assert t == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    if name in MMA_PASS_BYTES:
        for pass_name, want in zip(smoke.SSD_PASSES, MMA_PASS_BYTES[name]):
            got, by = smoke.ssd_pass_bound(pass_name, case, "mma")
            assert (got, by) == (pytest.approx(want / 3.35e12, rel=1e-12), "bytes"), pass_name
        # sm90 hands pass 3 bf16 starting states: 2 bytes a value less each way
        states = 8 * 4 * 128 * 64 * 16
        assert smoke.ssd_pass_bound("state_pass", case, "sm90")[0] == pytest.approx(
            (MMA_PASS_BYTES[name][1] - 2 * states) / 3.35e12, rel=1e-12)
