"""Public wrapper for the SSD chunked-scan kernels.

Counterpart of ``repro.kernels.ssd_scan.ops``: the same signature and the
contract of ``ssd_chunked`` (x (b, s, nh, p), dt (b, s, nh), A (nh,), B and C
(b, s, g, n), optional init state (b, nh, p, n); returns y in x's dtype and
the final state in float32; the chunk is ``min(chunk, s)`` and must divide
s). A tensor on the CPU goes to the plain version (:func:`ref.ssd_reference`),
and so does a meta tensor (shapes only, for the dry run); a tensor on a CUDA
device goes to a hand-written kernel, or the call raises.
Which kernel is fixed by shape, dtype and alignment before the launch
(:func:`variant`), never by a failure:

* ``"sm90"``: bf16 at p 64, n 16, 64 or 128, chunks of 64, 128 or 256, x,
  B and C 16-byte aligned with 16-byte strides (TMA reads them in place), on
  the tensor cores in three passes, ``csrc/ssd_scan_sm90.cu``: chunk states
  (:func:`chunk_state`), the in-order state recurrence (:func:`state_pass`),
  the outputs with C.B^T shared by a block's heads (:func:`chunk_scan`); the
  serving paths (mamba2-130m at n 128, jamba-v0.1-52b at n 16, whose B, C
  and states the kernel lays out in 32-byte rows);
* ``"tf32x3"``: float32 at every shape the card takes (p 16 / 32 / 64, n <=
  128, chunks <= 256, any views with unit stride last), on the tensor cores
  in the same three passes, ``csrc/ssd_scan_f32_sm90.cu``: each product is
  three TF32 products of a hi / lo split, which keeps float32's accuracy;
  the starting states are float32 and ``ssd_scan`` writes them over the chunk
  states in place;
* ``"mma"``: bf16 at the shapes ``sm90`` does not take (p 16 / 32, n
  outside ``SM90_N``, chunks outside ``SM90_CHUNKS`` or ragged, views TMA
  cannot read), on the tensor cores through ``mma.sync`` in the same three
  passes, ``csrc/ssd_scan_mma_sm90.cu`` (passes 1 and 3) and tf32x3's
  float32 pass 2: bf16 products, a float32 operand (x w, P, the starting
  states) as two bf16 parts; the starting states stay float32, written over
  the chunk states in place as for tf32x3.

All three read x, B and C through their (b, s, head or group) strides, so
the model's views into the conv output reach them with no copy: ``mma``
copies 16 or 4 bytes at a time, or one bf16 where a view starts an odd
number of elements in (:func:`_elems`).

``LAUNCHES`` counts one per :func:`ssd_scan` call on the card, whatever the
number of passes, so that a run can show that its main path went through the
kernel; ``LAUNCHES_BY_VARIANT`` splits the same count by variant. A pass
called alone counts nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import chunk_scan_reference, chunk_state_reference, ssd_reference, state_pass_reference

# the plain version's devices: the CPU, and meta tensors (shapes only)
_PLAIN_DEVICES = ("cpu", "meta")
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"sm90": 0, "tf32x3": 0, "mma": 0}

SUPPORTED_P = (16, 32, 64)     # head dims the tf32x3 and mma kernels are instantiated for
MAX_N = 128                    # d_state
MAX_CHUNK = 256
SM90_P = (64,)
SM90_N = (16, 64, 128)
SM90_CHUNKS = (64, 128, 256)
# Heads per block of the sm90 passes: a divisor of the heads per group, at
# most this many. Pass 3 forms C.B^T once per block for all of them. Fewer,
# longer blocks run faster at jamba's 128 heads to a group than 4 and 8, and
# level at mamba2's 24 (chip_smoke.py times both shapes at both settings).
STATE_HEADS, SCAN_HEADS = 16, 32
# Heads per block of the tf32x3 and mma passes 3, which form C.B^T once for
# them: the largest divisor of the heads per group up to this many whose
# grid still has a block for every SM (``_f32_scan_heads``; chip_smoke.py
# times 12 beside 4 and 24 at mamba2's float32 shape).
F32_SCAN_HEADS = 12
_DTYPES = (torch.float32, torch.bfloat16)
_C = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p


def _lib():
    lib = _build.load("ssd_scan")
    if lib.ssd_chunk_state_sm90.argtypes is None:
        for fn in (lib.ssd_chunk_state_sm90, lib.ssd_state_pass_sm90, lib.ssd_chunk_scan_sm90,
                   lib.ssd_chunk_state_f32, lib.ssd_state_pass_f32, lib.ssd_chunk_scan_f32,
                   lib.ssd_chunk_state_mma, lib.ssd_chunk_scan_mma):
            fn.restype = ctypes.c_int
        lib.ssd_chunk_state_sm90.argtypes = [_P, _P, _P, _P, _P, _P,      # x dt A B states cum
                                             _C, _C, _C, _C, _C, _C, _C,  # b s nh g n chunk heads
                                             _L, _L, _L, _L, _L, _L,      # x, dt strides
                                             _L, _L, _L, _P]              # B strides, stream
        lib.ssd_state_pass_sm90.argtypes = [_P, _P, _P, _P, _P,           # states cum init h_in final
                                            _C, _C, _C, _C, _C, _P]       # b s nh p*n chunk stream
        lib.ssd_chunk_scan_sm90.argtypes = [_P, _P, _P, _P, _P, _P, _P,   # x B C cum dtT h_in y
                                            _C, _C, _C, _C, _C, _C, _C,   # b s nh g n chunk heads
                                            _L, _L, _L, _L, _L, _L,       # x, B strides
                                            _L, _L, _L, _L, _L, _L,       # C, y strides
                                            _P]                           # stream
        lib.ssd_chunk_state_f32.argtypes = [_P, _P, _P, _P, _P, _P,       # x dt A B states cum
                                            _C, _C, _C, _C, _C, _C, _C,   # b s nh p g n chunk
                                            _C, _C,                       # 16-byte copies of x, B
                                            _L, _L, _L, _L, _L, _L,       # x, dt strides
                                            _L, _L, _L, _P]               # B strides, stream
        lib.ssd_state_pass_f32.argtypes = lib.ssd_state_pass_sm90.argtypes
        lib.ssd_chunk_scan_f32.argtypes = [_P, _P, _P, _P, _P, _P, _P,    # x B C cum dt h_in y
                                           _C, _C, _C, _C, _C, _C, _C,    # b s nh p g n chunk
                                           _C, _C, _C, _C,                # heads; 16-byte copies
                                           _L, _L, _L, _L, _L, _L,        # x, dt strides
                                           _L, _L, _L, _L, _L, _L,        # B, C strides
                                           _L, _L, _L, _P]                # y strides, stream
        # the mma passes take the tf32x3 ones' arguments, copy widths in elements
        lib.ssd_chunk_state_mma.argtypes = lib.ssd_chunk_state_f32.argtypes
        lib.ssd_chunk_scan_mma.argtypes = lib.ssd_chunk_scan_f32.argtypes
    return lib


def _check(x, dt, A, B, C, init_state) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or B.ndim != 4:
        raise ValueError("want x (b, s, nh, p), dt (b, s, nh), A (nh,), B, C (b, s, g, n)")
    b, s, nh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, nh) or A.shape != (nh,) or B.shape[:2] != (b, s)
            or C.shape != B.shape or nh % g):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    if init_state is not None and init_state.shape != (b, nh, p, n):
        raise ValueError(f"init_state {tuple(init_state.shape)}, want {(b, nh, p, n)}")
    if s < 1:
        raise ValueError("empty sequence")
    tensors = [x, dt, A, B, C] + ([init_state] if init_state is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")


def tma_aligned(*tensors: torch.Tensor) -> bool:
    """True if TMA can read every tensor in place: a 16-byte aligned start,
    unit stride in the last dim and 16-byte multiples for the other strides."""
    for t in tensors:
        elt = t.element_size()
        if t.data_ptr() % 16 or t.stride(-1) != 1:
            return False
        if any((st * elt) % 16 for st in t.stride()[:-1]):
            return False
    return True


def variant(dtype: torch.dtype, p: int, n: int, chunk: int, aligned: bool = True) -> str:
    """The kernel that takes (dtype, head dim, d_state, chunk) on the card;
    ``aligned`` is :func:`tma_aligned` of x, B and C. ``tf32x3`` for float32
    at every shape; ``sm90`` for bf16 at p in ``SM90_P``, n in ``SM90_N``
    (16: jamba's SSM layers; 64, 128: mamba2's) and chunk in
    ``SM90_CHUNKS`` when aligned; ``mma`` for the rest of bf16."""
    if dtype == torch.float32:
        return "tf32x3"
    if p in SM90_P and n in SM90_N and chunk in SM90_CHUNKS and aligned:
        return "sm90"
    return "mma"


def _heads(rep: int, most: int) -> int:
    return max(d for d in range(1, min(rep, most) + 1) if rep % d == 0)


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"ssd_scan {what} launch failed: CUDA error {rc}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _pass_kind(x, B, C, chunk) -> str:
    """The variant whose passes take x, B, C on the card: ``sm90`` (bf16 at
    its shapes), ``mma`` (the rest of bf16) or ``tf32x3`` (float32); raises
    for a shape none of them takes."""
    b, s, nh, p = x.shape
    n = B.shape[3]
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B, C in one dtype, not {x.dtype}, {B.dtype}, {C.dtype}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the pass kernels take bf16 or float32, not {x.dtype}")
    kind = variant(x.dtype, p, n, chunk, tma_aligned(x, B, C))
    if kind != "sm90" and (p not in SUPPORTED_P or n > MAX_N or chunk > MAX_CHUNK
                           or any(t.stride(-1) != 1 for t in (x, B, C))):
        what = "bf16 x, B, C on sm90 or mma" if x.dtype == torch.bfloat16 else \
            "float32 x, B, C on tf32x3"
        raise ValueError(f"the pass kernels take {what}: sm90 at p {SM90_P}, n {SM90_N}, "
                         f"chunk {SM90_CHUNKS}, TMA-aligned; mma and tf32x3 at p "
                         f"{SUPPORTED_P}, n <= {MAX_N}, chunk <= {MAX_CHUNK}, unit stride "
                         f"last; not p={p}, n={n}, chunk={chunk}")
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}")
    return kind


def _elems(*tensors: torch.Tensor) -> int:
    """bf16 elements a copy that the mma passes may use for every tensor: 8
    (16-byte copies) for a 16-byte aligned start with strides that are
    multiples of 8 elements, 2 (4-byte copies) for a 4-byte aligned start
    with even strides, else 1 (plain 2-byte loads). Unit stride last."""
    for e in (8, 2):
        if all(t.data_ptr() % (2 * e) == 0 and all(st % e == 0 for st in t.stride()[:-1])
               for t in tensors):
            return e
    return 1


def _vec(*tensors: torch.Tensor) -> bool:
    """True if the tf32x3 passes may copy every float32 tensor in 16-byte
    pieces: a 16-byte aligned start, unit stride last, and the last dim and
    the other strides multiples of 4 elements."""
    return all(t.data_ptr() % 16 == 0 and t.stride(-1) == 1 and t.shape[-1] % 4 == 0
               and all(st % 4 == 0 for st in t.stride()[:-1]) for t in tensors)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _f32_scan_heads(nh: int, g: int, tiles: int, device: torch.device) -> int:
    """Heads per block of the tf32x3 and mma passes 3: the largest divisor
    of the heads per group up to ``F32_SCAN_HEADS`` whose grid (``tiles``
    blocks per head tile) still has a block for every SM, else 1."""
    rep = nh // g
    sms = _sm_count(device.index or 0)
    divisors = [d for d in range(min(rep, F32_SCAN_HEADS), 0, -1) if rep % d == 0]
    return next((d for d in divisors if tiles * (nh // d) >= sms), 1)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def chunk_state(x, dt, A, B, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: (states (b, s/c, nh, p, n) f32, cum (b, nh, s) f32). On the
    card bf16 runs on sm90 or mma (:func:`variant`), float32 on tf32x3."""
    if x.device.type in _PLAIN_DEVICES:
        return chunk_state_reference(x, dt, A, B, chunk)
    kind = _pass_kind(x, B, B, chunk)
    b, s, nh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dt, A = dt.to(torch.float32), _f32(A)
    states = torch.empty((b, s // chunk, nh, p, n), dtype=torch.float32, device=x.device)
    cum = torch.empty((b, nh, s), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        if kind == "sm90":
            rc = _lib().ssd_chunk_state_sm90(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), states.data_ptr(),
                cum.data_ptr(), b, s, nh, g, n, chunk, _heads(nh // g, STATE_HEADS),
                *x.stride()[:3], *dt.stride(), *B.stride()[:3], _stream(x))
        else:
            fn, widths = ((_lib().ssd_chunk_state_mma, (_elems(x), _elems(B))) if kind == "mma"
                          else (_lib().ssd_chunk_state_f32, (int(_vec(x)), int(_vec(B)))))
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), states.data_ptr(),
                    cum.data_ptr(), b, s, nh, p, g, n, chunk, *widths,
                    *x.stride()[:3], *dt.stride(), *B.stride()[:3], _stream(x))
    _raise(rc, f"{kind} chunk_state")
    return states, cum


def state_pass(states, cum, chunk: int, init_state=None,
               dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2: (h_in, final). On the card h_in, the state at each chunk's
    start, comes back in ``dtype``, the operand type of the pass 3 that reads
    it: bf16 (sm90) or float32 (tf32x3 and mma)."""
    if states.device.type in _PLAIN_DEVICES:
        return state_pass_reference(states, cum, chunk, init_state)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"starting states in bf16 (sm90) or float32 (tf32x3, mma), not {dtype}")
    return _state_pass(states, cum, chunk, init_state,
                       torch.empty(states.shape, dtype=dtype, device=states.device))


def _state_pass(states, cum, chunk: int, init_state, h_in) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 into ``h_in`` (bf16: sm90's kernel; float32: tf32x3's, which
    the mma variant shares and which may write over ``states`` itself)."""
    b, l, nh, p, n = states.shape
    if cum.shape != (b, nh, l * chunk):
        raise ValueError(f"cum {tuple(cum.shape)}, want {(b, nh, l * chunk)}")
    states, cum = _f32(states), _f32(cum)
    init = None if init_state is None else _f32(init_state)
    final = torch.empty((b, nh, p, n), dtype=torch.float32, device=states.device)
    kind = "tf32x3" if h_in.dtype == torch.float32 else "sm90"
    fn = _lib().ssd_state_pass_f32 if kind == "tf32x3" else _lib().ssd_state_pass_sm90
    with torch.cuda.device(states.device):
        rc = fn(states.data_ptr(), cum.data_ptr(), None if init is None else init.data_ptr(),
                h_in.data_ptr(), final.data_ptr(), b, l * chunk, nh, p * n, chunk,
                _stream(states))
    _raise(rc, f"{kind} state_pass")
    return h_in, final


def chunk_scan(x, dt, B, C, cum, h_in, chunk: int) -> torch.Tensor:
    """Pass 3: y (b, s, nh, p) in x's dtype. On the card h_in is taken in
    the kernel's operand type: rounded to bf16 for sm90 (a no-op for pass
    2's output), float32 for tf32x3 and mma."""
    if x.device.type in _PLAIN_DEVICES:
        return chunk_scan_reference(x, dt, B, C, cum, h_in, chunk)
    kind = _pass_kind(x, B, C, chunk)
    b, s, nh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if kind != "sm90":
        # tf32x3 and mma: float32 starting states; copy widths as each takes them
        dt, cum, h_in = dt.to(torch.float32), _f32(cum), _f32(h_in)
        y = torch.empty((b, s, nh, p), dtype=x.dtype, device=x.device)
        tiles = b * (s // chunk) * -(-chunk // 64)
        if kind == "mma":
            fn, widths = _lib().ssd_chunk_scan_mma, (_elems(x), _elems(B, C),
                                                     4 if _vec(h_in) else 1)
        else:
            fn, widths = _lib().ssd_chunk_scan_f32, (int(_vec(x)), int(_vec(B, C)),
                                                     int(_vec(h_in)))
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(), dt.data_ptr(),
                    h_in.data_ptr(), y.data_ptr(), b, s, nh, p, g, n, chunk,
                    _f32_scan_heads(nh, g, tiles, x.device), *widths, *x.stride()[:3],
                    *dt.stride(), *B.stride()[:3], *C.stride()[:3], *y.stride()[:3],
                    _stream(x))
        _raise(rc, f"{kind} chunk_scan")
        return y
    # the kernel copies each head's dt over a chunk in one piece: (b, nh, s)
    dtT = dt.to(torch.float32).transpose(1, 2).contiguous()
    cum, h_in = _f32(cum), h_in.to(torch.bfloat16).contiguous()
    y = torch.empty((b, s, nh, p), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().ssd_chunk_scan_sm90(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(), dtT.data_ptr(),
            h_in.data_ptr(), y.data_ptr(), b, s, nh, g, n, chunk, _heads(nh // g, SCAN_HEADS),
            *x.stride()[:3], *B.stride()[:3], *C.stride()[:3], *y.stride()[:3], _stream(x))
    _raise(rc, "sm90 chunk_scan")
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``repro_torch.models.ssm.ssd_chunked``."""
    global LAUNCHES
    _check(x, dt, A, B, C, init_state)
    b, s, nh, p = x.shape
    g, n = B.shape[2], B.shape[3]
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {c}")
    if x.device.type in _PLAIN_DEVICES:
        return ssd_reference(x, dt, A, B, C, chunk=c, init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B, C must all be float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if p not in SUPPORTED_P or n > MAX_N or c > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes head dims {SUPPORTED_P}, d_state <= {MAX_N} "
                         f"and chunks <= {MAX_CHUNK}, not p={p}, n={n}, chunk={c}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in its last dim")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, B, C, init_state)):
        raise NotImplementedError("the SSD scan kernel has no backward")
    dt = dt.to(torch.float32)
    A = _f32(A)
    if init_state is not None:
        init_state = _f32(init_state)
    kind = variant(x.dtype, p, n, c, tma_aligned(x, B, C))
    if kind == "sm90":
        states, cum = chunk_state(x, dt, A, B, c)
        h_in, state = state_pass(states, cum, c, init_state)
        del states
        y = chunk_scan(x, dt, B, C, cum, h_in, c)
    else:
        # tf32x3 and mma: the float32 starting states written over the chunk
        # states, in place
        states, cum = chunk_state(x, dt, A, B, c)
        h_in, state = _state_pass(states, cum, c, init_state, states)
        y = chunk_scan(x, dt, B, C, cum, h_in, c)
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[kind] += 1
    return y, state
