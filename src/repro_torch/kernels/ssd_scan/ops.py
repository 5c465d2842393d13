"""Public wrapper for the SSD chunked-scan kernel.

Counterpart of ``repro.kernels.ssd_scan.ops``: the same signature and the
contract of ``ssd_chunked`` (x (b, s, nh, p), dt (b, s, nh), A (nh,), B and C
(b, s, g, n), optional init state (b, nh, p, n); returns y in x's dtype and
the final state in float32; the chunk is ``min(chunk, s)`` and must divide
s). A tensor on the CPU goes to the plain version (:func:`ref.ssd_reference`);
a tensor on a CUDA device goes to the hand-written kernel in
``csrc/ssd_scan.cu``, or the call raises. The kernel reads x, B and C through
their (b, s, head or group) strides, so the model's views into the conv
output reach it with no copy.

``LAUNCHES`` counts kernel launches (never the CPU path), so that a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import ssd_reference

LAUNCHES = 0

SUPPORTED_P = (16, 32, 64)     # head dims the kernel is instantiated for
MAX_N = 128                    # d_state
MAX_CHUNK = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_C = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p


def _kernel():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,      # x dt A B C init y state
                       _C, _C,                              # dtype device
                       _C, _C, _C, _C, _C, _C, _C,          # b s nh p g n chunk
                       _L, _L, _L, _L, _L, _L,              # x, dt strides
                       _L, _L, _L, _L, _L, _L,              # B, C strides
                       _L, _L, _L,                          # y strides
                       _P]                                  # stream
    return fn


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
    if x.device.type == "cpu":
        return ssd_reference(x, dt, A, B, C, chunk=c, init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
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
    f32 = torch.float32
    dt = dt.to(f32)
    A = A.to(f32).contiguous()
    if init_state is not None:
        init_state = init_state.to(f32).contiguous()
    y = torch.empty((b, s, nh, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, nh, p, n), dtype=f32, device=x.device)
    rc = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                   None if init_state is None else init_state.data_ptr(),
                   y.data_ptr(), state.data_ptr(),
                   _DTYPE_CODE[x.dtype], x.device.index or 0,
                   b, s, nh, p, g, n, c,
                   *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
                   *y.stride()[:3], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y, state
