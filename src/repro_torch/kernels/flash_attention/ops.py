"""Public wrapper for the flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ops``: same signature and
model layout, q (B, S, H, D) and k, v (B, T, KH, D). A tensor on the CPU goes
to the plain version (:func:`ref.attention_reference`), and so does a meta
tensor (shapes only, for the dry run); a tensor on a CUDA device goes to a
hand-written kernel, or the call raises. Which kernel is
fixed by dtype (:func:`variant`), never by a failure:

* ``"sm90"``: bf16 at D 16, 32, 64 and 128, on the tensor cores (wgmma fed
  by TMA), ``csrc/flash_attention_sm90.cu``; the serving path, and at D 16
  every reduced config's;
* ``"tf32x3"``: float32 at D 16, 32, 64 and 128, on the tensor cores
  (mma.sync fed by TMA), each product as three TF32 products of a hi / lo
  split, which keeps float32's accuracy, ``csrc/flash_attention_f32_sm90.cu``.

``csrc/flash_attention.cu`` holds the C entry point that hands a call to
one of the two. Both read the (B, S, H, D) strides directly, so there is no
transpose copy around them.

``LAUNCHES`` counts kernel launches (never the CPU path), so that a run can
show that its main path went through the kernel; ``LAUNCHES_BY_VARIANT``
splits the same count by variant.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_reference

# the plain version's devices: the CPU, and meta tensors (shapes only)
_PLAIN_DEVICES = ("cpu", "meta")
LAUNCHES = 0
LAUNCHES_BY_VARIANT = {"sm90": 0, "tf32x3": 0}

SUPPORTED_D = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"sm90": 0, "tf32x3": 1}
_C = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p


def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.fa_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [_P, _P, _P, _P, _C, _C, _C,              # q k v o dtype variant device
                       _C, _C, _C, _C, _C, _C,                  # B S T H KH D
                       _L, _L, _L, _L, _L, _L,                  # q, k strides
                       _L, _L, _L, _L, _L, _L,                  # v, o strides
                       _C, _P]                                  # causal stream
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be 4-D: (B, S, H, D), (B, T, KH, D)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if h % k.shape[2] != 0:
        raise ValueError(f"H={h} is not a multiple of KH={k.shape[2]}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes (dtype, head dim) on the card: each dtype has
    one kernel for every head dim of ``SUPPORTED_D``."""
    return "tf32x3" if dtype == torch.float32 else "sm90"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KH, D) -> (B, S, H, D), in q's dtype."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type in _PLAIN_DEVICES:
        return attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if d not in SUPPORTED_D:
        raise ValueError(f"the CUDA kernel takes head dims {SUPPORTED_D}, not D={d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads and TMA")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the flash-attention kernel has no backward yet")
    kind = variant(q.dtype, d)
    out = torch.empty_like(q)
    rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   _DTYPE_CODE[q.dtype], _VARIANT_CODE[kind], q.device.index or 0,
                   b, s, t, h, kh, d,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                   int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {kind} kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[kind] += 1
    return out
