"""Public wrapper for the fused AdamW kernel (``csrc/adamw.cu``).

``adamw_`` takes the leaves of a float32 tree as lists (params, gradients,
first and second moments), the device scalars ``lr``, ``c1`` and ``c2``, and
the hyperparameters; it updates params and moments in place and returns the
gradients' global norm as a float32 scalar on the device. Leaves on the CPU
go to the plain version (:func:`ref.adamw_reference`); leaves on a CUDA
device go to the kernel, or the call raises. :func:`takes` says which state
leaves the kernel takes: param and moments float32 and contiguous on one CUDA
device. A gradient may be of any float dtype and layout on its param's
device: one that is not float32 and contiguous is read through a float32
contiguous copy (:func:`kernel_grad`), which costs one copy of that leaf.

On the card a step is three launches for up to 48 leaves (more leaves add a
sum pass and an update a batch): the sum of squares, the norm and clip scale
(one block), the update. No host sync: the norm and the scale stay on the
device, and the update reads them there. ``LAUNCHES`` counts the launches the
C entry reports, per kernel (never the CPU path), so that a run can show that
its optimizer went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import _build
from .ref import adamw_reference

LAUNCHES = {"sumsq": 0, "norm_scale": 0, "update": 0}

_P = ctypes.c_void_p
_F = ctypes.c_float
_C = ctypes.c_int


def _lib():
    lib = _build.load("adamw")
    if lib.adamw_step.argtypes is None:
        lib.adamw_partials.restype = ctypes.c_int
        lib.adamw_partials.argtypes = []
        lib.adamw_step.restype = ctypes.c_int
        lib.adamw_step.argtypes = [_C, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _F, _F, _F, _F, _F, _F, _F, _P, _P, _C, _P, _P]
    return lib


def takes(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor) -> bool:
    """The kernel takes this state leaf (a param and its two moments): three
    float32 contiguous tensors of one shape on one CUDA device."""
    ts = (p, m, v)
    return (all(isinstance(t, torch.Tensor) for t in ts)
            and p.device.type == "cuda"
            and all(t.device == p.device and t.dtype == torch.float32 and t.is_contiguous()
                    and t.shape == p.shape for t in ts))


def kernel_grad(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g`` as the kernel reads it: float32 and contiguous on ``p``'s device
    (``g`` itself when it already is; else a copy). Raises on a gradient of
    another shape or device."""
    if g.shape != p.shape or g.device != p.device:
        raise ValueError(f"the AdamW kernel takes a gradient of its param's shape and device: "
                         f"{tuple(g.shape)} on {g.device} for {tuple(p.shape)} on {p.device}")
    return g.to(torch.float32).contiguous()


def _ptrs(ts: Sequence[torch.Tensor]):
    return (_P * len(ts))(*[t.data_ptr() for t in ts])


def adamw_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], lr: torch.Tensor,
           c1: torch.Tensor, c2: torch.Tensor, *, b1: float, b2: float, eps: float,
           weight_decay: float, grad_clip: float) -> torch.Tensor:
    """One AdamW step with its global-norm clip, in place. Returns the norm."""
    k = len(params)
    if not k or not len(grads) == len(ms) == len(vs) == k:
        raise ValueError(f"leaves: {k} params, {len(grads)} grads, {len(ms)} m, {len(vs)} v")
    dev = params[0].device
    if dev.type == "cpu" and all(t.device.type == "cpu" for t in (*grads, *ms, *vs)):
        return adamw_reference(params, grads, ms, vs, lr, c1, c2, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay, grad_clip=grad_clip)
    bad = [i for i, leaf in enumerate(zip(params, ms, vs)) if not takes(*leaf)]
    if bad:
        raise ValueError(f"the AdamW kernel takes float32 contiguous params and moments of one "
                         f"shape on one CUDA device; leaves {bad[:8]} are not")
    if any(t.device != dev for t in params):
        raise ValueError("the AdamW kernel takes leaves on one device")
    grads = [kernel_grad(p, g) for p, g in zip(params, grads)]
    for name, s in (("lr", lr), ("c1", c1), ("c2", c2)):
        if s.device != dev or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError(f"{name} must be one float32 value on {dev}")
    live = [i for i in range(k) if params[i].numel()]
    p, g, m, v = ([ts[i] for i in live] for ts in (params, grads, ms, vs))
    n = (ctypes.c_longlong * len(live))(*[t.numel() for t in p])
    decay = (ctypes.c_ubyte * len(live))(*[int(weight_decay > 0 and t.ndim >= 2) for t in p])
    lib = _lib()
    # one allocation: the C entry's float64 partial sums, then the norm and
    # the scale as two float32 in the last slot
    k_part = lib.adamw_partials()
    scratch = torch.empty(k_part + 1, dtype=torch.float64, device=dev)
    partials, norm_scale = scratch[:k_part], scratch[k_part:].view(torch.float32)
    launched = (_C * 3)()
    rc = lib.adamw_step(len(live), _ptrs(p), _ptrs(g), _ptrs(m), _ptrs(v), n, decay,
                        lr.data_ptr(), c1.data_ptr(), c2.data_ptr(), b1, b2, 1 - b1, 1 - b2,
                        eps, weight_decay, grad_clip, partials.data_ptr(), norm_scale.data_ptr(),
                        dev.index, torch.cuda.current_stream(dev).cuda_stream, launched)
    for key, count in zip(LAUNCHES, launched):
        LAUNCHES[key] += count
    if rc != 0:
        raise RuntimeError(f"AdamW kernel launch failed: CUDA error {rc}")
    return norm_scale[0]
