"""Plain PyTorch version of the fused AdamW kernel's two passes.

What ``ops.adamw_`` runs for leaves on the CPU, and what the CUDA kernel is
held against on the card. Pass 1: the global norm of the gradients, squares
summed in float64 (the kernel sums exact float64 squares too, in another
order) and rounded once to float32. Pass 2: each leaf's update, term for term
as ``train/optimizer.py``'s per-leaf path computes it for float32 moments:

    scale = min(1, clip * (1 / max(norm, 1e-12)))      (1 without a clip)
    g' = g * scale
    m = b1 * m + (1 - b1) * g'
    v = b2 * v + ((1 - b2) * g') * g'
    u = (m / c1) / (sqrt(v / c2) + eps)   (+ wd * p where p.ndim >= 2)
    p = p - lr * u

``p``, ``m`` and ``v`` are updated in place; ``g`` is left as it is.
"""
from __future__ import annotations

from typing import Sequence

import torch


def global_norm_f64(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the float64 sum of squares of every gradient, as float32."""
    dev = grads[0].device if grads else torch.device("cpu")
    sq = torch.zeros((), dtype=torch.float64, device=dev)
    for g in grads:
        sq = sq + torch.sum(torch.square(g.to(torch.float64)))
    return torch.sqrt(sq).to(torch.float32)


def clip_scale(gnorm: torch.Tensor, grad_clip: float) -> torch.Tensor:
    """``min(1, clip / max(norm, 1e-12))`` as the per-leaf path computes it
    (a reciprocal, then the product), or 1 without a clip."""
    if grad_clip > 0:
        return torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    return torch.ones((), dtype=torch.float32, device=gnorm.device)


@torch.no_grad()
def adamw_reference(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                    ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], lr: torch.Tensor,
                    c1: torch.Tensor, c2: torch.Tensor, *, b1: float, b2: float, eps: float,
                    weight_decay: float, grad_clip: float) -> torch.Tensor:
    """One AdamW step with its clip over float32 params and moments, in place
    (gradients of any float dtype, read as float32). Returns the gradients'
    global norm (a float32 scalar)."""
    gnorm = global_norm_f64(grads)
    scale = clip_scale(gnorm, grad_clip)
    for p, g, m, v in zip(params, grads, ms, vs):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay > 0 and p.ndim >= 2:
            upd.add_(weight_decay * p)
        p.sub_(upd.mul_(lr))
    return gnorm
