"""Plain PyTorch pieces the references share: the operand rounding that
separates the configuration's precision from the control's, norms, RoPE,
the embedding and head, cross-entropy and AdamW.

Everything here is written out from the published equations in plain torch
operations, in the order the configuration states its precisions: products
of bfloat16 operands, norms, softmax, the scan's internals and the optimizer
in float32. It imports nothing of the program, and takes nothing the program
made: the weights and inputs come from the benchmark's own generators.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

COMPUTE = torch.bfloat16
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale for the tensor (its
    absolute maximum onto e4m3's 448), returned in bfloat16."""
    xf = x.detach().float()
    s = xf.abs().amax().clamp(min=1e-30) / FP8_MAX
    return ((xf / s).to(FP8).float() * s).to(COMPUTE)


class Precision:
    """How a tensor that the configuration holds in bfloat16 reaches a
    product. ``"bf16"`` casts it, as the configuration states. ``"fp8"``
    (the control: the step below bfloat16) rounds it through float8 e4m3
    first, with one scale per tensor; under autograd the rounding passes
    the gradient straight through."""

    NAMES = ("bf16", "fp8")

    def __init__(self, name: str = "bf16"):
        if name not in self.NAMES:
            raise ValueError(f"precision must be one of {self.NAMES}, not {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(COMPUTE)
        if self.name == "bf16":
            return y
        q = _fp8_round(y)
        return y + (q - y).detach() if y.requires_grad else q


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, returned in x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves, in float32, returned in x's dtype.
    x: (b, s, h, d); positions: (b, s)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor, lp: Precision) -> torch.Tensor:
    return torch.index_select(lp(table), 0, tokens.reshape(-1)).reshape(*tokens.shape, -1)


def head(x: torch.Tensor, w: torch.Tensor, lp: Precision) -> torch.Tensor:
    return lp(x) @ lp(w)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over labels >= 0."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    ll = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(mask, lse - ll, 0.0)
    return nll.sum() / torch.clamp(mask.float().sum(), min=1.0)


def layer(params: Dict[str, torch.Tensor], prefix: str, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of every stacked leaf under ``prefix``."""
    return {k[len(prefix):]: v[i] for k, v in params.items() if k.startswith(prefix)}


def path_order(tree: Dict[str, torch.Tensor]) -> List[str]:
    return sorted(tree, key=lambda p: p.split("/"))


# --------------------------------------------------------------------------- #
# AdamW (decoupled weight decay on leaves of two or more dims), float32
# moments, global-norm clipping, bias correction with t = step + 1, and the
# warmup + cosine learning rate
# --------------------------------------------------------------------------- #
def learning_rate(opt: dict, step: int, device) -> torch.Tensor:
    s = torch.tensor(float(step), dtype=torch.float32, device=device)
    warm = s / max(opt["warmup_steps"], 1)
    prog = torch.clamp((s - opt["warmup_steps"])
                       / max(opt["decay_steps"] - opt["warmup_steps"], 1), 0.0, 1.0)
    r = opt["min_lr_ratio"]
    cos = r + (1 - r) * 0.5 * (1 + torch.cos(math.pi * prog))
    return opt["lr"] * torch.where(s < opt["warmup_steps"], warm, cos)


@torch.no_grad()
def adamw(params: Dict[str, torch.Tensor], grads: List[torch.Tensor],
          m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], step: int,
          opt: dict) -> None:
    """One AdamW step, in place, over the leaves in path order (each path
    component sorted in turn), the order the global norm sums in."""
    paths = path_order(params)
    dev = grads[0].device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    gnorm = torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(g.float()))
                                              for g in grads])))
    scale = torch.clamp(opt["grad_clip"] / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = learning_rate(opt, step, dev)
    t = f32(step + 1.0)
    b1, b2 = opt["b1"], opt["b2"]
    c1 = 1.0 - torch.pow(f32(b1), t)
    c2 = 1.0 - torch.pow(f32(b2), t)
    for path, g in zip(paths, grads):
        p = params[path]
        g = g.float() * scale
        mf = m[path].mul_(b1).add_((1 - b1) * g)
        vf = v[path].mul_(b2).add_((1 - b2) * g * g)
        upd = (mf / c1) / (torch.sqrt(vf / c2) + opt["eps"])
        if opt["weight_decay"] > 0 and p.ndim >= 2:
            upd.add_(opt["weight_decay"] * p)
        p.sub_(upd.mul_(lr))
