"""Adam(W) with dtype-configurable state, updated in place.

Counterpart of ``repro.train.optimizer``, term for term: global-norm clip,
bias correction with ``t = step + 1``, decoupled weight decay on leaves with
``ndim >= 2`` only, the warmup + cosine ``lr_schedule``, and moments stored in
float32, bfloat16 or per-row int8 (``_quant_rows``, plain torch: the
reference computes it in jnp, not through its Pallas kernel). Parameters may
be kept in bf16 with stochastic rounding.

The reference returns new trees and donates the old buffers; here the update
runs under ``torch.no_grad()`` and writes params and moments in place, into
the same storage. Int8 moment leaves are ``{"q": int8, "s": f32}`` dicts, as
in the reference.

Two routes, chosen by the state (:func:`fused_route`), never by a setting: a
state on the card that is float32 throughout (params and moments,
contiguous) goes through the hand-written kernel ``kernels/adamw``, three
launches a step for all leaves (the sum of squares, the norm and clip scale,
the update: 32 bytes an element), which leaves the gradients as they are; a
gradient that is not float32 and contiguous is read through a float32 copy of
that leaf. Any other state (bf16 or int8 moments, bf16 params, the CPU) takes
the per-leaf path in PyTorch ops, one leaf's temporaries at a time, which
scales the gradients in place. The two compute the same terms with the same roundings;
the kernel sums the norm's squares in float64, so its clip scale can differ
from the per-leaf path's float32 sum in the last bits.

Stochastic rounding draws its 16 random bits per value from a
``torch.Generator`` on the leaf's device, seeded from the state's rng leaf,
the step and the leaf index (the reference folds the same three into a
``jax.random`` key). The bits differ from the reference's, so tests hold it to
being unbiased, not to equality.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch import obs
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.adamw.ref import clip_scale
from repro_torch.kernels.quant_blockwise.ref import INV_QMAX
from repro_torch.models.params import tree_items, tree_map


@dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"       # float32 | bfloat16 | int8
    stochastic_round_params: bool = False
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1


MOMENT_DTYPES = ("float32", "bfloat16", "int8")


def _f32(x: float, device) -> torch.Tensor:
    # a fill on the device: torch.tensor(x, device=...) copies from pageable
    # host memory, which synchronises the stream in the middle of each step
    return torch.full((), x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine to ``min_lr_ratio * lr`` (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# --------------------------------------------------------------------------- #
# Moment (de)quantisation
# --------------------------------------------------------------------------- #
def _quant_rows(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-row absmax int8. x: (..., d) f32 -> {'q': int8, 's': f32 rows}.

    ``s`` is a product with the float32 reciprocal of 127, as the reference's
    compiled train step computes its ``/ 127.0`` (see the quant kernels' ref).
    """
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.maximum(amax, _f32(1e-12, x.device)) * _f32(INV_QMAX, x.device)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s[..., 0]}


def _dequant_rows(m: Dict[str, torch.Tensor]) -> torch.Tensor:
    return m["q"].to(torch.float32) * m["s"][..., None]


def _moment_init(leaf: torch.Tensor, dtype: str):
    if dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be one of {MOMENT_DTYPES}, not {dtype!r}")
    if dtype == "int8":
        return {"q": torch.zeros(leaf.shape, dtype=torch.int8, device=leaf.device),
                "s": torch.zeros(leaf.shape[:-1], dtype=torch.float32, device=leaf.device)}
    return torch.zeros(leaf.shape, dtype=getattr(torch, dtype), device=leaf.device)


def _moment_get(m, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequant_rows(m)
    return m.to(torch.float32)


def _moment_put(m, x: torch.Tensor, dtype: str) -> None:
    """Write the float32 moment ``x`` into the stored moment ``m`` in place."""
    if dtype == "int8":
        qs = _quant_rows(x)
        m["q"].copy_(qs["q"])
        m["s"].copy_(qs["s"])
    elif m.data_ptr() != x.data_ptr():
        m.copy_(x)


# --------------------------------------------------------------------------- #
# Init / update
# --------------------------------------------------------------------------- #
def adam_init(params, cfg: AdamConfig):
    return {"m": tree_map(lambda p: _moment_init(p, cfg.moment_dtype), params),
            "v": tree_map(lambda p: _moment_init(p, cfg.moment_dtype), params)}


def moment_axes(axes_leaf: tuple, dtype: str):
    """Logical axes for a moment leaf mirroring a param's axes (an int8
    moment's row scales drop the last axis)."""
    if dtype == "int8":
        return {"q": axes_leaf, "s": axes_leaf[:-1]}
    return axes_leaf


def adam_state_axes(param_axes, cfg: AdamConfig):
    return {"m": tree_map(lambda a: moment_axes(a, cfg.moment_dtype), param_axes),
            "v": tree_map(lambda a: moment_axes(a, cfg.moment_dtype), param_axes)}


def _node(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32))) for g in leaves])))


def stochastic_round_bf16(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding on the 16 dropped mantissa bits.

    Same bit arithmetic as the reference: add 16 uniform random bits to the
    float32 pattern and truncate. int32 addition wraps as uint32 does.
    """
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    rnd = torch.randint(0, 1 << 16, x.shape, dtype=torch.int32, device=x.device,
                        generator=generator)
    return ((bits + rnd) & -65536).view(torch.float32).to(torch.bfloat16)


def _round_seed(rng: torch.Tensor, step: int, leaf: int) -> int:
    """A 63-bit generator seed from the rng leaf, the step and the leaf index
    (splitmix64 finaliser over their combination)."""
    r0, r1 = (int(v) & 0xFFFFFFFF for v in rng.reshape(-1)[:2].tolist())
    z = ((r0 << 32) | r1) ^ (step * 0x9E3779B97F4A7C15) ^ (leaf * 0xBF58476D1CE4E5B9)
    z &= (1 << 64) - 1
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) >> 1


def step_scalars(cfg: AdamConfig, step: torch.Tensor, device):
    """The step's learning rate and bias corrections ``1 - b ** (step + 1)``,
    float32 scalars on ``device``: (lr, c1, c2)."""
    step_d = step.to(device)
    t = step_d.to(torch.float32) + 1.0
    return (lr_schedule(cfg, step_d), 1.0 - torch.pow(_f32(cfg.b1, device), t),
            1.0 - torch.pow(_f32(cfg.b2, device), t))


def fused_route(p_leaves, m_leaves, v_leaves, cfg: AdamConfig) -> bool:
    """Whether a step takes the fused kernel (``kernels/adamw``): float32
    moments, and every param and moment float32 and contiguous on one CUDA
    device. Decided by the state alone, before any launch: the gradients'
    dtype and layout do not choose the route (the kernel reads an odd one
    through a float32 copy)."""
    return (cfg.moment_dtype == "float32"
            and all(adamw_ops.takes(p, m, v) and p.device == p_leaves[0].device
                    for p, m, v in zip(p_leaves, m_leaves, v_leaves)))


def _per_leaf_update(p_leaves, g_leaves, m_leaves, v_leaves, lr, c1, c2, step: torch.Tensor,
                     cfg: AdamConfig, rng: Optional[torch.Tensor]) -> torch.Tensor:
    """The update leaf by leaf in PyTorch ops: any moment dtype, bf16 params
    with or without stochastic rounding, any device. Scales ``g_leaves`` in
    place. Returns the global norm."""
    gnorm = global_norm(g_leaves)
    scale = clip_scale(gnorm, cfg.grad_clip)
    step_int = None
    for i, (p, g, m, v) in enumerate(zip(p_leaves, g_leaves, m_leaves, v_leaves)):
        g = g.to(torch.float32)
        g.mul_(scale)
        m_f = _moment_get(m, cfg.moment_dtype)
        v_f = _moment_get(v, cfg.moment_dtype)
        m_f = m_f.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v_f = v_f.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        upd = (m_f / c1) / (torch.sqrt(v_f / c2) + cfg.eps)
        _moment_put(m, m_f, cfg.moment_dtype)
        _moment_put(v, v_f, cfg.moment_dtype)
        del m_f, v_f
        p_f = p.to(torch.float32)
        if cfg.weight_decay > 0 and p.ndim >= 2:
            upd.add_(cfg.weight_decay * p_f)
        upd.mul_(lr)
        if p.dtype == torch.bfloat16 and cfg.stochastic_round_params:
            if rng is None:
                raise ValueError("stochastic rounding needs the state's rng leaf")
            if step_int is None:
                step_int = int(step)
            gen = torch.Generator(device=p.device)
            gen.manual_seed(_round_seed(rng, step_int, i))
            p.copy_(stochastic_round_bf16(p_f - upd, gen))
        elif p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p_f - upd)
    return gnorm


@torch.no_grad()
def adam_update(params, grads, opt_state, step: torch.Tensor, cfg: AdamConfig,
                rng: Optional[torch.Tensor] = None):
    """One Adam step, in place. Returns (params, opt_state, metrics).

    ``grads`` mirrors ``params``. A state that :func:`fused_route` accepts (on
    the card, float32 params and moments) goes through the fused kernel: two
    passes over all leaves, the clip's norm and then the update, with
    ``grads`` left as they are (each on its param's card, of any float dtype
    and layout); the step adds ``fused_leaves`` to the innermost open span
    (``train.adam`` in the trainer). Any other state takes the per-leaf path,
    which consumes ``grads``: it scales them in place.
    """
    paths = [path for path, _ in tree_items(params)]
    p_leaves = [_node(params, p) for p in paths]
    g_leaves = [_node(grads, p) for p in paths]
    m_leaves = [_node(opt_state["m"], p) for p in paths]
    v_leaves = [_node(opt_state["v"], p) for p in paths]
    lr, c1, c2 = step_scalars(cfg, step, g_leaves[0].device)
    if fused_route(p_leaves, m_leaves, v_leaves, cfg):
        gnorm = adamw_ops.adamw_(p_leaves, g_leaves, m_leaves, v_leaves, lr, c1, c2,
                                 b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                                 weight_decay=cfg.weight_decay, grad_clip=cfg.grad_clip)
        obs.add(fused_leaves=len(paths))
    else:
        gnorm = _per_leaf_update(p_leaves, g_leaves, m_leaves, v_leaves, lr, c1, c2, step,
                                 cfg, rng)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
