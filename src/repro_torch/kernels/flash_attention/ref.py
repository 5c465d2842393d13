"""Plain PyTorch oracle for the flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ref``. It is what
``ops.flash_attention`` runs for tensors on the CPU, and what the CUDA kernel
is held against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Exact attention. q: (B, S, H, D); k, v: (B, T, KH, D), H = KH * rep."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    rep = h // kh
    qh = q.reshape(b, s, kh, rep, d)
    # scores in float32, as jnp.einsum(..., preferred_element_type=f32)
    scores = torch.einsum("bqkrd,btkd->bkrqt", qh.float(), k.float())
    scores = scores * torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    if causal:
        mask = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkrqt,btkd->bqkrd", w.to(v.dtype), v)
    return o.reshape(b, s, h, d)
