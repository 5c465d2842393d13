"""Mamba-2 (state-space duality) block.

Counterpart of ``repro.models.ssm``. Training and prefill run the chunked SSD
algorithm in three passes (:func:`chunk_state`, :func:`state_pass`,
:func:`chunk_scan`): each chunk's own state, the inter-chunk state carried
by an in-order loop over chunks (the reference's ``lax.scan``), then the
outputs, intra-chunk terms as dense (c x c) products. Decode is the O(1)
recurrent step. The hand-written kernels in ``repro_torch.kernels.ssd_scan``
compute the same scan (the ``sm90`` one in the same three passes);
:func:`ssd_chunked` is their plain version (``kernels/ssd_scan/ref.py``).

``ssm_forward(..., use_kernel=True)`` sends the scan to the kernel (the
reference's ``use_pallas``); the model passes it for ``attn_impl="kernel"``,
the serving default, and runs :func:`ssd_chunked` otherwise (training, and the
all-plain prefill the card holds the kernel against).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamBuilder, torch_dtype


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_dim


def ssm_params(pb: ParamBuilder, cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_in, n_heads, conv_dim = ssm_dims(cfg)
    return {
        # order: [z (d_in), xBC (conv_dim), dt (n_heads)]
        "w_in": pb.param((d, 2 * d_in + 2 * s.n_groups * s.d_state + n_heads),
                         ("embed", "heads")),
        "conv_w": pb.param((s.d_conv, conv_dim), (None, "heads")),
        "conv_b": pb.param((conv_dim,), ("heads",), init="zeros"),
        "A_log": pb.param((n_heads,), (None,), init="zeros"),
        "D": pb.param((n_heads,), (None,), init="ones"),
        "dt_bias": pb.param((n_heads,), (None,), init="zeros"),
        "w_out": pb.param((d_in, d), ("heads", "embed")),
    }


# --------------------------------------------------------------------------- #
# SSD chunked scan (the kernel's plain version)
# --------------------------------------------------------------------------- #
def chunk_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the chunked scan: each chunk's own state, from a zero start.
      x: (b, s, h, p)  dt: (b, s, h)  A: (h,)  B: (b, s, g, n); h = g*rep
    Returns (states: (b, l, h, p, n) f32, cum: (b, h, s) f32), cum the prefix
    sum of dt*A within each chunk, l = s // chunk.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    l = s // chunk
    f32 = torch.float32
    dA = (dt.to(f32) * A.to(f32)).reshape(b, l, chunk, h)                  # (b,l,c,h)
    cum = torch.cumsum(dA, dim=2)
    xdt = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, l, chunk, g, rep, p)
    Bc = B.to(f32).reshape(b, l, chunk, g, n)
    ds = torch.exp(cum[:, :, -1:, :] - cum).reshape(b, l, chunk, g, rep)
    S = torch.einsum("bljgn,bljgr,bljgrp->blgrpn", Bc, ds, xdt)            # (b,l,g,r,p,n)
    return S.reshape(b, l, h, p, n), cum.permute(0, 3, 1, 2).reshape(b, h, s)


def state_pass(states: torch.Tensor, cum: torch.Tensor, chunk: int,
               init_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2: the inter-chunk recurrence, chunk by chunk in order (the
    reference's ``lax.scan``), state <- state * exp(cum_last) + states[k].
      states: (b, l, h, p, n) f32  cum: (b, h, s)  init_state: (b, h, p, n)
    Returns (h_in: (b, l, h, p, n), the state at each chunk's start, and the
    final state (b, h, p, n), both f32).
    """
    b, l, h, p, n = states.shape
    f32 = torch.float32
    decay = torch.exp(cum.reshape(b, h, l, chunk)[..., -1]).transpose(1, 2)  # (b,l,h)
    if init_state is None:
        h_cur = torch.zeros((b, h, p, n), dtype=f32, device=states.device)
    else:
        h_cur = init_state.to(f32)
    h_ins = []
    for i in range(l):
        h_ins.append(h_cur)
        h_cur = h_cur * decay[:, i, :, None, None] + states[:, i]
    return torch.stack(h_ins, dim=1), h_cur


def chunk_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               cum: torch.Tensor, h_in: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pass 3: the outputs, intra-chunk (dense (c x c) products, masked to
    j <= i) plus the inter-chunk term from each chunk's starting state.
      x: (b, s, h, p)  dt: (b, s, h)  B, C: (b, s, g, n)  cum: (b, h, s)
      h_in: (b, l, h, p, n)
    Returns y: (b, s, h, p) in x's dtype.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    l = s // chunk
    f32 = torch.float32
    xdt = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, l, chunk, g, rep, p)
    Bc = B.to(f32).reshape(b, l, chunk, g, n)
    Cc = C.to(f32).reshape(b, l, chunk, g, n)
    cl = cum.reshape(b, h, l, chunk).transpose(1, 2).contiguous()          # (b,l,h,c)
    # L[i, j] = exp(cum_i - cum_j) on j <= i: -inf above the diagonal first
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask, cl[..., :, None] - cl[..., None, :], -torch.inf))
    L = L.reshape(b, l, g, rep, chunk, chunk)
    CB = torch.einsum("blign,bljgn->blgij", Cc, Bc)                        # (b,l,g,c,c)
    M = CB[:, :, :, None] * L                                              # (b,l,g,r,c,c)
    y_intra = torch.einsum("blgrij,bljgrp->bligrp", M, xdt)
    state_decay = torch.exp(cl).permute(0, 1, 3, 2).reshape(b, l, chunk, g, rep)
    hg = h_in.to(f32).reshape(b, l, g, rep, p, n)
    y_inter = torch.einsum("blign,blgrpn,bligr->bligrp", Cc, hg, state_decay)
    return (y_intra + y_inter).reshape(b, s, h, p).to(x.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: :func:`chunk_state`, :func:`state_pass`, :func:`chunk_scan`.
      x: (b, s, h, p)  dt: (b, s, h)  A: (h,)  B, C: (b, s, g, n); h = g*rep
    Returns (y: (b, s, h, p) in x's dtype, final_state: (b, h, p, n) f32).
    """
    if x.shape[1] % chunk:
        raise ValueError(f"sequence length {x.shape[1]} is not a multiple of chunk {chunk}")
    states, cum = chunk_state(x, dt, A, B, chunk)
    h_in, final = state_pass(states, cum, chunk, init_state)
    return chunk_scan(x, dt, B, C, cum, h_in, chunk), final


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step.
      state: (b, h, p, n)  x: (b, h, p)  dt: (b, h)  A: (h,)  B, C: (b, g, n)
    Returns (y: (b, h, p), new_state).
    """
    h = state.shape[1]
    rep = h // B.shape[1]
    f32 = torch.float32
    dA = torch.exp(dt.to(f32) * A.to(f32))                                 # (b,h)
    Bh = B.to(f32).repeat_interleave(rep, dim=1)                           # (b,h,n)
    Ch = C.to(f32).repeat_interleave(rep, dim=1)
    upd = (dt.to(f32)[..., None, None]
           * x.to(f32)[..., None] * Bh[:, :, None, :])                     # (b,h,p,n)
    new_state = state.to(f32) * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state


# --------------------------------------------------------------------------- #
# Conv helpers
# --------------------------------------------------------------------------- #
def causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. xBC: (b, s, c); w: (k, c). Returns (y, tail_state).

    A sum of k shifted products in xBC's dtype, then SiLU, as the reference.
    """
    k = w.shape[0]
    if init_state is None:
        pad = xBC.new_zeros((xBC.shape[0], k - 1, xBC.shape[2]))
    else:
        pad = init_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    y = sum(xp[:, i:i + xBC.shape[1]] * w[i].to(xBC.dtype) for i in range(k))
    y = F.silu(y + b.to(xBC.dtype))
    tail = xp[:, -(k - 1):] if k > 1 else xBC.new_zeros((xBC.shape[0], 0, xBC.shape[2]))
    return y, tail


# --------------------------------------------------------------------------- #
# Full block forward
# --------------------------------------------------------------------------- #
def _split_proj(p, x: torch.Tensor, cfg: ModelConfig):
    d_in, n_heads, conv_dim = ssm_dims(cfg)
    dt_ = torch_dtype(cfg.compute_dtype)
    zxbcdt = x.to(dt_) @ p["w_in"].to(dt_)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim:]
    return z, xBC, dt


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig,
                init_conv: Optional[torch.Tensor] = None,
                init_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False) -> Tuple[torch.Tensor, dict]:
    """Training / prefill. Returns (y, {'conv': tail, 'state': final_state}).

    x, B and C reach the scan as strided views into the conv output, with no
    copy; ``use_kernel`` sends the scan to the SSD kernel (its plain version
    for tensors on the CPU).
    """
    s = cfg.ssm
    d_in, n_heads, conv_dim = ssm_dims(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    b, seq, _ = x.shape
    gn = s.n_groups * s.d_state

    z, xBC, dt = _split_proj(p, x, cfg)
    xBC, conv_tail = causal_conv(xBC, p["conv_w"], p["conv_b"], init_conv)
    xs = xBC[..., :d_in].reshape(b, seq, n_heads, s.head_dim)
    B = xBC[..., d_in:d_in + gn].reshape(b, seq, s.n_groups, s.d_state)
    C = xBC[..., d_in + gn:].reshape(b, seq, s.n_groups, s.d_state)
    # jax.nn.softplus is logaddexp(x, 0); torch's returns x itself above 20,
    # where log1p(exp(-x)) < 2.1e-9 is below half a float32 ulp of x: equal.
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if use_kernel:
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        y, state = ssd_ops.ssd_scan(xs, dt, A, B, C, chunk=s.chunk, init_state=init_state)
    else:
        y, state = ssd_chunked(xs, dt, A, B, C, chunk=min(s.chunk, seq),
                               init_state=init_state)
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, seq, d_in) * F.silu(z)
    out = y.to(dtype) @ p["w_out"].to(dtype)
    return out, {"conv": conv_tail, "state": state}


def ssm_decode(p, x: torch.Tensor, cfg: ModelConfig,
               conv_state: torch.Tensor, ssm_state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. x: (b, 1, d). Returns (y, new_conv, new_ssm)."""
    s = cfg.ssm
    d_in, n_heads, conv_dim = ssm_dims(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    b = x.shape[0]
    gn = s.n_groups * s.d_state

    z, xBC, dt = _split_proj(p, x, cfg)
    window = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)             # (b, k, c)
    k = p["conv_w"].shape[0]
    y_conv = sum(window[:, i] * p["conv_w"][i].to(xBC.dtype) for i in range(k))
    y_conv = F.silu(y_conv + p["conv_b"].to(xBC.dtype))                    # (b, c)
    new_conv = window[:, 1:]

    xs = y_conv[:, :d_in].reshape(b, n_heads, s.head_dim)
    B = y_conv[:, d_in:d_in + gn].reshape(b, s.n_groups, s.d_state)
    C = y_conv[:, d_in + gn:].reshape(b, s.n_groups, s.d_state)
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    y, new_state = ssd_decode_step(ssm_state, xs, dt1, A, B, C)
    y = y + xs * p["D"].to(y.dtype)[None, :, None]
    y = y.reshape(b, d_in) * F.silu(z[:, 0])
    out = y.to(dtype) @ p["w_out"].to(dtype)
    return out[:, None], new_conv, new_state
