"""Plain reference of a Mamba-2 (state-space duality) stack: RMSNorm, the
input projection into z, x, B, C and dt, the depthwise causal convolution
with SiLU, the chunked SSD scan in float32 (each chunk's own state, the
inter-chunk recurrence in order, the intra-chunk outputs as masked (c x c)
products plus the term from each chunk's starting state), the skip D, the
SiLU(z) gate, the output projection, the head and the cross-entropy.

``prefill`` returns what a prefill pool hands on: the last position's logits
and, per layer, the convolution's tail and the scan's final state.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import Precision, cross_entropy, embed, head, layer, rmsnorm

L0 = "segments/stack/l0/"


def dims(m: dict) -> Tuple[int, int, int]:
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    return d_in, d_in // s["head_dim"], d_in + 2 * s["n_groups"] * s["d_state"]


def param_spec(m: dict) -> List[Tuple[str, tuple, str, float, int]]:
    """(path, shape, init, scale, fan_in) of every leaf (see
    ``moe_transformer.param_spec``); A_log and dt_bias as the published
    layer draws them (``inputs.A_RANGE``, ``inputs.DT_RANGE``)."""
    s, d, n, v = m["ssm"], m["d_model"], m["n_layers"], m["vocab_size"]
    d_in, nh, conv = dims(m)
    w_in = 2 * d_in + 2 * s["n_groups"] * s["d_state"] + nh
    return [
        ("tok/table", (v, d), "embed", 0.02, 1),
        ("tok/head", (d, v), "normal", 1.0, d),
        ("norm_f/scale", (d,), "ones", 1.0, 1),
        (L0 + "norm1/scale", (n, d), "ones", 1.0, 1),
        (L0 + "mix/w_in", (n, d, w_in), "normal", 1.0, d),
        (L0 + "mix/conv_w", (n, s["d_conv"], conv), "normal", 1.0, s["d_conv"]),
        (L0 + "mix/conv_b", (n, conv), "zeros", 1.0, 1),
        (L0 + "mix/A_log", (n, nh), "a_log", 1.0, 1),
        (L0 + "mix/D", (n, nh), "ones", 1.0, 1),
        (L0 + "mix/dt_bias", (n, nh), "dt_bias", 1.0, 1),
        (L0 + "mix/w_out", (n, d_in, d), "normal", 1.0, d_in),
    ]


def ssd(x, dt, A, B, C, chunk: int):
    """The chunked scan from a zero state, in float32.
    x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, g, n).
    Returns (y (b, s, h, p) in x's dtype, final state (b, h, p, n))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep, l, c = h // g, s // chunk, chunk
    f32 = torch.float32
    dA = (dt.to(f32) * A.to(f32)).reshape(b, l, c, h)
    cum = torch.cumsum(dA, dim=2)
    xdt = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, l, c, g, rep, p)
    Bc = B.to(f32).reshape(b, l, c, g, n)
    Cc = C.to(f32).reshape(b, l, c, g, n)
    # each chunk's own state
    ds = torch.exp(cum[:, :, -1:, :] - cum).reshape(b, l, c, g, rep)
    states = torch.einsum("bljgn,bljgr,bljgrp->blgrpn", Bc, ds, xdt).reshape(b, l, h, p, n)
    cum = cum.permute(0, 3, 1, 2).reshape(b, h, s)
    # the inter-chunk recurrence, in order
    decay = torch.exp(cum.reshape(b, h, l, c)[..., -1]).transpose(1, 2)
    cur = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    starts = []
    for i in range(l):
        starts.append(cur)
        cur = cur * decay[:, i, :, None, None] + states[:, i]
    h_in = torch.stack(starts, dim=1)
    # the outputs
    cl = cum.reshape(b, h, l, c).transpose(1, 2).contiguous()
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp(torch.where(mask, cl[..., :, None] - cl[..., None, :], -torch.inf))
    Lm = Lm.reshape(b, l, g, rep, c, c)
    CB = torch.einsum("blign,bljgn->blgij", Cc, Bc)
    y_intra = torch.einsum("blgrij,bljgrp->bligrp", CB[:, :, :, None] * Lm, xdt)
    sdec = torch.exp(cl).permute(0, 1, 3, 2).reshape(b, l, c, g, rep)
    y_inter = torch.einsum("blign,blgrpn,bligr->bligrp", Cc,
                           h_in.reshape(b, l, g, rep, p, n), sdec)
    return (y_intra + y_inter).reshape(b, s, h, p).to(x.dtype), cur


def block(p, x: torch.Tensor, m: dict, lp: Precision):
    """One Mamba-2 mixer. Returns (y, conv tail, final state)."""
    s = m["ssm"]
    d_in, nh, conv = dims(m)
    b, seq, _ = x.shape
    gn = s["n_groups"] * s["d_state"]
    zxbcdt = lp(x) @ lp(p["mix/w_in"])
    z, xBC, dt = zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv], zxbcdt[..., d_in + conv:]
    k = p["mix/conv_w"].shape[0]
    xp = torch.cat([xBC.new_zeros((b, k - 1, conv)), xBC], dim=1)
    y = sum(xp[:, i:i + seq] * p["mix/conv_w"][i].to(xBC.dtype) for i in range(k))
    xBC = F.silu(y + p["mix/conv_b"].to(xBC.dtype))
    tail = xp[:, -(k - 1):]
    xs = xBC[..., :d_in].reshape(b, seq, nh, s["head_dim"])
    B = xBC[..., d_in:d_in + gn].reshape(b, seq, s["n_groups"], s["d_state"])
    C = xBC[..., d_in + gn:].reshape(b, seq, s["n_groups"], s["d_state"])
    dt = F.softplus(dt.float() + p["mix/dt_bias"].float())
    A = -torch.exp(p["mix/A_log"].float())
    y, state = ssd(xs, dt, A, B, C, min(s["chunk"], seq))
    y = y + xs * p["mix/D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, seq, d_in) * F.silu(z)
    return lp(y) @ lp(p["mix/w_out"]), tail, state


def forward(params: Dict[str, torch.Tensor], m: dict, tokens: torch.Tensor,
            lp: Precision, last_only: bool = False):
    """(logits, per-layer conv tails, per-layer final states); with
    ``last_only`` the logits are the last position's, (b, vocab)."""
    eps = m["norm_eps"]
    x = embed(params["tok/table"], tokens, lp)
    tails: List[torch.Tensor] = []
    states: List[torch.Tensor] = []
    for i in range(m["n_layers"]):
        p = layer(params, L0, i)
        y, tail, state = block(p, rmsnorm(x, p["norm1/scale"], eps), m, lp)
        x = x + y
        tails.append(tail)
        states.append(state)
    if last_only:
        x = x[:, -1:]
    logits = head(rmsnorm(x, params["norm_f/scale"], eps), params["tok/head"], lp)
    return (logits[:, -1] if last_only else logits), tails, states


def loss(params, m: dict, batch: Dict[str, torch.Tensor], lp: Precision) -> torch.Tensor:
    logits, _, _ = forward(params, m, batch["tokens"], lp)
    return cross_entropy(logits, batch["labels"])


def prefill(params, m: dict, tokens: torch.Tensor, lp: Precision):
    """(last-position logits (b, vocab), conv tails (L, b, k - 1, conv),
    final states (L, b, h, p, n))."""
    logits, tails, states = forward(params, m, tokens, lp, last_only=True)
    return logits, torch.stack(tails), torch.stack(states)
