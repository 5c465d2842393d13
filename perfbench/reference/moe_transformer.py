"""Plain reference of a decoder of attention + mixture-of-experts layers
(OLMoE's shape): RMSNorm, multi-head attention with RoPE (q, k and v from
one product with the three projections side by side), exact causal
attention over query blocks with float32 scores, a softmax router with top-k
renormalised gates and the Switch load-balance loss, GShard capacity
dispatch in token-major order with drops, SwiGLU experts, the head and the
cross-entropy.

A configuration's ``port`` section gives the sizes. Parameter paths are the
flat paths of the program's checkpoint (``segments/stack/l0/mix/wq``, with a
leading layer axis), so that both sides take one flat dict of weights.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import Precision, cross_entropy, embed, head, layer, rmsnorm, rope

NEG_INF = -1e30
L0 = "segments/stack/l0/"


def param_spec(m: dict) -> List[Tuple[str, tuple, str, float, int]]:
    """(path, shape, init, scale, fan_in) of every leaf, in the order the
    benchmark draws them. ``normal`` leaves are N(0, (scale / sqrt(fan_in))^2),
    ``embed`` ones N(0, scale^2)."""
    d, h, dh, n = m["d_model"], m["n_heads"], m["d_head"], m["n_layers"]
    kh, v = m["n_kv_heads"], m["vocab_size"]
    e, ff = m["moe"]["n_experts"], m["moe"]["d_ff_expert"]
    return [
        ("tok/table", (v, d), "embed", 0.02, 1),
        ("tok/head", (d, v), "normal", 1.0, d),
        ("norm_f/scale", (d,), "ones", 1.0, 1),
        (L0 + "norm1/scale", (n, d), "ones", 1.0, 1),
        (L0 + "mix/wq", (n, d, h * dh), "normal", 1.0, d),
        (L0 + "mix/wk", (n, d, kh * dh), "normal", 1.0, d),
        (L0 + "mix/wv", (n, d, kh * dh), "normal", 1.0, d),
        (L0 + "mix/wo", (n, h * dh, d), "normal", 1.0, h * dh),
        (L0 + "norm2/scale", (n, d), "ones", 1.0, 1),
        (L0 + "mlp/router", (n, d, e), "normal", 0.02, d),
        (L0 + "mlp/wi", (n, e, d, ff), "normal", 1.0, d),
        (L0 + "mlp/wg", (n, e, d, ff), "normal", 1.0, d),
        (L0 + "mlp/wo", (n, e, ff, d), "normal", 1.0, ff),
    ]


def _q_block(s: int) -> int:
    return next(b for b in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1) if s % b == 0 and b <= s)


def attention(q, k, v, lp: Precision) -> torch.Tensor:
    """Causal attention, one query block at a time: float32 scores of the
    bfloat16 q and k, float32 softmax, the weights rounded to bfloat16 before
    their product with v. q: (b, s, h, d); k, v: (b, s, kh, d)."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    rep = h // kh
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    qb_len = _q_block(s)
    qb = q.reshape(b, s // qb_len, qb_len, kh, rep, d)
    kf = k.float()
    t_idx = torch.arange(s, device=q.device)
    outs = []
    for i in range(s // qb_len):
        scores = torch.einsum("bqkrd,btkd->bkrqt", qb[:, i].float(), kf) * scale
        q_idx = i * qb_len + torch.arange(qb_len, device=q.device)
        scores = torch.where(q_idx[:, None] >= t_idx[None, :], scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkrqt,btkd->bqkrd", lp(w), v))
    return torch.stack(outs, dim=1).reshape(b, s, h, v.shape[-1])


def _groups(b: int, s: int) -> int:
    """Sequence chunks per row on one device: a single row of 256 or more
    (even) tokens splits in two, else one group per row."""
    n = 1
    while b * n * 2 <= 2 and s // (n * 2) >= 128 and s % (n * 2) == 0:
        n *= 2
    return n


def moe(p, x: torch.Tensor, mo: dict, lp: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer: router, capacity dispatch, experts, weighted combine.
    Returns (y, load-balance loss)."""
    b, s, d = x.shape
    e, k = mo["n_experts"], mo["top_k"]
    x = x.to(torch.bfloat16)
    probs = torch.softmax(x.float() @ p["mlp/router"].float(), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    counts = (idx.reshape(-1, 1) == torch.arange(e, device=x.device)).sum(dim=0).float()
    share = counts / torch.clamp(counts.sum(), min=1.0)
    aux = e * torch.sum(probs.reshape(-1, e).mean(dim=0) * share)

    n_chunks = _groups(b, s)
    g_len = s // n_chunks
    cap = max(1, int(g_len * k / e * mo["capacity_factor"]))
    n = b * n_chunks
    xg = x.reshape(n, g_len, d)
    flat_e = idx.reshape(n, g_len * k)
    onehot = (flat_e[:, None, :] == torch.arange(e, device=x.device)[None, :, None]).to(torch.int32)
    slot = ((torch.cumsum(onehot, dim=-1, dtype=torch.int32) - 1) * onehot).sum(dim=1)
    keep = slot < cap
    slot = torch.where(keep, slot, cap).long()
    grp = torch.arange(n, device=x.device)[:, None]
    rows = ((grp * e + flat_e) * (cap + 1) + slot).reshape(-1)
    vals = (xg.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)).reshape(-1, d)
    disp = x.new_zeros((n * e * (cap + 1), d)).index_copy(0, rows, vals)
    disp = disp.reshape(n, e, cap + 1, d)[:, :, :cap]

    hi = torch.einsum("necd,edf->necf", lp(disp), lp(p["mlp/wi"]))
    hg = torch.einsum("necd,edf->necf", lp(disp), lp(p["mlp/wg"]))
    out = torch.einsum("necf,efd->necd", lp(F.silu(hg) * hi), lp(p["mlp/wo"]))

    rows = ((grp * e + flat_e) * cap + torch.clamp(slot, max=cap - 1)).reshape(-1)
    picked = out.reshape(-1, d).index_select(0, rows).reshape(n, g_len * k, d)
    w = (gate.reshape(n, g_len * k) * keep.to(gate.dtype))[..., None].to(out.dtype)
    y = (picked * w).reshape(n, g_len, k, d).sum(dim=2)
    return y.reshape(b, s, d), aux


def forward(params: Dict[str, torch.Tensor], m: dict, tokens: torch.Tensor,
            lp: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (b, s, vocab), summed load-balance loss)."""
    b, s = tokens.shape
    h, kh, dh, eps = m["n_heads"], m["n_kv_heads"], m["d_head"], m["norm_eps"]
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = embed(params["tok/table"], tokens, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(m["n_layers"]):
        p = layer(params, L0, i)
        hx = lp(rmsnorm(x, p["norm1/scale"], eps))
        # one product with the three projections side by side
        qkv = hx @ torch.cat([lp(p["mix/wq"]), lp(p["mix/wk"]), lp(p["mix/wv"])], dim=-1)
        q, k, v = torch.split(qkv, [h * dh, kh * dh, kh * dh], dim=-1)
        q = rope(q.reshape(b, s, h, dh), pos, m["rope_theta"])
        k = rope(k.reshape(b, s, kh, dh), pos, m["rope_theta"])
        v = v.reshape(b, s, kh, dh)
        o = attention(lp(q), lp(k), lp(v), lp)
        x = x + lp(o.reshape(b, s, h * dh)) @ lp(p["mix/wo"])
        y, a = moe(p, rmsnorm(x, p["norm2/scale"], eps), m["moe"], lp)
        x = x + y
        aux = aux + a
    x = rmsnorm(x, params["norm_f/scale"], eps)
    return head(x, params["tok/head"], lp), aux


def loss(params, m: dict, batch: Dict[str, torch.Tensor], lp: Precision) -> torch.Tensor:
    logits, aux = forward(params, m, batch["tokens"], lp)
    return cross_entropy(logits, batch["labels"]) + m["moe"]["aux_loss_weight"] * aux
