"""Plain reference of a decoder of multi-head latent attention and
shared + routed expert layers (DeepSeek-V2-Lite's shape): RMSNorm; MLA with
the query as one product (no compression), the kv latent through its own
RMSNorm, the rope dims rotated under YaRN and the softmax scale it implies,
exact causal attention with float32 scores; the leading
dense SwiGLU layers; a softmax router with top-k gates that are not
renormalised and the Switch load-balance loss, GShard capacity dispatch in
token-major order with drops, SwiGLU routed experts and the shared experts
(one SwiGLU MLP of ``n_shared * d_ff_shared``) on every token; the head and
the cross-entropy.

YaRN follows DeepSeek-V2's published modelling code: each rotary frequency
is blended between its original and its value over ``factor`` by a linear
ramp over the rotary indices that ``beta_fast`` and ``beta_slow`` rotations
over ``original_max_positions`` bound (``yarn_find_correction_range``);
cos and sin are multiplied by mscale(factor, mscale) / mscale(factor,
mscale_all_dim), and the softmax scale by mscale(factor, mscale_all_dim)^2,
where mscale(f, m) = 0.1 m ln f + 1. The rope dims rotate as split halves;
DeepSeek's interleaved pairs are the same map on permuted rope columns of
``w_q`` and ``w_kr``, which random weights do not tell apart.

A configuration's ``port`` section gives the sizes (``mla``, ``moe`` and
``rope_scaling`` as the program's nested configs). Parameter paths are the
flat paths of the program's checkpoint: the dense layers under
``segments/prefix/l0/``, the expert layers under ``segments/stack/l0/``,
each leaf with a leading layer axis. :func:`rope_inv_freq`,
:func:`softmax_scale` and :func:`gates` are module globals, looked up at each
call, so that a planted fault can stand in for one of them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import Precision, cross_entropy, embed, head, layer, rmsnorm
from .moe_transformer import NEG_INF, _groups

PREFIX = "segments/prefix/l0/"
STACK = "segments/stack/l0/"


def _mla_spec(pre: str, n: int, m: dict) -> list:
    d, h, a = m["d_model"], m["n_heads"], m["mla"]
    r, nope, rdim, vd = a["kv_lora_rank"], a["qk_nope_dim"], a["qk_rope_dim"], a["v_head_dim"]
    return [
        (pre + "norm1/scale", (n, d), "ones", 1.0, 1),
        (pre + "mix/w_q", (n, d, h * (nope + rdim)), "normal", 1.0, d),
        (pre + "mix/w_dkv", (n, d, r), "normal", 1.0, d),
        (pre + "mix/kv_scale", (n, r), "ones", 1.0, 1),
        (pre + "mix/w_kr", (n, d, rdim), "normal", 1.0, d),
        (pre + "mix/w_uk", (n, r, h * nope), "normal", 1.0, r),
        (pre + "mix/w_uv", (n, r, h * vd), "normal", 1.0, r),
        (pre + "mix/w_o", (n, h * vd, d), "normal", 1.0, h * vd),
        (pre + "norm2/scale", (n, d), "ones", 1.0, 1),
    ]


def _swiglu_spec(pre: str, lead: tuple, d: int, ff: int) -> list:
    return [(pre + "wi", lead + (d, ff), "normal", 1.0, d),
            (pre + "wg", lead + (d, ff), "normal", 1.0, d),
            (pre + "wo", lead + (ff, d), "normal", 1.0, ff)]


def param_spec(m: dict) -> List[Tuple[str, tuple, str, float, int]]:
    """(path, shape, init, scale, fan_in) of every leaf, in the order the
    benchmark draws them. ``normal`` leaves are N(0, (scale / sqrt(fan_in))^2),
    ``embed`` ones N(0, scale^2)."""
    d, v, mo = m["d_model"], m["vocab_size"], m["moe"]
    n_dense = mo["first_k_dense"]
    n_moe = m["n_layers"] - n_dense
    if n_dense < 1 or n_moe < 1:
        raise ValueError("the reference takes one or more dense layers, then expert layers")
    e = mo["n_experts"]
    return [
        ("tok/table", (v, d), "embed", 0.02, 1),
        ("tok/head", (d, v), "normal", 1.0, d),
        ("norm_f/scale", (d,), "ones", 1.0, 1),
        *_mla_spec(PREFIX, n_dense, m),
        *_swiglu_spec(PREFIX + "mlp/", (n_dense,), d, m["d_ff"]),
        *_mla_spec(STACK, n_moe, m),
        (STACK + "mlp/router", (n_moe, d, e), "normal", 0.02, d),
        *_swiglu_spec(STACK + "mlp/", (n_moe, e), d, mo["d_ff_expert"]),
        *_swiglu_spec(STACK + "mlp/shared/", (n_moe,), d, mo["n_shared"] * mo["d_ff_shared"]),
    ]


# --------------------------------------------------------------------------- #
# YaRN
# --------------------------------------------------------------------------- #
def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_inv_freq(dim: int, theta: float, rs: Optional[dict], device) -> torch.Tensor:
    """The ``dim / 2`` inverse frequencies, blended under YaRN (``rs``)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / theta ** exps
    if rs is None:
        return freq_extra
    freq_inter = 1.0 / (rs["factor"] * theta ** exps)

    def index(rotations):
        return (dim * math.log(rs["original_max_positions"] / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(index(rs["beta_fast"])), 0)
    high = min(math.ceil(index(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    return freq_inter * ramp + freq_extra * (1 - ramp)


def softmax_scale(a: dict, rs: Optional[dict]) -> float:
    scale = (a["qk_nope_dim"] + a["qk_rope_dim"]) ** -0.5
    if rs is not None and rs["mscale_all_dim"]:
        scale *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return scale


def rope(x: torch.Tensor, positions: torch.Tensor, inv: torch.Tensor,
         gain: float) -> torch.Tensor:
    """Split-half rotation by ``inv`` in float32, cos and sin times
    ``gain``, returned in x's dtype. x: (b, s, h, d); positions: (b, s)."""
    ang = positions.float()[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    if gain != 1.0:
        cos, sin = cos * gain, sin * gain
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #
def attention(q, k, v, scale: float, lp: Precision) -> torch.Tensor:
    """Causal attention over the whole sequence at once (training keeps every
    score for the backward, so blocks of queries would save nothing): float32
    scores of the bfloat16 q and k times ``scale``, float32 softmax, the
    weights rounded to bfloat16 before their product with v. The products
    are laid out as the program's (heads split into kv heads and repeats of
    one), so that both run the same GEMMs. q, k: (b, s, h, dqk); v: (b, s, h, dv)."""
    b, s, h, d = q.shape
    qf = q.reshape(b, s, h, 1, d).float()
    scores = torch.einsum("bqkrd,btkd->bkrqt", qf, k.float()) * scale
    idx = torch.arange(s, device=q.device)
    scores = torch.where(idx[:, None] >= idx[None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkrqt,btkd->bqkrd", lp(w), v)
    return o.contiguous().reshape(b, s, h, v.shape[-1])


def mla(p, x: torch.Tensor, m: dict, pos: torch.Tensor, lp: Precision) -> torch.Tensor:
    """Multi-head latent attention, reconstructing K and V from the latent.
    x: the normed (b, s, d) input in bfloat16."""
    b, s, _ = x.shape
    h, a, rs = m["n_heads"], m["mla"], m.get("rope_scaling")
    nope, rdim = a["qk_nope_dim"], a["qk_rope_dim"]
    inv = rope_inv_freq(rdim, m["rope_theta"], rs, x.device)
    gain = 1.0 if rs is None else (_mscale(rs["factor"], rs["mscale"])
                                   / _mscale(rs["factor"], rs["mscale_all_dim"]))
    hx = lp(x)
    q = (hx @ lp(p["mix/w_q"])).reshape(b, s, h, nope + rdim)
    q_pe = rope(q[..., nope:], pos, inv, gain)
    k_pe = rope((hx @ lp(p["mix/w_kr"]))[:, :, None, :], pos, inv, gain)
    # the kv latent's RMSNorm: normalised in float32, rounded, then scaled
    c = (hx @ lp(p["mix/w_dkv"])).float()
    ckv = (c * torch.rsqrt(torch.mean(c * c, dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
    ckv = lp(ckv * lp(p["mix/kv_scale"]))
    k_nope = (ckv @ lp(p["mix/w_uk"])).reshape(b, s, h, nope)
    v = (ckv @ lp(p["mix/w_uv"])).reshape(b, s, h, a["v_head_dim"])
    qq = torch.cat([q[..., :nope], q_pe], dim=-1)
    kk = torch.cat([k_nope, k_pe.expand(b, s, h, rdim)], dim=-1)
    o = attention(lp(qq), lp(kk), lp(v), softmax_scale(a, rs), lp)
    return lp(o.reshape(b, s, -1)) @ lp(p["mix/w_o"])


def swiglu(p, x: torch.Tensor, lp: Precision) -> torch.Tensor:
    hx = lp(x)
    return lp(F.silu(hx @ lp(p["wg"])) * (hx @ lp(p["wi"]))) @ lp(p["wo"])


def gates(probs: torch.Tensor, k: int, norm: bool):
    """The top-k experts and their gates: the softmax probabilities, or
    those renormalised to sum to 1 where ``norm``."""
    gate, idx = torch.topk(probs, k, dim=-1)
    if norm:
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    return gate, idx


def moe(p, x: torch.Tensor, mo: dict, lp: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer: router, capacity dispatch, routed experts, weighted
    combine, plus the shared experts on every token. Returns (y, load-balance
    loss)."""
    b, s, d = x.shape
    e, k = mo["n_experts"], mo["top_k"]
    x = x.to(torch.bfloat16)
    probs = torch.softmax(x.float() @ p["mlp/router"].float(), dim=-1)
    gate, idx = gates(probs, k, mo["norm_topk_prob"])
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
    y = (picked * w).reshape(n, g_len, k, d).sum(dim=2).reshape(b, s, d)
    shared = {name: p[f"mlp/shared/{name}"] for name in ("wi", "wg", "wo")}
    return y + swiglu(shared, x, lp), aux


def forward(params: Dict[str, torch.Tensor], m: dict, tokens: torch.Tensor,
            lp: Precision) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (b, s, vocab), summed load-balance loss)."""
    b, s = tokens.shape
    eps, mo = m["norm_eps"], m["moe"]
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = embed(params["tok/table"], tokens, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_dense = mo["first_k_dense"]
    for i in range(m["n_layers"]):
        p = layer(params, PREFIX, i) if i < n_dense else layer(params, STACK, i - n_dense)
        x = x + mla(p, rmsnorm(x, p["norm1/scale"], eps), m, pos, lp)
        h = rmsnorm(x, p["norm2/scale"], eps)
        if i < n_dense:
            x = x + swiglu({name: p[f"mlp/{name}"] for name in ("wi", "wg", "wo")}, h, lp)
        else:
            y, a = moe(p, h, mo, lp)
            x = x + y
            aux = aux + a
    x = rmsnorm(x, params["norm_f/scale"], eps)
    return head(x, params["tok/head"], lp), aux


def loss(params, m: dict, batch: Dict[str, torch.Tensor], lp: Precision) -> torch.Tensor:
    logits, aux = forward(params, m, batch["tokens"], lp)
    return cross_entropy(logits, batch["labels"]) + m["moe"]["aux_loss_weight"] * aux
