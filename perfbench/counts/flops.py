"""Model operation and byte counts from a configuration's sizes, and the
chip's published peaks. What the work needs, not what an implementation
runs: no capacity padding, no recomputation, no dropped or doubled products.

Per token, a product with a weight matrix of n parameters is 2n operations
forward and 4n backward (6n in all). Causal attention adds 6 * layers *
seq * (heads * head dim) per trained token (half of the full score and
value products), and the SSD scan its chunked products on the causal half of
each chunk (:func:`ssd_ops`), three times over in training.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def _ssm_dims(m: dict):
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    nh = d_in // s["head_dim"]
    return d_in, nh, 2 * d_in + 2 * s["n_groups"] * s["d_state"] + nh


def matmul_params(m: dict) -> int:
    """Weight parameters one token's forward multiplies by, head included,
    embedding lookup not: the attention projections, the router and the
    top-k experts of an MoE layer, an SSM layer's input and output
    projections."""
    d, n = m["d_model"], m["n_layers"]
    per_layer = 0
    if m.get("ssm"):
        d_in, _nh, w_in = _ssm_dims(m)
        per_layer += d * w_in + d_in * d
    else:
        per_layer += 2 * d * m["n_heads"] * m["d_head"] + 2 * d * m["n_kv_heads"] * m["d_head"]
    if m.get("moe"):
        mo = m["moe"]
        per_layer += d * mo["n_experts"] + mo["top_k"] * 3 * d * mo["d_ff_expert"]
    return n * per_layer + d * m["vocab_size"]


def ssd_ops(b: int, s: int, nh: int, p: int, g: int, n: int, chunk: int) -> int:
    """Operations of one forward SSD scan: C.B^T per group and its product
    with x dt on the causal half of each chunk, the chunk states and the
    inter-chunk term (2 per multiply-add)."""
    c = min(chunk, s)
    pairs = c * (c + 1) // 2
    return 2 * b * (s // c) * (g * n * pairs + nh * p * pairs + 2 * nh * c * p * n)


def ssd_bytes(b: int, s: int, nh: int, p: int, g: int, n: int, elt: int) -> int:
    """x, B, C read and y written once in their dtype; dt (float32, per
    head), A read once; the float32 final state written once."""
    return (2 * b * s * nh * p + 2 * b * s * g * n) * elt + 4 * (b * s * nh + nh + b * nh * p * n)


def ssd_bound_s(b, s, nh, p, g, n, chunk, elt) -> float:
    """The least time one scan call can take: the larger of its operations
    at the bf16 peak and its bytes at the memory peak."""
    return max(ssd_ops(b, s, nh, p, g, n, chunk) / PEAKS["bf16_flops_s"],
               ssd_bytes(b, s, nh, p, g, n, elt) / PEAKS["hbm_bytes_s"])


def _ssd_per_token(m: dict, seq: int) -> float:
    s = m["ssm"]
    _d_in, nh, _w = _ssm_dims(m)
    return m["n_layers"] * ssd_ops(1, seq, nh, s["head_dim"], s["n_groups"], s["d_state"],
                                   s["chunk"]) / seq


def train_flops_per_token(m: dict, seq: int) -> float:
    """Forward and backward operations per trained token."""
    f = 6 * matmul_params(m)
    if not m.get("ssm"):
        f += 6 * m["n_layers"] * seq * m["n_heads"] * m["d_head"]
    else:
        f += 3 * _ssd_per_token(m, seq)
    return f


def prefill_flops(m: dict, rows: int, seq: int) -> float:
    """Forward operations of one prefill wave whose logits are the last
    position's only: every layer over every token, the head once a row."""
    head = m["d_model"] * m["vocab_size"]
    f = rows * seq * 2 * (matmul_params(m) - head) + rows * 2 * head
    if not m.get("ssm"):
        f += rows * seq * 2 * m["n_layers"] * seq * m["n_heads"] * m["d_head"]
    else:
        f += rows * seq * _ssd_per_token(m, seq)
    return f
