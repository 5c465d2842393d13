"""Model operations of the configurations that ``reference/mla_moe.py``
computes (multi-head latent attention, leading dense layers, then shared and
routed experts), from a configuration's ``port`` section, by the rules of
``counts/flops.py``: what the work needs, not what an implementation runs;
a product with a weight matrix of n parameters is 2n operations a token
forward and 4n backward.

Causal attention adds, per trained token and layer, 3 x seq / 2 x heads x
2 (qk head dim + v head dim): the score and value products over the causal
half of the sequence, three times over in training. (``flops.py`` counts
every attention layer with q, k and v of one head dim and no dense prefix or
shared expert, so it is not this model's count.)
"""
from __future__ import annotations


def matmul_params(m: dict) -> int:
    """Weight parameters one token's forward multiplies by, head included,
    embedding lookup not: every layer's MLA products (the query direct or
    through its compression, the kv latent and rope key, the latent's up
    products, the output), the dense layers' SwiGLU, and each expert layer's
    router, top-k routed experts and shared experts."""
    d, h, a, mo = m["d_model"], m["n_heads"], m["mla"], m["moe"]
    qk = a["qk_nope_dim"] + a["qk_rope_dim"]
    r = a["kv_lora_rank"]
    q = d * a["q_lora_rank"] + a["q_lora_rank"] * h * qk if a["q_lora_rank"] else d * h * qk
    attn = (q + d * (r + a["qk_rope_dim"]) + r * h * (a["qk_nope_dim"] + a["v_head_dim"])
            + h * a["v_head_dim"] * d)
    n_dense = mo["first_k_dense"]
    dense = 3 * d * m["d_ff"]
    expert = (d * mo["n_experts"] + mo["top_k"] * 3 * d * mo["d_ff_expert"]
              + 3 * d * mo["n_shared"] * mo["d_ff_shared"])
    return (m["n_layers"] * attn + n_dense * dense + (m["n_layers"] - n_dense) * expert
            + d * m["vocab_size"])


def train_flops_per_token(m: dict, seq: int) -> float:
    """Forward and backward operations per trained token."""
    a = m["mla"]
    attn = 3 * seq * m["n_heads"] * (a["qk_nope_dim"] + a["qk_rope_dim"] + a["v_head_dim"])
    return 6 * matmul_params(m) + m["n_layers"] * attn
