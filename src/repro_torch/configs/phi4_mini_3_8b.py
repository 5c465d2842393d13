"""Phi-4-mini 3.8B — RoPE (partial) + SwiGLU + GQA, 200k vocab [arXiv:2412.08905]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
        d_ff=8192, vocab_size=200064,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        partial_rotary_factor=0.75, tie_embeddings=True,
    )
