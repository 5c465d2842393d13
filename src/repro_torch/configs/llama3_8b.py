"""Llama-3 8B — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=128256,
        norm="rmsnorm", activation="swiglu", rope_theta=500000.0,
    )
