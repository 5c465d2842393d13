"""Yi-34B — deep llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
        d_ff=20480, vocab_size=64000,
        norm="rmsnorm", activation="swiglu", rope_theta=5000000.0,
    )
