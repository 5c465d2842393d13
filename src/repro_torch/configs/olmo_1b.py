"""OLMo 1B — dense MHA with non-parametric LayerNorm [arXiv:2402.00838]."""
from repro_torch.models.config import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=8192, vocab_size=50304,
        norm="nonparam_ln", activation="swiglu", rope_theta=10000.0,
        tie_embeddings=True,
    )
