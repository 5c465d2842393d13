"""OLMoE 1B-7B — 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1024, vocab_size=50304,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                      capacity_factor=1.25, impl="shard_map"),
    )
