"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, 16-expert MoE [arXiv:2403.19887]."""
from repro_torch.models.config import HybridConfig, ModelConfig, MoEConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=65536,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        hybrid=HybridConfig(attn_period=8, attn_offset=4),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336,
                      every=2, offset=1, capacity_factor=1.25, impl="shard_map"),
    )
