"""DeepSeek-V3 671B — MLA, 1 shared + 256 routed top-8 MoE, MTP [arXiv:2412.19437]."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=128,
        d_ff=18432,                      # dense layers (first 3)
        vocab_size=129280,
        norm="rmsnorm", activation="swiglu", rope_theta=10000.0,
        mtp_depth=1,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                      n_shared=1, d_ff_shared=2048,
                      first_k_dense=3, every=1, offset=0,
                      capacity_factor=1.25, impl="shard_map"),
    )
