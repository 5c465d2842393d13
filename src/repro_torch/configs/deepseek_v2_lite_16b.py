"""DeepSeek-V2-Lite 16B — MLA without query compression, YaRN rope, one dense
layer, then 2 shared + 64 routed top-6 experts with unnormalised gates
[arXiv:2405.04434; huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json].

Port only (``PORT_ARCHS``): the reference registers no such model. The port
departs from the published model in three ways: expert capacity 1.25 per
group with drops (DeepSeek-V2 drops at a device-level capacity of 1.0), a
batch-level Switch balance loss in place of its sequence-level one, and no
device-limited routing (one device).
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig, RopeScaling


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=10944,                      # the dense layer (the first)
        vocab_size=102400,
        norm="rmsnorm", norm_eps=1e-6, activation="swiglu", rope_theta=10000.0,
        rope_scaling=RopeScaling(factor=40.0, original_max_positions=4096, beta_fast=32.0,
                                 beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
        mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared=2, d_ff_shared=1408,
                      first_k_dense=1, every=1, offset=0,
                      capacity_factor=1.25, aux_loss_weight=0.001, impl="shard_map",
                      norm_topk_prob=False),
    )
