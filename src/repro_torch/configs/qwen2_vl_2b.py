"""Qwen2-VL 2B — M-RoPE, dynamic resolution; vision tower is a stub [arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig, VLMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
        d_ff=8960, vocab_size=151936,
        norm="rmsnorm", activation="swiglu", rope_theta=1000000.0,
        use_bias=False,
        vlm=VLMConfig(n_vision_tokens=1024, mrope_sections=(16, 24, 24)),
    )
