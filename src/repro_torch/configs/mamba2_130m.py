"""Mamba-2 130M — attention-free SSD [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab_size=50280,
        norm="rmsnorm",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
    )
