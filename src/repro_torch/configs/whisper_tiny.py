"""Whisper-tiny — enc-dec backbone; conv frontend is a stub [arXiv:2212.04356].

The stub frontend means ``input_specs()`` feeds precomputed 1500-frame
embeddings; positions are sinusoidal (shape-agnostic adaptation of Whisper's
learned embeddings — noted in DESIGN.md).
"""
from repro_torch.models.config import EncDecConfig, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_head=64,
        d_ff=1536, vocab_size=51865,
        norm="layernorm", activation="gelu", use_bias=True,
        pos_embedding="sinusoid",
        encdec=EncDecConfig(n_enc_layers=4, enc_len=1500),
    )
