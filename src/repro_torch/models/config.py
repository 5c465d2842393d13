"""Model configuration, copied from the reference ``repro.models.config``.

A single :class:`ModelConfig` dataclass describes every architecture family the
reference supports. The port keeps its own copy (it imports nothing of
``repro``), field for field, with the same ``reduced()``, ``n_params()`` and
``n_active_params()``; ``tests/test_torch_models.py`` holds the two equal.
Which families the port can run yet is decided in ``repro_torch.models.blocks``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard-style capacity dispatch)."""

    n_experts: int = 0                 # routed experts; 0 = dense model
    top_k: int = 2
    d_ff_expert: int = 0               # hidden size of each routed expert
    n_shared: int = 0                  # always-on shared experts (DeepSeek)
    d_ff_shared: int = 0               # hidden size of the shared expert(s)
    first_k_dense: int = 0             # leading dense layers (DeepSeek: 3)
    every: int = 1                     # MoE replaces MLP every `every` layers
    offset: int = 0                    # first MoE layer index within a period
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # 'scatter'  — capacity-based scatter dispatch (production; EP-shardable)
    # 'dense'    — compute all experts, weight by gate (tiny smoke configs only)
    impl: str = "scatter"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) settings."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256                   # SSD chunk length


@dataclass(frozen=True)
class HybridConfig:
    """Attention/SSM interleave (Jamba)."""

    attn_period: int = 8               # one attention layer per period
    attn_offset: int = 4               # index of the attention layer in a period


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (Whisper backbone; conv frontend is a stub)."""

    n_enc_layers: int = 4
    enc_len: int = 1500                # precomputed frame embeddings (stub)


@dataclass(frozen=True)
class VLMConfig:
    """VLM backbone (Qwen2-VL); the vision tower is a stub."""

    n_vision_tokens: int = 1024        # precomputed patch embeddings per sample
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w rope sections


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_head: int = 64
    d_ff: int = 256
    vocab_size: int = 256

    norm: str = "rmsnorm"              # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-5
    activation: str = "swiglu"         # swiglu | gelu
    use_bias: bool = False
    tie_embeddings: bool = False

    pos_embedding: str = "rope"         # rope | sinusoid (whisper)
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0  # phi-4-mini: 0.75
    mtp_depth: int = 0                  # DeepSeek multi-token-prediction depth

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None

    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # how many trailing layers stay un-scanned (0 = scan everything scannable)
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"          # full | dots | none

    # ------------------------------------------------------------------ #
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_quadratic(self) -> bool:
        """True when full O(L^2) attention dominates (long_500k is skipped)."""
        return self.family not in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decode step (whisper is enc-dec)

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            assert self.hybrid is not None
            return "attn" if i % self.hybrid.attn_period == self.hybrid.attn_offset else "ssm"
        return "attn"

    def mlp_kind(self, i: int) -> str:
        """'dense' or 'moe' for decoder layer i."""
        if self.moe is None or self.moe.n_experts == 0:
            return "dense"
        if i < self.moe.first_k_dense:
            return "dense"
        return "moe" if (i % self.moe.every) == self.moe.offset else "dense"

    def n_params(self) -> int:
        """Analytic parameter count (embedding + decoder stack [+ encoder])."""
        d, v = self.d_model, self.vocab_size
        total = v * d                       # input embedding
        if not self.tie_embeddings:
            total += v * d                  # output head
        total += self._stack_params(self.n_layers, decoder=True)
        if self.family == "encdec":
            assert self.encdec is not None
            total += self._stack_params(self.encdec.n_enc_layers, decoder=False)
        if self.mtp_depth > 0:
            # per MTP depth: 1 extra layer + combine projection
            total += self.mtp_depth * (self._layer_params(self.n_layers - 1) + 2 * d * d)
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameter count — differs for MoE."""
        if self.moe is None or self.moe.n_experts == 0:
            return self.n_params()
        total = self.n_params()
        moe_layers = sum(1 for i in range(self.n_layers) if self.mlp_kind(i) == "moe")
        expert_p = self._ffn_params(self.moe.d_ff_expert)
        inactive = moe_layers * (self.moe.n_experts - self.moe.top_k) * expert_p
        return total - inactive

    # -- helpers -------------------------------------------------------- #
    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.activation == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla is not None:
            m = self.mla
            qk_dim = m.qk_nope_dim + m.qk_rope_dim
            p = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_dim
            p += d * (m.kv_lora_rank + m.qk_rope_dim)
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            p += self.n_heads * m.v_head_dim * d
            return p
        q = d * self.n_heads * self.d_head
        kv = 2 * d * self.n_kv_heads * self.d_head
        o = self.n_heads * self.d_head * d
        return q + kv + o

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        s = self.ssm
        d_in = s.expand * self.d_model
        n_heads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        p = self.d_model * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
        p += conv_dim * s.d_conv                                             # conv
        p += n_heads * 2 + n_heads                                           # A, D, dt_bias
        p += d_in * self.d_model                                             # out_proj
        return p

    def _layer_params(self, i: int) -> int:
        mix = self._ssm_params() if self.layer_kind(i) == "ssm" else self._attn_params()
        if self.mlp_kind(i) == "moe":
            assert self.moe is not None
            ffn = self.moe.n_experts * self._ffn_params(self.moe.d_ff_expert)
            ffn += self.moe.n_shared * self._ffn_params(self.moe.d_ff_shared)
            ffn += self.d_model * self.moe.n_experts  # router
        else:
            ffn = self._ffn_params(self.d_ff)
        norms = 2 * self.d_model if self.norm != "nonparam_ln" else 0
        return mix + ffn + norms

    def _stack_params(self, n_layers: int, decoder: bool) -> int:
        total = sum(self._layer_params(i) for i in range(n_layers))
        if self.family == "encdec" and decoder:
            total += n_layers * (self._attn_params() + (self.d_model if self.norm != "nonparam_ln" else 0))
        return total

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.family in ("hybrid", "moe") else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128,
            vocab_size=128,
            scan_layers=False,
            remat=False,
        )
        if self.family == "hybrid":
            kw["n_layers"] = 4
            kw["hybrid"] = HybridConfig(attn_period=2, attn_offset=1)
        if self.moe is not None and self.moe.n_experts > 0:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                d_ff_shared=64 if self.moe.n_shared else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
                impl="dense")
            kw["n_layers"] = 4 if self.moe.first_k_dense else kw["n_layers"]
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.encdec is not None:
            kw["encdec"] = EncDecConfig(n_enc_layers=2, enc_len=32)
        if self.vlm is not None:
            kw["vlm"] = VLMConfig(n_vision_tokens=8, mrope_sections=(2, 3, 3))
        if self.mtp_depth:
            kw["mtp_depth"] = 1
        return dataclasses.replace(self, **kw)
