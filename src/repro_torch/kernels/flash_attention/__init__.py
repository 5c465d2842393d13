from .ops import flash_attention
from .ref import attention_reference

__all__ = ["flash_attention", "attention_reference"]
