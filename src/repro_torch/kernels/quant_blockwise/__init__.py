from .ops import (dequantize_blockwise, dequantize_blockwise_2d, quantize_blockwise,
                  quantize_blockwise_2d)
from .ref import dequantize_reference, quantize_reference

__all__ = ["quantize_blockwise", "dequantize_blockwise", "quantize_blockwise_2d",
           "dequantize_blockwise_2d", "quantize_reference", "dequantize_reference"]
