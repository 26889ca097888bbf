from .flash_attention import (
    FlashAttention,
    flash_attention,
    flash_backward_plain,
    flash_forward_plain,
)
from .quantize import (
    GROUP,
    dequantize_int8,
    quantize_int8,
    quantize_int8_many,
    quantize_int8_many_plain,
    quantize_int8_plain,
)

__all__ = [
    "GROUP", "quantize_int8", "quantize_int8_plain", "quantize_int8_many",
    "quantize_int8_many_plain", "dequantize_int8",
    "FlashAttention", "flash_attention", "flash_forward_plain", "flash_backward_plain",
]
