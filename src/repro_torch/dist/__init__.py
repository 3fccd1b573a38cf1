"""Distribution layer of the port: the logical-axis rules and
``constrain`` (``dist/logical.py``) and gradient compression
(``dist/compress.py``)."""

from .compress import (
    ErrorFeedbackCompressor,
    dequantize_int8,
    make_compressor,
    quantize_int8,
)
from .logical import (
    DEFAULT_RULES,
    AxisRules,
    axis_rules,
    constrain,
    current_rules,
    divisible_spec,
)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "axis_rules",
    "constrain",
    "current_rules",
    "divisible_spec",
    "ErrorFeedbackCompressor",
    "dequantize_int8",
    "make_compressor",
    "quantize_int8",
]
