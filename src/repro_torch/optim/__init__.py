"""Optimizers of the port (``repro.optim``): AdamW written by hand, and
int8 delta compression with error feedback."""
from . import adam  # noqa: F401
from .adam import AdamWConfig, global_norm, lr_at  # noqa: F401
from .compression import (  # noqa: F401
    compress_with_feedback, compression_ratio, dequantize_int8,
    psum_compressed_tree, quantize_int8,
)
