"""Delta compression: int8 quantization with error feedback (port of
``repro.optim.compression``).

DiLoCo's outer step (``train.trainer``) compresses each parameter's delta
to int8 with one f32 scale a tensor; error feedback carries the
quantization residual into the next exchange, so the compression is
unbiased over time. The arithmetic is the JAX package's: ``scale =
max(max |x|, 1e-12) / 127``, ``round(x / scale)`` (a division, rounding
half to even as ``jnp.round`` does), clipped to +-127.

With no process group (``axis_name=None``) the mean is local: each tensor
is its own dequantized int8 image, as in the reference's local path. The
collective path (an int8 all-reduce over pods) comes with the multi-device
slice and raises here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q int8, scale 0-d f32)."""
    x = x.float()
    amax = torch.linalg.vector_norm(x, ord=float("inf"))  # max |x|
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.div(x, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float().mul_(scale)


def compress_with_feedback(x: torch.Tensor, err: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Quantize (x + err): (q, scale, new error = target - dequantized)."""
    target = x.float() + err
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def psum_compressed_tree(tree: Tensors, err_tree: Tensors,
                         axis_name: Optional[str] = None
                         ) -> Tuple[Tensors, Tensors]:
    """Compressed mean with error feedback, tensor by tensor: (mean f32,
    new error), both keyed like ``tree``. Only the local path
    (``axis_name=None``) is ported."""
    if axis_name is not None:
        raise NotImplementedError(
            f"a compressed mean over {axis_name!r} needs a process group: "
            f"the multi-device slice is not ported; pass axis_name=None")
    mean, new_err = {}, {}
    for name, x in tree.items():
        q, scale, new_err[name] = compress_with_feedback(x, err_tree[name])
        mean[name] = dequantize_int8(q, scale)
    return mean, new_err


def compression_ratio(tree: Tensors) -> float:
    """Bytes(int8 + scale) / bytes(f32) for reporting."""
    total = sum(x.numel() * 4 for x in tree.values())
    comp = sum(x.numel() + 4 for x in tree.values())
    return comp / max(total, 1)
