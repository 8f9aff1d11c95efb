"""The junction primitive ``csd_matmul`` (forward only, port of
``repro.kernels.ops.csd_matmul``).

It flattens the leading dims of ``x`` to M and dispatches on the device of
the tensor: a CPU tensor runs the plain slot-wise sweep, a CUDA tensor the
hand-written kernel, and any other device raises. There is no backend
option, no tuning, sharding or quantization; the backward pass arrives with
the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import csd_spmm
from .csd_spmm import apply_activation  # noqa: F401 — one definition for layers


def csd_matmul(x: torch.Tensor, w: torch.Tensor, block_idx: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None) -> torch.Tensor:
    """(..., n_in) -> (..., n_out): ``activation(x @ W_sparse + bias)``
    with the epilogue fused, ``w`` the (n_rb, d_in_b, bL, bR) slab and
    ``block_idx`` its (n_rb, d_in_b) int32 pattern on the device of ``x``."""
    if activation is not None and activation not in csd_spmm.ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation!r}")
    xf = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        y = csd_spmm.csd_spmm_fwd_cuda(xf.contiguous(), w, block_idx,
                                       bias=bias, activation=activation)
    elif x.device.type == "cpu":
        y = csd_spmm.csd_spmm_fwd_plain(xf, w, block_idx, bias=bias,
                                        activation=activation)
    else:
        raise ValueError(f"csd_matmul: no implementation for {x.device}")
    return y.reshape(x.shape[:-1] + (y.shape[-1],))
