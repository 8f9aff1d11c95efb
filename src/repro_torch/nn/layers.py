"""Primitive layers (port of ``repro.nn.layers``): ``Linear`` (dense or
pre-defined block-sparse), ``RMSNorm``, ``Embedding``, rotary embeddings and
the activation registry.

Every module takes the ``device`` and parameter ``dtype`` it is built on and
a ``torch.Generator`` for its random init; the init distributions are the
JAX package's, the numbers are not (tests move the JAX parameters over with
``repro_torch.convert``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.block_pattern import BlockPattern, fit_block_pattern
from ..kernels.ops import apply_activation, csd_matmul
from .common import SparsityConfig


def _normal(shape, std: float, generator, device, dtype) -> nn.Parameter:
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * std
    return nn.Parameter(w.to(dtype))


class Linear(nn.Module):
    """A junction. Dense by default; pre-defined block-sparse when ``rho < 1``
    and the sparsity config admits it. A dense weight is (n_in, n_out); a
    sparse one is the slab (n_rb, d_in_b, bL, bR), with the pattern's
    gather form kept beside it as the int32 buffer ``block_idx`` and its
    scatter form (for the backward pass) as ``out_idx``/``out_slot``.

    ``core.quant.quantize_model`` makes a sparse junction int8 for serving:
    ``weight`` becomes the int8 slab and the buffer ``w_scale`` (n_rb,
    d_in_b) holds its f32 per-block scales (None otherwise). A dtype cast
    of the module (``.to(dtype)``) leaves ``w_scale`` in f32: rounding the
    scales would change every block's dequantized values."""

    def __init__(self, n_in: int, n_out: int, *, bias: bool = False,
                 rho: float = 1.0, sp: Optional[SparsityConfig] = None,
                 seed: int = 0, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_in, self.n_out = n_in, n_out
        self.pattern: Optional[BlockPattern] = None
        if sp is not None:
            self.pattern = fit_block_pattern(n_in, n_out, rho, sp, seed=seed)
        if self.pattern is not None:
            bp = self.pattern
            self.weight = _normal(
                (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out),
                math.sqrt(1.0 / (bp.d_in_b * bp.block_in)), generator,
                device, dtype)
            for name in ("block_idx", "out_idx", "out_slot"):
                self.register_buffer(name, torch.as_tensor(
                    getattr(bp, name), dtype=torch.int32, device=device))
        else:
            self.weight = _normal((n_in, n_out), math.sqrt(1.0 / n_in),
                                  generator, device, dtype)
            self.block_idx = self.out_idx = self.out_slot = None
        self.bias = nn.Parameter(torch.zeros(n_out, device=device,
                                             dtype=dtype)) if bias else None
        self.register_buffer("w_scale", None)

    def _apply(self, fn, recurse=True):
        scale = self.w_scale
        out = super()._apply(fn, recurse)
        if scale is not None and self.w_scale.dtype != scale.dtype:
            self.w_scale = scale.to(self.w_scale.device)
        return out

    @property
    def is_sparse(self) -> bool:
        return self.pattern is not None

    def forward(self, x: torch.Tensor,
                activation: Optional[str] = None) -> torch.Tensor:
        """``activation(x @ W + b)``; for a sparse junction the bias and
        activation ride the fused ``csd_matmul`` epilogue. Weight and bias
        are cast to the dtype of x on each call, as in the JAX package, so
        the gradient of a bf16 step flows back into the f32 parameter (the
        serving engine stores them in the compute dtype, where the cast is
        free). An int8 slab enters the int8 forward uncast, with its
        scales."""
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.weight.dtype == torch.int8:
            if self.w_scale is None:
                raise ValueError("an int8 junction weight needs its w_scale")
            return csd_matmul(x, self.weight, self.block_idx, bias=b,
                              activation=activation, w_scale=self.w_scale)
        w = self.weight.to(x.dtype)
        if self.is_sparse:
            return csd_matmul(x, w, self.block_idx, bias=b,
                              activation=activation, out_idx=self.out_idx,
                              out_slot=self.out_slot)
        y = x @ w
        if b is not None:
            y = y + b
        return apply_activation(y, activation)


class RMSNorm(nn.Module):
    """RMS norm computed in f32. Zero-centred by default (gemma style,
    ``1 + scale`` with the scale initialised to zeros), as every norm of the
    JAX package is but the Mamba2 mixer's gated one, which is built with
    ``zero_centered=False``: its scale starts at ones and multiplies."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32,
                 device=None, zero_centered: bool = True):
        super().__init__()
        self.eps = eps
        self.zero_centered = zero_centered
        init = torch.zeros if zero_centered else torch.ones
        self.scale = nn.Parameter(init(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + self.eps)
        scale = self.scale.float()
        if self.zero_centered:
            scale = 1.0 + scale
        return (xf * scale).to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.table = _normal((vocab, dim), 1.0 / math.sqrt(dim), generator,
                             device, dtype)

    def forward(self, tokens: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Rows of the table, looked up in ``dtype`` (the compute dtype in
        training, as the JAX package casts the table before the lookup)."""
        table = self.table if dtype is None else self.table.to(dtype)
        return F.embedding(tokens, table)

    def attend(self, h: torch.Tensor) -> torch.Tensor:
        """Tied output head: h @ table^T -> logits, in the dtype of h."""
        return h @ self.table.to(h.dtype).T


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs    # (..., S, Dh/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    """The registry: jax.nn.gelu defaults to the tanh approximation, so
    "gelu" and "gelu_tanh" name the same function."""
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu,
            "gelu_tanh": _gelu_tanh}[name]
