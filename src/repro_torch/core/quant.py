"""Per-block symmetric int8 quantization of block-sparse junction slabs
(port of ``repro.core.quant``).

Low-bitwidth weights compose multiplicatively with pre-defined sparsity:
storage drops by ``rho x bits/32``. Weights are quantized once, when the
serving engine loads the model, never during training.

Granularity is one scale per surviving (bL x bR) weight block, the unit
the CSD-SpMM kernels stream, so a slab ``(n_rb, d_in_b, bL, bR)`` has
scales ``(n_rb, d_in_b)`` laid out like its gather pattern. Quantization is
symmetric (zero-preserving, range [-127, 127]): ``scale = max|w_block| /
127`` and ``q = round(w / scale)`` (round half to even, as ``jnp.round``),
so the elementwise error is at most ``scale / 2``. The int8 slab is what
the kernel reads from device memory; it widens each block in registers or
shared memory and applies the scale to the block's partial sum.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn

_QMAX = 127.0


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Inference-path quantization knobs. ``weights`` quantizes every
    block-sparse junction slab to int8 with per-block scales; ``kv`` stores
    the paged KV cache as int8 with per-token scales written at append
    time; ``bits`` is the bitwidth (only 8 is implemented)."""

    weights: bool = True
    kv: bool = True
    bits: int = 8

    def __post_init__(self):
        if self.bits != 8:
            raise ValueError(f"only int8 quantization is implemented "
                             f"(bits={self.bits})")


def quantize_slab(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization over the trailing (bL, bR)
    dims of ``w`` (any leading dims). Returns ``(q int8, scales f32)`` with
    ``scales.shape == w.shape[:-2]``."""
    wf = w.float()
    amax = wf.abs().amax(dim=(-2, -1))
    scales = torch.clamp_min(amax, 1e-12) / _QMAX
    q = torch.clamp(torch.round(wf / scales[..., None, None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scales


def dequantize_slab(q: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_slab`: the tests' oracle. The kernels
    never materialise this full-width slab."""
    return (q.float() * scales[..., None, None]).to(dtype)


def quantize_model(model: nn.Module) -> nn.Module:
    """Quantize every block-sparse junction of ``model`` in place, from its
    weights as they are (the counterpart of ``quantize_tree``: the port has
    no spec tree, so it walks the modules). A sparse ``Linear`` and a
    ``core.sparse_linear.SparseLinear`` in a block mode (the paper MLP's
    junctions) become an int8 ``weight`` with an f32 ``w_scale`` buffer
    (n_rb, d_in_b); each expert slab of an ``MoE`` (``up``, ``gate``,
    ``down`` with a pattern) becomes int8 with an f32 buffer
    ``<name>_scale`` (E, n_rb, d_in_b), the JAX tree's sibling names. Dense
    junctions and junctions already quantized are left as they are.
    Returns ``model``."""
    from ..nn.ffn import MoE
    from ..nn.layers import Linear
    from .sparse_linear import SparseLinear
    for mod in model.modules():
        if ((isinstance(mod, Linear) and mod.is_sparse)
                or (isinstance(mod, SparseLinear)
                    and mod.mode.startswith("block"))) \
                and mod.w_scale is None:
            with torch.no_grad():
                q, scales = quantize_slab(mod.weight)
            mod.weight = nn.Parameter(q, requires_grad=False)
            mod.w_scale = scales
        elif isinstance(mod, MoE):
            for name in ("up", "gate", "down"):
                if getattr(mod, f"{name}_idx") is None \
                        or getattr(mod, f"{name}_scale") is not None:
                    continue
                with torch.no_grad():
                    q, scales = quantize_slab(getattr(mod, name))
                setattr(mod, name, nn.Parameter(q, requires_grad=False))
                setattr(mod, f"{name}_scale", scales)
    return model
