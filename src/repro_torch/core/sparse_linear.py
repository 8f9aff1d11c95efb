"""Pre-defined sparse linear layers: the paper's junction as a torch module
(port of ``repro.core.sparse_linear``).

Execution modes, one statistical family:

* ``dense``  — a full (n_in, n_out) weight; any mode with ``rho >= 1``
               (except ``gather``) becomes dense.
* ``mask``   — dense weight times a fixed 0/1 mask, ``x @ (w * mask)``:
               the paper's training dynamics exactly (the gradient of a
               masked weight is the masked gradient, eq. (4b) on the
               existing edges) at dense speed. Random patterns, which have
               no fixed degrees, always run here.
* ``gather`` — compact (n_out, d_in) weights and the index pattern
               ``idx[j, f]``, eq. (2a) edge by edge: a gather and an einsum.
* ``block_gather`` / ``block_scatter`` — the block form (``BlockPattern``):
               the slab (n_rb, d_in_b, bL, bR), run through the port's one
               junction primitive ``kernels.ops.csd_matmul`` with the bias
               and activation fused into its epilogue (the hand-written
               kernels on the card, their plain versions on the CPU), in
               its ``dataflow="gather"`` or ``"scatter"``. That choice
               changes the CPU's plain forward only: the JAX package's
               Pallas branch ignores it, and on the card both block modes
               run the same kernels. ``core.quant.quantize_model`` makes a
               block junction int8 for inference (an int8 ``weight`` and
               its per-block f32 scales ``w_scale``).

``dense``, ``mask`` and ``gather`` stay plain torch, as the JAX package
leaves them outside any Pallas kernel. All modes initialise with He scaling
over the actual in-degree (d_in, not n_in), drawn from an explicit
``torch.Generator``; the numbers differ from the JAX package's, so tests
move the JAX parameters over (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

import numpy as np
import torch
import torch.nn as nn

from ..kernels.ops import apply_activation, csd_matmul
from . import sparsity
from .block_pattern import BlockPattern, make_block_pattern

Mode = Literal["mask", "gather", "block_gather", "block_scatter", "dense"]


@dataclasses.dataclass(frozen=True)
class SparseLinearSpec:
    """Static configuration of one sparse junction."""

    n_in: int
    n_out: int
    rho: float = 1.0
    mode: Mode = "block_gather"
    method: str = "clashfree"   # pattern family (clashfree|structured|random)
    block_in: int = 128
    block_out: int = 128
    cf_type: int = 1
    dither: bool = False
    seed: int = 0
    use_bias: bool = True
    dtype: str = "float32"

    def pattern(self) -> sparsity.JunctionPattern:
        return sparsity.make_pattern(
            self.n_in, self.n_out, self.rho, method=self.method,
            seed=self.seed, cf_type=self.cf_type, dither=self.dither)

    def block_pattern(self) -> BlockPattern:
        return make_block_pattern(
            self.n_in, self.n_out, self.rho, block_in=self.block_in,
            block_out=self.block_out, method=self.method, seed=self.seed,
            cf_type=self.cf_type, dither=self.dither)


class SparseLinear(nn.Module):
    """One junction: ``layer = SparseLinear(spec, device=..., generator=g);
    y = layer(x, activation)``. The pattern is fixed when the layer is
    built (numpy), the paper's "pre-defined" property. Parameters:
    ``weight`` ((n_in, n_out) dense and mask, (n_out, d_in) gather, the
    slab in the block modes) and ``bias`` (n_out,). Buffers: the mask
    (``mask``), the index pattern (``idx``, gather) or the block pattern's
    gather and scatter forms (``block_idx``, ``out_idx``, ``out_slot``,
    int32), and ``w_scale``: None, or for an int8 slab its f32 scales
    (n_rb, d_in_b)."""

    def __init__(self, spec: SparseLinearSpec, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        # dense for rho >= 1 in every mode but gather
        if spec.mode == "dense" or (spec.rho >= 1.0 and spec.mode != "gather"):
            self.mode = "dense"
        elif spec.mode in ("mask", "gather", "block_gather", "block_scatter"):
            self.mode = spec.mode
        else:
            raise ValueError(f"unknown mode {spec.mode}")
        dtype = getattr(torch, spec.dtype)
        self.pattern = None
        if self.mode in ("mask", "gather"):
            self.pattern = spec.pattern()
            if self.mode == "gather" and self.pattern.method == "random":
                raise ValueError("gather mode requires fixed degrees")
        elif self.mode != "dense":
            self.pattern = spec.block_pattern()
        if self.mode == "dense":
            shape, fan_in = (spec.n_in, spec.n_out), spec.n_in
        elif self.mode == "mask":
            shape = (spec.n_in, spec.n_out)
            fan_in = max(1, self.pattern.n_edges // spec.n_out)
            self.register_buffer("mask", torch.as_tensor(
                sparsity.to_mask(self.pattern), dtype=dtype, device=device))
        elif self.mode == "gather":
            shape = (spec.n_out, self.pattern.d_in)
            fan_in = self.pattern.d_in
            self.register_buffer("idx", torch.as_tensor(
                self.pattern.idx, dtype=torch.long, device=device))
        else:
            bp: BlockPattern = self.pattern
            shape = (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
            fan_in = bp.d_in_b * bp.block_in
            for name in ("block_idx", "out_idx", "out_slot"):
                self.register_buffer(name, torch.as_tensor(
                    getattr(bp, name), dtype=torch.int32, device=device))
        self.fan_in = fan_in
        self.weight = nn.Parameter(torch.empty(shape, device=device,
                                               dtype=dtype))
        self.weight.data.copy_(self.init_weight(generator))
        self.bias = nn.Parameter(torch.zeros(
            spec.n_out, device=device, dtype=dtype)) if spec.use_bias \
            else None
        self.register_buffer("w_scale", None)

    def init_weight(self, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """A fresh weight: normal with He scaling over the junction's
        actual in-degree ``fan_in``, drawn from ``generator`` in f32."""
        w = self.weight
        return (torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=torch.float32)
                * math.sqrt(2.0 / self.fan_in)).to(w.dtype)

    def forward(self, x: torch.Tensor,
                activation: Optional[str] = None) -> torch.Tensor:
        """``activation(x @ W_sparse + b)``. In the block modes the bias and
        the activation ride the ``csd_matmul`` epilogue (an int8 slab
        enters the int8 forward with its scales); the other modes apply
        them inline."""
        w, b = self.weight, self.bias
        if self.mode in ("block_gather", "block_scatter"):
            return csd_matmul(
                x, w, self.block_idx, bias=b, activation=activation,
                out_idx=self.out_idx, out_slot=self.out_slot,
                w_scale=self.w_scale,
                dataflow="scatter" if self.mode == "block_scatter"
                else "gather")
        if self.mode == "dense":
            y = x @ w
        elif self.mode == "mask":
            y = masked_dense_apply(x, w, self.mask)
        else:
            y = gather_apply(x, w, self.idx)
        if b is not None:
            y = y + b.to(y.dtype)
        return apply_activation(y, activation)

    @property
    def n_weights(self) -> int:
        """Stored weight count: the paper's |W_i| (Table I)."""
        if self.mode == "dense":
            return self.spec.n_in * self.spec.n_out
        if self.mode == "mask":
            return self.pattern.n_edges  # logical; physical storage is dense
        if self.mode == "gather":
            return int(self.pattern.idx.size)
        return self.pattern.n_weight_elems


# ---------------------------------------------------------------------------
# Pure functions
# ---------------------------------------------------------------------------


def gather_apply(x: torch.Tensor, w: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Eq. (2a): h[..., j] = sum_f w[j, f] * x[..., idx[j, f]]; ``idx``
    (n_out, d_in) integer, on the device of x."""
    idx = torch.as_tensor(idx, device=x.device).long()
    xg = torch.index_select(x, -1, idx.reshape(-1))
    xg = xg.reshape(x.shape[:-1] + tuple(idx.shape))
    return torch.einsum("...jf,jf->...j", xg, w)


def masked_dense_apply(x: torch.Tensor, w: torch.Tensor,
                       mask) -> torch.Tensor:
    """Oracle: dense matmul against the masked weight."""
    return x @ (w * torch.as_tensor(mask, dtype=w.dtype, device=w.device))


# ---------------------------------------------------------------------------
# Layout conversions (cross-mode equivalence tests and checkpoints)
# ---------------------------------------------------------------------------


def gather_weights_to_dense(w: torch.Tensor, idx: np.ndarray,
                            n_in: int) -> torch.Tensor:
    """(n_out, d_in) compact weights -> (n_in, n_out) dense-with-zeros."""
    n_out, d_in = idx.shape
    dense = torch.zeros((n_in, n_out), dtype=w.dtype, device=w.device)
    rows = torch.as_tensor(np.asarray(idx).reshape(-1), device=w.device).long()
    cols = torch.arange(n_out, device=w.device).repeat_interleave(d_in)
    return dense.index_put((rows, cols), w.reshape(-1), accumulate=True)


def block_weights_to_dense(w: torch.Tensor, bp: BlockPattern) -> torch.Tensor:
    """(n_rb, d_in_b, bL, bR) -> (n_in, n_out) dense-with-zeros."""
    dense = torch.zeros((bp.n_in, bp.n_out), dtype=w.dtype, device=w.device)
    bl, br = bp.block_in, bp.block_out
    for rb in range(bp.n_rb):
        for f in range(bp.d_in_b):
            lb = int(bp.block_idx[rb, f])
            dense[lb * bl:(lb + 1) * bl, rb * br:(rb + 1) * br] = w[rb, f]
    return dense


def dense_weights_to_gather(w_dense: torch.Tensor,
                            idx: np.ndarray) -> torch.Tensor:
    """(n_in, n_out) -> (n_out, d_in) compact, reading pattern positions."""
    n_out, d_in = idx.shape
    rows = torch.as_tensor(np.asarray(idx).reshape(-1),
                           device=w_dense.device).long()
    cols = torch.arange(n_out, device=w_dense.device).repeat_interleave(d_in)
    return w_dense[rows, cols].reshape(n_out, d_in)
