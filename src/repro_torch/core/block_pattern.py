"""Block-level pre-defined sparsity (port of ``repro.core.block_pattern``).

The paper's clash-free generators (``core.sparsity``) operate on neurons;
lifting them to (bL x bR) blocks keeps the whole pattern family and makes
every surviving "edge" a dense tile that a matrix unit consumes whole.

``BlockPattern`` carries both adjacency directions:

* ``block_idx[rb, f]`` — left block feeding fan-in slot ``f`` of right block
  ``rb`` (gather form, what the forward kernel reads);
* ``out_idx[lb, g], out_slot[lb, g]`` — the (right block, fan-in slot)
  pairs fed by left block ``lb`` (scatter form, for the backward pass).

Partitioning across devices (``partition_pattern``, ``split_slab``) and the
tuning and lint hooks of the JAX package are not part of this module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import sparsity


@dataclasses.dataclass(frozen=True)
class BlockPattern:
    """Pre-defined block-sparse pattern for an (n_in x n_out) junction."""

    n_in: int
    n_out: int
    block_in: int   # bL
    block_out: int  # bR
    block_idx: np.ndarray  # (n_rb, d_in_b) int32 — gather form
    out_idx: np.ndarray    # (n_lb, d_out_b) int32 — scatter form: right block
    out_slot: np.ndarray   # (n_lb, d_out_b) int32 — scatter form: fan-in slot
    meta: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def n_lb(self) -> int:
        return self.n_in // self.block_in

    @property
    def n_rb(self) -> int:
        return self.n_out // self.block_out

    @property
    def d_in_b(self) -> int:
        return int(self.block_idx.shape[1])


def make_block_pattern(
    n_in: int,
    n_out: int,
    rho: float,
    *,
    block_in: int = 128,
    block_out: int = 128,
    method: str = "clashfree",
    seed: int = 0,
    cf_type: int = 1,
    dither: bool = False,
    z: Optional[int] = None,
) -> BlockPattern:
    """Lift the paper's pattern generator to block granularity; density is
    quantized to multiples of ``1/gcd(n_lb, n_rb)`` (paper Appendix A)."""
    if n_in % block_in or n_out % block_out:
        raise ValueError(
            f"block sizes must divide junction dims: ({n_in},{n_out}) vs "
            f"({block_in},{block_out})")
    n_lb, n_rb = n_in // block_in, n_out // block_out
    pat = sparsity.make_pattern(
        n_lb, n_rb, rho, method=method, seed=seed, cf_type=cf_type,
        dither=dither, z=z)
    if pat.method == "random":
        raise ValueError("block mode requires fixed-degree (structured or "
                         "clash-free) patterns")
    ridx = sparsity.transpose_pattern(pat)  # (n_lb, d_out_b, 2)
    return BlockPattern(
        n_in=n_in, n_out=n_out, block_in=block_in, block_out=block_out,
        block_idx=pat.idx.astype(np.int32),
        out_idx=ridx[:, :, 0].astype(np.int32),
        out_slot=ridx[:, :, 1].astype(np.int32),
        meta=dict(pat.meta, method=pat.method, seed=seed),
    )


def shrink_to_divisor(dim: int, block: int) -> int:
    """Largest power-of-two shrink of ``block`` (capped at ``dim``) that
    divides ``dim``."""
    b = min(block, dim)
    while dim % b:
        b //= 2
    return b


def fit_block_pattern(n_in: int, n_out: int, rho: float, sp,
                      seed: int = 0) -> Optional[BlockPattern]:
    """Adapt a ``SparsityConfig``'s block sizes to one junction, or return
    ``None`` if the junction stays dense (sparsity off, ``rho >= 1``, or
    only blocks narrower than 32 divide the junction)."""
    if sp is None or not sp.enabled or rho >= 1.0:
        return None
    bi = shrink_to_divisor(n_in, sp.block_in)
    bo = shrink_to_divisor(n_out, sp.block_out)
    min_b = min(32, sp.block_in, sp.block_out)
    if bi < min_b or bo < min_b:
        return None
    return make_block_pattern(
        n_in, n_out, rho, block_in=bi, block_out=bo, method=sp.method,
        seed=sp.seed + seed, cf_type=sp.cf_type, dither=sp.dither)
