"""Block-level pre-defined sparsity (port of ``repro.core.block_pattern``).

The paper's clash-free generators (``core.sparsity``) operate on neurons;
lifting them to (bL x bR) blocks keeps the whole pattern family and makes
every surviving "edge" a dense tile that a matrix unit consumes whole.

``BlockPattern`` carries both adjacency directions:

* ``block_idx[rb, f]`` — left block feeding fan-in slot ``f`` of right block
  ``rb`` (gather form, what the forward kernel reads);
* ``out_idx[lb, g], out_slot[lb, g]`` — the (right block, fan-in slot)
  pairs fed by left block ``lb`` (scatter form, for the backward pass).

``partition_pattern`` splits a pattern over disjoint output block-row
ranges (the shard-local patterns the multi-device junction will run), and
``debug=True`` (or ``REPRO_PATTERN_DEBUG=1``) certifies a generated pattern
or partition with sparselint's SL3xx checks before it reaches a kernel.
Splitting the slabs across devices (``split_slab``, ``merge_slab``,
``reassemble_outputs``) and the tuning hook of the JAX package are not part
of this module yet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from . import sparsity


def _debug_on(debug: Optional[bool]) -> bool:
    """Resolve a three-state debug flag: an explicit argument wins, else
    the ``REPRO_PATTERN_DEBUG`` environment variable turns checking on."""
    if debug is not None:
        return debug
    return bool(os.environ.get("REPRO_PATTERN_DEBUG"))


def _check_or_raise(check, obj, subject: str) -> None:
    findings = check(obj, subject)
    if findings:
        lines = "\n".join(f"  {f.code} {f.subject}: {f.message}"
                          for f in findings)
        raise ValueError(
            f"pattern invariant violation ({len(findings)} finding(s)):\n"
            f"{lines}")


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
    # 0/1 validity of scatter-form entries, or None when every entry is
    # real: shard-local patterns pad their scatter form to a fixed width
    out_valid: Optional[np.ndarray] = None
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

    @property
    def n_weight_elems(self) -> int:
        return self.n_rb * self.d_in_b * self.block_in * self.block_out


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


@dataclasses.dataclass(frozen=True)
class PartitionedPattern:
    """A ``BlockPattern`` split into ``n_shards`` shard-local patterns over
    disjoint output block-row ranges: ``shards[s]`` (gather form over the
    full left-block range), ``row_assign[rb]`` (owning shard of block-row
    rb), ``perm``/``inv_perm`` (shard-major row order and its inverse), and
    the stacked ``idx`` (n_shards, n_rb_loc, d_in_b) and scatter forms
    ``out_idx``/``out_slot``/``out_valid`` (n_shards, n_lb, d_loc), padded to
    the largest local out-degree with entries (0, 0) of validity 0."""

    parent: BlockPattern
    n_shards: int
    shards: tuple  # tuple[BlockPattern]
    row_assign: np.ndarray   # (n_rb,) int32
    perm: np.ndarray         # (n_rb,) int32, shard-major order
    inv_perm: np.ndarray     # (n_rb,) int32
    idx: np.ndarray          # (n_shards, n_rb_loc, d_in_b) int32
    out_idx: np.ndarray      # (n_shards, n_lb, d_loc) int32
    out_slot: np.ndarray     # (n_shards, n_lb, d_loc) int32
    out_valid: np.ndarray    # (n_shards, n_lb, d_loc) int32 0/1

    @property
    def n_rb_local(self) -> int:
        return self.idx.shape[1]

    @property
    def contiguous(self) -> bool:
        return bool((self.perm == np.arange(len(self.perm))).all())


def _local_scatter(block_idx_local: np.ndarray, n_lb: int, d_loc: int):
    """Scatter form of one shard's (n_rb_loc, d_in_b) gather pattern over
    local row ids, padded to ``d_loc`` entries per left block."""
    n_rb_loc, d_in_b = block_idx_local.shape
    oidx = np.zeros((n_lb, d_loc), np.int32)
    oslot = np.zeros((n_lb, d_loc), np.int32)
    ovalid = np.zeros((n_lb, d_loc), np.int32)
    fill = np.zeros(n_lb, np.int64)
    for r in range(n_rb_loc):
        for f in range(d_in_b):
            lb = int(block_idx_local[r, f])
            oidx[lb, fill[lb]] = r
            oslot[lb, fill[lb]] = f
            ovalid[lb, fill[lb]] = 1
            fill[lb] += 1
    return oidx, oslot, ovalid


def partition_pattern(pattern: BlockPattern, axis_size: int,
                      debug: Optional[bool] = None) -> PartitionedPattern:
    """Split ``pattern`` into ``axis_size`` shard-local patterns over
    contiguous, equal block-row ranges (every row carries d_in_b slots, so
    equal ranges are slot-balanced and ``perm`` is the identity). Raises
    ``ValueError`` unless ``n_rb % axis_size == 0``; :func:`can_partition`
    gates the sharded path. ``debug=True`` (or ``REPRO_PATTERN_DEBUG=1``)
    runs the SL3xx checks on the result and raises on any finding."""
    n_rb = pattern.n_rb
    if axis_size < 1:
        raise ValueError(f"axis_size must be >= 1, got {axis_size}")
    if n_rb % axis_size:
        raise ValueError(
            f"pattern with n_rb={n_rb} block-rows cannot split over "
            f"axis_size={axis_size} shards (SPMD needs equal local shapes)")
    q = n_rb // axis_size
    row_assign = np.repeat(np.arange(axis_size), q).astype(np.int32)
    shard_rows = [np.flatnonzero(row_assign == s) for s in range(axis_size)]
    perm = np.concatenate(shard_rows).astype(np.int32)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n_rb, dtype=np.int32)

    idx_stk = np.stack([pattern.block_idx[rows] for rows in shard_rows])
    d_loc = 0
    for s in range(axis_size):
        counts = np.bincount(idx_stk[s].reshape(-1), minlength=pattern.n_lb)
        d_loc = max(d_loc, int(counts.max()))
    oidx_l, oslot_l, ovalid_l, shards = [], [], [], []
    for s in range(axis_size):
        oi, os_, ov = _local_scatter(idx_stk[s], pattern.n_lb, d_loc)
        oidx_l.append(oi)
        oslot_l.append(os_)
        ovalid_l.append(ov)
        shards.append(BlockPattern(
            n_in=pattern.n_in, n_out=q * pattern.block_out,
            block_in=pattern.block_in, block_out=pattern.block_out,
            block_idx=idx_stk[s].astype(np.int32),
            out_idx=oi, out_slot=os_, out_valid=ov,
            meta=dict(pattern.meta, shard=s, of=axis_size,
                      rows=shard_rows[s].tolist()),
        ))
    part = PartitionedPattern(
        parent=pattern, n_shards=axis_size, shards=tuple(shards),
        row_assign=row_assign, perm=perm, inv_perm=inv_perm,
        idx=idx_stk.astype(np.int32),
        out_idx=np.stack(oidx_l), out_slot=np.stack(oslot_l),
        out_valid=np.stack(ovalid_l))
    if _debug_on(debug):
        from ..analysis.pattern_pass import check_partition
        _check_or_raise(check_partition, part, "partition_pattern")
    return part


def can_partition(pattern: Optional[BlockPattern], axis_size: int) -> bool:
    """True when the sharded junction path applies: a real pattern, more
    than one shard, and equal per-shard block-row counts."""
    return (pattern is not None and axis_size > 1
            and pattern.n_rb % axis_size == 0
            and pattern.n_rb >= axis_size)


def shrink_to_divisor(dim: int, block: int) -> int:
    """Largest power-of-two shrink of ``block`` (capped at ``dim``) that
    divides ``dim``."""
    b = min(block, dim)
    while dim % b:
        b //= 2
    return b


def fit_block_pattern(n_in: int, n_out: int, rho: float, sp,
                      seed: int = 0, debug: Optional[bool] = None
                      ) -> Optional[BlockPattern]:
    """Adapt a ``SparsityConfig``'s block sizes to one junction, or return
    ``None`` if the junction stays dense (sparsity off, ``rho >= 1``, or
    only blocks narrower than 32 divide the junction). ``debug=True`` (or
    ``REPRO_PATTERN_DEBUG=1``) certifies the pattern with the SL3xx checks
    and raises on any finding."""
    if sp is None or not sp.enabled or rho >= 1.0:
        return None
    bi = shrink_to_divisor(n_in, sp.block_in)
    bo = shrink_to_divisor(n_out, sp.block_out)
    min_b = min(32, sp.block_in, sp.block_out)
    if bi < min_b or bo < min_b:
        return None
    bp = make_block_pattern(
        n_in, n_out, rho, block_in=bi, block_out=bo, method=sp.method,
        seed=sp.seed + seed, cf_type=sp.cf_type, dither=sp.dither)
    if _debug_on(debug):
        from ..analysis.pattern_pass import check_pattern
        _check_or_raise(check_pattern, bp,
                        f"fit_block_pattern({n_in}x{n_out}, rho={rho})")
    return bp
