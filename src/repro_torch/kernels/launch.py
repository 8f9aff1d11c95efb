"""Launch plans of the port's CUDA kernels: what each wrapper launches,
as a pure function of shapes, dtypes, the pattern arrays, the activation
and the SM count — the counterpart of what the JAX package's sparselint
reads out of a ``pl.pallas_call`` (grid, BlockSpecs, index maps).

A ``LaunchPlan`` holds one ``Launch`` per CUDA launch of a call (the
forward with ``n_splits > 1`` is the split kernel, then
``reduce_splits_kernel``; paged decode with more than one split is the
split kernel, then the merge kernel). Each launch gives its kernel's name,
grid (x, y, z), threads per CTA, dynamic shared memory in bytes, and two
functions of CTA indices: ``writes(ctas)`` — the boxes of each output (and
of each scratch buffer, such as the split partial sums) that the CTAs
store — and ``reads(ctas, patterns)`` — the boxes of each input they load,
including the blocks a pattern or page table selects. A box is a
half-open index range per dimension of the tensor as the kernel indexes
it. Each launch also names the loop or grid axis that carries its fan-in
(the sum its outputs are made of) and whether its CTAs fire the epilogue
(bias, activation, pre-activation, softmax normalisation), which is what
sparselint's grid pass (``repro_torch.analysis.grid_pass``) certifies.

The wrappers launch through this module: they build the plan, pass its
split count to the kernel's library, and call ``run``, the one hook every
launch goes through (``analysis.capture`` patches it, with ``sm_count`` and
``check_device``, to record a plan without launching). Each ``csrc/*.cu``
exports a ``<name>_plan`` function that fills grid, threads and shared
memory from the host code its launcher uses; ``chip_smoke.py`` holds every
plan against it on the card. The shared-memory formulas below are those of
the sources' tile structs (``Tile``, ``QTile``, ``FwdRing``, ``DxRing``,
``DwRing``, ``F32Tile``, ``smem_bytes``, ``Layout``, ``MmaLayout``,
``Tiles``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

H100_SMS = 132
# the largest dynamic shared memory a CTA may opt into on the H100
SMEM_OPTIN = 232448


class Access(NamedTuple):
    """One box per CTA of one buffer: ``lo``/``hi`` (N, rank) int arrays,
    the half-open range of each dimension."""
    buffer: str
    lo: np.ndarray
    hi: np.ndarray


@dataclasses.dataclass(frozen=True)
class Buffer:
    shape: Tuple[int, ...]  # as the kernel indexes the tensor
    itemsize: int
    role: str               # "in", "out" (a result of the call), "scratch"


@dataclasses.dataclass(frozen=True)
class Launch:
    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    writes: Callable[[np.ndarray], List[Access]]
    reads: Callable[[np.ndarray, Dict[str, np.ndarray]], List[Access]]
    # the fan-in the outputs sum over, and where it runs: "loop" (inside
    # every CTA) or a grid axis ("x", "z"); slots(ctas) -> (lo, hi) arrays
    fan_in: int
    fan_in_axis: str
    slots: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]
    epilogue: bool
    # (what, extent, tile, masked): a tile that must divide its extent
    # unless the kernel masks that edge
    tiles: Tuple[Tuple[str, int, int, bool], ...]
    # CTAs per thread-block cluster along (x, y, z); a cluster shares
    # distributed shared memory and must tile the grid
    cluster: Tuple[int, int, int] = (1, 1, 1)
    # whether the writes follow the pattern: writes(ctas, patterns) (the
    # small-block dw, whose CTAs own the slabs of one input block)
    pattern_writes: bool = False

    def written(self, ctas: np.ndarray,
                patterns: Dict[str, np.ndarray]) -> List[Access]:
        """The boxes of each buffer the CTAs store."""
        return self.writes(ctas, patterns) if self.pattern_writes \
            else self.writes(ctas)

    def ctas(self) -> np.ndarray:
        """Every CTA index (x, y, z), (n, 3)."""
        gx, gy, gz = self.grid
        return np.stack(np.meshgrid(np.arange(gx), np.arange(gy),
                                    np.arange(gz), indexing="ij"),
                        -1).reshape(-1, 3)

    @property
    def n_ctas(self) -> int:
        return int(np.prod(self.grid))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    name: str
    buffers: Dict[str, Buffer]
    launches: Tuple[Launch, ...]
    n_splits: int = 1
    # further scalar launch arguments the plan chose (paged decode: keys
    # per tile and pages per split)
    args: Dict[str, int] = dataclasses.field(default_factory=dict)
    # name -> int tensor or array whose values the reads follow (pattern,
    # page table, lengths); read only when the plan is analysed
    patterns: Dict[str, object] = dataclasses.field(default_factory=dict)

    def with_patterns(self, **patterns) -> "LaunchPlan":
        return dataclasses.replace(self, patterns=patterns)

    def pattern_arrays(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in self.patterns.items()}

    def dims(self) -> List[Tuple[Tuple[int, int, int], int, int, int]]:
        """(grid, threads, shared memory, cluster size) of every launch, in
        order."""
        return [(ln.grid, ln.threads, ln.smem, ln.cluster[0])
                for ln in self.launches]


# ---------------------------------------------------------------------------
# the hooks every wrapper launches through
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _device_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count a wrapper plans for: the card's."""
    return _device_sms(device)


def check_device(name: str, tensors) -> None:
    """What every kernel takes: CUDA tensors on the current device,
    contiguous and 16-byte aligned."""
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    if not tensors[0].is_cuda or any(t.device != dev for t in tensors) \
            or dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: inputs must be CUDA tensors on the "
                         f"current device")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous and 16-byte "
                         f"aligned")


def run(plan: LaunchPlan, buffers: Dict[str, Optional[torch.Tensor]],
        call: Callable[[], int]) -> None:
    """Launch: ``call()`` enqueues the plan's launches through the kernel's
    C entry point and returns its CUDA error code; raise on a nonzero one.
    ``buffers`` maps the plan's buffer names to the tensors of this call
    (None where the plan has no such buffer)."""
    rc = call()
    if rc != 0:
        raise RuntimeError(f"{plan.name} launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------


def _box(buffer: str, n: int, *ranges) -> Access:
    """An Access from one (lo, hi) pair per dimension, each a scalar or an
    (n,) array."""
    lo = np.stack([np.broadcast_to(np.asarray(r[0], np.int64), (n,))
                   for r in ranges], 1)
    hi = np.stack([np.broadcast_to(np.asarray(r[1], np.int64), (n,))
                   for r in ranges], 1)
    return Access(buffer, lo, hi)


def _empty_where(acc: Access, mask: np.ndarray) -> Access:
    """The Access with the boxes of CTAs where ``mask`` is set emptied."""
    hi = np.where(mask[:, None], acc.lo, acc.hi)
    return Access(acc.buffer, acc.lo, hi)


def _flat_boxes(buffer: str, a, b, ncols: int, lead=()) -> List[Access]:
    """The rows x columns boxes of the flat element ranges [a, b) of a
    (rows, ncols) tensor (a < b): a partial first row, whole middle rows and
    a partial last row. ``lead`` prepends fixed (lo, hi) dimensions."""
    n = len(a)
    ra, ca = a // ncols, a % ncols
    rl, cl = (b - 1) // ncols, (b - 1) % ncols + 1
    one = ra == rl
    first = _box(buffer, n, *lead, (ra, ra + 1),
                 (ca, np.where(one, cl, ncols)))
    middle = _box(buffer, n, *lead, (ra + 1, np.maximum(rl, ra + 1)),
                  (0, ncols))
    last = _empty_where(_box(buffer, n, *lead, (rl, rl + 1), (0, cl)), one)
    return [first, middle, last]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _itemsize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]


def _code(dtype: str) -> int:
    """The dtype argument of the C entry points."""
    return {"float32": 0, "bfloat16": 1}[dtype]


# ---------------------------------------------------------------------------
# csrc/csd_spmm_fwd.cu, csrc/csd_spmm_fwd_quant.cu and the split reduce
# ---------------------------------------------------------------------------

_FWD_THREADS = 128
_BN = 64  # output columns per CTA of the junction kernels


def block_m(m: int) -> int:
    """The forward kernels' rows per CTA tile."""
    return 16 if m <= 16 else 64


def split_count(m: int, n_out: int, d_in_b: int, n_sm: int,
                experts: int = 1) -> int:
    """How many CTAs share one output tile's fan-in slots: 1 when the
    (BM x 64) output tiles of all ``experts`` alone give about twice as
    many CTAs as SMs, else enough splits to get there, every split owning
    at least one slot."""
    tiles = experts * (n_out // _BN) * _ceil(m, block_m(m))
    want = _ceil(2 * n_sm, tiles)
    if want <= 1:
        return 1
    per_split = _ceil(d_in_b, want)
    return _ceil(d_in_b, per_split)


def _fwd_smem(dtype: str, bm: int, quant: bool) -> int:
    """``Tile<T, BM>::SMEM`` (csd_spmm_fwd.cuh) or ``QTile<BM>::SMEM``
    (csd_spmm_fwd_quant.cu, f32 x only)."""
    size = _itemsize(dtype)
    bk = 32 if dtype == "float32" else 64
    epc = 16 // size
    stages = 6 if bm == 16 else 3
    if not quant:
        return stages * (bm * (bk + epc) + bk * (_BN + epc)) * size
    return stages * (bm * (bk + epc) * size + bk * (_BN + 16))


def _fwd_split_launch(kernel: str, e: int, m: int, n_rb: int, d_in_b: int,
                      bl: int, br: int, dtype: str, *, n_splits: int,
                      quant: bool, has_bias: bool, save_preact: bool,
                      target: str) -> Launch:
    """The forward kernel's launch: CTA (x, y, z) owns output columns
    [64 x, 64 x + 64) of right block 64 x // bR, rows [m0, m0 + BM) of
    expert y // m_tiles and fan-in slots [z per, z per + per). It stores
    to ``target``: the partial sums of split z when ``target`` is
    "partial", else y itself (and z with ``save_preact``)."""
    bm = block_m(m)
    m_tiles = _ceil(m, bm)
    n_out = n_rb * br
    per = _ceil(d_in_b, n_splits)
    bk = 32 if dtype == "float32" else 64

    def geo(c):
        bx, by, bz = c[:, 0], c[:, 1], c[:, 2]
        col0 = bx * _BN
        rb = col0 // br
        ex = by // m_tiles
        m0 = (by % m_tiles) * bm
        m1 = np.minimum(m0 + bm, m)
        f0 = bz * per
        nsl = np.clip(np.minimum(d_in_b - f0, per), 0, None)
        return col0, rb, col0 - rb * br, ex, m0, m1, f0, nsl

    def writes(c):
        col0, _, _, ex, m0, m1, _, _ = geo(c)
        n = len(c)
        rows, cols = (ex * m + m0, ex * m + m1), (col0, col0 + _BN)
        if target == "partial":
            return [_box("partial", n, (c[:, 2], c[:, 2] + 1), rows, cols)]
        out = [_box("y", n, rows, cols)]
        if save_preact:
            out.append(_box("z", n, rows, cols))
        return out

    def reads(c, pats):
        col0, rb, n0, ex, m0, m1, f0, nsl = geo(c)
        n = len(c)
        idx = pats["block_idx"]
        out = [_box("block_idx", n, (rb, rb + 1), (f0, f0 + nsl))]
        for fl in range(per):
            skip = fl >= nsl
            f = np.where(skip, 0, f0 + fl)
            lb = idx[np.minimum(rb, idx.shape[0] - 1),
                     np.minimum(f, idx.shape[1] - 1)].astype(np.int64)
            out.append(_empty_where(_box(
                "x", n, (ex * m + m0, ex * m + m1), (lb * bl, lb * bl + bl)),
                skip))
            out.append(_empty_where(_box(
                "w", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1), (0, bl),
                (n0, n0 + _BN)), skip))
            if quant:
                out.append(_empty_where(_box(
                    "w_scale", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1)),
                    skip))
        if has_bias and target != "partial":
            out.append(_box("bias", n, (ex, ex + 1), (col0, col0 + _BN)))
        return out

    def slots(c):
        _, _, _, _, _, _, f0, nsl = geo(c)
        return f0, f0 + nsl

    return Launch(
        kernel=kernel, grid=(n_out // _BN, e * m_tiles, n_splits),
        threads=_FWD_THREADS, smem=_fwd_smem(dtype, bm, quant),
        writes=writes, reads=reads, fan_in=d_in_b,
        fan_in_axis="z" if n_splits > 1 else "loop", slots=slots,
        epilogue=target != "partial",
        tiles=(("n_out", n_out, _BN, False), ("bR", br, _BN, False),
               ("bL", bl, bk, False), ("M", m, bm, True)))


def _reduce_launch(e: int, m: int, n_out: int, n_splits: int,
                   has_bias: bool, save_preact: bool) -> Launch:
    """``reduce_splits_kernel``: thread i of CTA x adds the n_splits
    partial sums of flat element 256 x + i of y (E * M, n_out) in split
    order, adds the bias and applies the activation."""
    total = e * m * n_out

    def rng(c):
        a = c[:, 0] * 256
        return a, np.minimum(a + 256, total)

    def writes(c):
        a, b = rng(c)
        out = _flat_boxes("y", a, b, n_out)
        if save_preact:
            out += _flat_boxes("z", a, b, n_out)
        return out

    def reads(c, pats):
        a, b = rng(c)
        out = []
        for s in range(n_splits):
            out += _flat_boxes("partial", a, b, n_out, lead=((s, s + 1),))
        if has_bias:
            r0, r1 = a // n_out, (b - 1) // n_out + 1
            one = r1 - r0 == 1
            out.append(_box("bias", len(c), (r0 // m, (r1 - 1) // m + 1),
                            (np.where(one, a % n_out, 0),
                             np.where(one, (b - 1) % n_out + 1, n_out))))
        return out

    return Launch(
        kernel="reduce_splits_kernel", grid=(_ceil(total, 256), 1, 1),
        threads=256, smem=0, writes=writes, reads=reads, fan_in=n_splits,
        fan_in_axis="loop",
        slots=lambda c: (np.zeros(len(c), np.int64),
                         np.full(len(c), n_splits, np.int64)),
        epilogue=True, tiles=(("E*M*n_out", total, 256, True),))


# the forward's wgmma body (csd_spmm_fwd_wgmma_kernel): 128-row tiles, a
# producer warpgroup and two wgmma consumers, a ring of 64-deep stages
_WGMMA_BM = 128
_WGMMA_THREADS = 384


def _rounds(n_tiles: int, n_ctas: int, c: np.ndarray):
    """The tiles of persistent CTA x, round by round: (tile, skip) arrays
    per round, tile = x + round * n_ctas, skip where it is past the last
    tile."""
    for r in range(_ceil(n_tiles, n_ctas)):
        tile = c[:, 0] + r * n_ctas
        skip = tile >= n_tiles
        yield np.where(skip, 0, tile), skip


def fwd_wgmma_smem(bn: int, quant: bool = False) -> int:
    """``FwdRing<BN, W>::SMEM`` (``csd_spmm_fwd_wgmma.cuh``): the ring of
    (x, w) stages (3 at BN 256, else 4; w int8 with ``quant``), with
    ``quant`` three widened bf16 w tiles, each consumer's staging tiles of
    y and z (one each below BN 256, one for both at 256), 1024 bytes to
    align the ring, a full and an empty barrier per stage."""
    stages, bufs = (3, 1) if bn == 256 else (4, 2)
    w_size, wide = (1, 3) if quant else (2, 0)
    return stages * (_WGMMA_BM * 2 + bn * w_size) * 64 \
        + wide * bn * 64 * 2 + 2 * bufs * 64 * bn * 2 + 1024 \
        + 2 * stages * 8


def _wgmma_tiles(e: int, m: int, n_rb: int, br: int, bn: int) -> int:
    return e * _ceil(m, _WGMMA_BM) * (n_rb * br // bn)


def fwd_full_tiles(n_tiles: int, n_ctas: int, bn: int) -> int:
    """``fwd_full_tiles`` in ``csrc/csd_spmm_fwd.cu``, the schedule the
    wgmma body runs: how many of its tiles the persistent CTAs run whole.
    All, unless the last round's tiles would keep at most half the CTAs
    busy; those then run as two halves of bn / 2 columns each (not at bn
    64), so that the last round takes about half as long."""
    rest = n_tiles % n_ctas
    return n_tiles - rest if bn > 64 and rest and 2 * rest <= n_ctas \
        else n_tiles


def _schedule_cost(n_tiles: int, n_sm: int, bn: int) -> int:
    """How long the wgmma body's persistent schedule of ``n_tiles`` tiles
    of width ``bn`` runs on ``n_sm`` SMs, in columns: each round costs its
    tiles' width (bn, or bn / 2 for a halved last round) plus 32 for the
    fixed part of a tile (filling the ring, the epilogue)."""
    n_ctas = min(n_tiles, n_sm)
    n_full = fwd_full_tiles(n_tiles, n_ctas, bn)
    return _ceil(n_full, n_ctas) * (bn + 32) \
        + (bn // 2 + 32 if n_full < n_tiles else 0)


def _wgmma_width(widths, e: int, m: int, n_rb: int, br: int,
                 n_sm: int) -> Tuple[int, bool]:
    """The wgmma body's tile width: the one of ``widths`` (widest first)
    dividing bR whose schedule ``_schedule_cost`` rates shortest (the
    widest of equals), and whether its tiles number at least half of
    ``n_sm``."""
    bn = min((w for w in widths if br % w == 0), key=lambda w:
             _schedule_cost(_wgmma_tiles(e, m, n_rb, br, w), n_sm, w))
    return bn, 2 * _wgmma_tiles(e, m, n_rb, br, bn) >= n_sm


def fwd_tile_n(dtype: str, e: int, m: int, n_rb: int, br: int,
               n_sm: int) -> int:
    """Which body the full-width forward runs: the wgmma body's tile
    width (``_wgmma_width`` of 256, 128 and 64), or 0 for the grid body.
    bf16 takes the wgmma body from one whole 128-row tile per expert (M >=
    128), and below it where those tiles number at least half of ``n_sm``,
    except the single junction's decode (E = 1, M <= 16), which keeps the
    grid body's 16-row tile; f32 the grid body. (Read off
    ``tools/time_forward.py --bodies``: PERF.md, section 6.)"""
    if dtype != "bfloat16":
        return 0
    bn, fills = _wgmma_width((256, 128, 64), e, m, n_rb, br, n_sm)
    if m >= _WGMMA_BM:
        return bn
    return bn if fills and (e > 1 or m > 16) else 0


def small_block(bl: int, br: int) -> bool:
    """Whether a junction of (bL x bR) blocks runs the small-block forms of
    ``csrc/csd_spmm_small.cu`` (forward, int8 forward, dx and dw, CUDA
    cores, f32 accumulation): every block shape the 64-wide tiles of the
    other bodies refuse, bL or bR not a multiple of 64 (the paper MLP's
    16 x 4, 4 x 4, 1 x 2 and 2 x 1, the smoke configurations' 16 x 16).
    Shapes that are multiples of 64 keep their bodies (``fwd_tile_n``,
    ``quant_body``, ``dx_plan``, ``dw_plan``)."""
    return bl % 64 != 0 or br % 64 != 0


def _fwd_wgmma_launch(e: int, m: int, n_rb: int, d_in_b: int, bl: int,
                      br: int, bn: int, n_sm: int, *, has_bias: bool,
                      save_preact: bool, quant: bool = False) -> Launch:
    """``csd_spmm_fwd_wgmma_kernel`` (``quant``: its int8 instantiation,
    which also reads each slot's scale): n_ctas = min(tiles, n_sm)
    persistent CTAs, CTA b taking units b, b + n_ctas, ... A tile is rows
    [128 i, 128 i + 128) of one expert by columns [BN j, BN j + BN) of right
    block BN j // bR, in the order (expert, column tile, row tile), rows
    fastest; a unit is a whole tile, or one BN / 2-column half of one of
    the tiles that ``fwd_full_tiles`` leaves to halves, the two halves
    adjacent. The CTA loops over the block's d_in_b fan-in slots."""
    n_out = n_rb * br
    m_tiles = _ceil(m, _WGMMA_BM)
    n_col = n_out // bn
    n_tiles = _wgmma_tiles(e, m, n_rb, br, bn)
    n_ctas = min(n_tiles, n_sm)
    n_full = fwd_full_tiles(n_tiles, n_ctas, bn)
    n_units = n_full + 2 * (n_tiles - n_full)

    def geo(u):
        half = u >= n_full
        tile = np.where(half, n_full + (u - n_full) // 2, u)
        rest = tile // m_tiles
        col0 = (rest % n_col) * bn \
            + np.where(half, (u - n_full) % 2 * (bn // 2), 0)
        rb = col0 // br
        m0 = (tile % m_tiles) * _WGMMA_BM
        return (col0, np.where(half, bn // 2, bn), rb, col0 - rb * br,
                rest // n_col, m0, np.minimum(m0 + _WGMMA_BM, m))

    def writes(c):
        out = []
        for u, skip in _rounds(n_units, n_ctas, c):
            col0, width, _, _, ex, m0, m1 = geo(u)
            rows, cols = (ex * m + m0, ex * m + m1), (col0, col0 + width)
            out.append(_empty_where(_box("y", len(c), rows, cols), skip))
            if save_preact:
                out.append(_empty_where(_box("z", len(c), rows, cols), skip))
        return out

    def reads(c, pats):
        n = len(c)
        idx = pats["block_idx"]
        out = []
        for u, skip in _rounds(n_units, n_ctas, c):
            col0, width, rb, n0, ex, m0, m1 = geo(u)
            rbc = np.minimum(rb, idx.shape[0] - 1)
            out.append(_empty_where(
                _box("block_idx", n, (rb, rb + 1), (0, d_in_b)), skip))
            for f in range(d_in_b):
                lb = idx[rbc, min(f, idx.shape[1] - 1)].astype(np.int64)
                out.append(_empty_where(_box(
                    "x", n, (ex * m + m0, ex * m + m1),
                    (lb * bl, lb * bl + bl)), skip))
                out.append(_empty_where(_box(
                    "w", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1), (0, bl),
                    (n0, n0 + width)), skip))
                if quant:
                    out.append(_empty_where(_box(
                        "w_scale", n, (ex, ex + 1), (rb, rb + 1),
                        (f, f + 1)), skip))
            if has_bias:
                out.append(_empty_where(_box(
                    "bias", n, (ex, ex + 1), (col0, col0 + width)), skip))
        return out

    return Launch(
        kernel="csd_spmm_fwd_wgmma_kernel", grid=(n_ctas, 1, 1),
        threads=_WGMMA_THREADS, smem=fwd_wgmma_smem(bn, quant),
        writes=writes, reads=reads, fan_in=d_in_b, fan_in_axis="loop",
        slots=lambda c: (np.zeros(len(c), np.int64),
                         np.full(len(c), d_in_b, np.int64)),
        epilogue=True,
        tiles=(("n_out", n_out, bn, False), ("bR", br, bn, False),
               ("bL", bl, 64, False), ("M", m, _WGMMA_BM, True)))


# the forward's bodies, as the int8 forward's library takes them
# (csrc/csd_spmm_fwd_quant.cu, `body`): the grid body (the int8 forward's
# for f32 x), the int8 forward's bf16 weight-streaming body for a few rows
# per expert, and the wgmma body (csd_spmm_fwd_wgmma.cuh; int8 tiles in the
# int8 forward)
BODY_GRID, BODY_STREAM, BODY_WGMMA = 0, 1, 2
_STREAM_THREADS = 160   # a copying warp and four multiplying warps
_STREAM_BN = 128        # output columns per CTA
_STREAM_BK = 64         # fan-in rows per stage
_STREAM_ROWS = (16, 32, 64)  # the row tiles it is built for
_MAX_CLUSTER = 8        # the portable thread-block cluster size
# the rows per expert up to which the stream body always runs, and the
# most it takes where the wgmma body's tiles would fill less than half the
# SMs (read off tools/time_quant.py --bodies: PERF.md, section 6)
STREAM_M, STREAM_MAX_M = 32, 64


def stream_smem(tile_m: int) -> int:
    """``StreamRing<MT>::SMEM`` (csd_spmm_fwd_quant.cu): a ring of stages
    (4 at 64 rows, else 6), each the x box (tile_m rows of 64 bf16) and the
    weight box (64 rows of 128 int8), 1024 bytes to align the ring, a full
    and an empty barrier per stage."""
    stages = 4 if tile_m == 64 else 6
    return stages * (tile_m * 128 + _STREAM_BK * _STREAM_BN) + 1024 \
        + 2 * stages * 8


def stream_cluster(e: int, n_out: int, d_in_b: int, n_sm: int) -> int:
    """How many CTAs of a thread-block cluster share one 128-column tile's
    fan-in slots in the stream body: 1 when the tiles of all ``e`` experts
    alone give at least three CTAs for every four SMs, else enough (at
    most 8) to get about twice as many CTAs as SMs, every rank owning at
    least one slot. (Read off ``tools/time_quant.py --splits``: PERF.md,
    section 6.)"""
    tiles = e * (n_out // _STREAM_BN)
    if 4 * tiles >= 3 * n_sm:
        return 1
    want = min(_ceil(2 * n_sm, tiles), _MAX_CLUSTER, d_in_b)
    per = _ceil(d_in_b, want)
    return _ceil(d_in_b, per)


def quant_body(dtype: str, e: int, m: int, n_rb: int, d_in_b: int, br: int,
               n_sm: int) -> Tuple[int, int, int, int]:
    """Which body the int8 forward runs: (body, tile_m, tile_n, cluster).
    bf16 x takes the stream body where 128 divides bR for up to
    ``STREAM_M`` rows per expert, and up to ``STREAM_MAX_M`` where the
    wgmma body's tiles would number less than half of ``n_sm`` (gemma3-4b's
    down junction), with the smallest of its row tiles that holds M and the
    cluster of ``stream_cluster``; else the wgmma body, at the width
    ``_wgmma_width`` picks of 128 and 64. f32 x takes the grid body. (Read
    off ``tools/time_quant.py --bodies`` and ``--splits``: PERF.md,
    section 6.)"""
    if dtype != "bfloat16":
        return BODY_GRID, 0, 0, 1
    bn, fills = _wgmma_width((128, 64), e, m, n_rb, br, n_sm)
    if br % _STREAM_BN == 0 and (m <= STREAM_M
                                 or (m <= STREAM_MAX_M and not fills)):
        tile_m = next(t for t in _STREAM_ROWS if m <= t)
        return BODY_STREAM, tile_m, _STREAM_BN, \
            stream_cluster(e, n_rb * br, d_in_b, n_sm)
    return BODY_WGMMA, _WGMMA_BM, bn, 1


_FORCED: Dict[bool, Tuple[int, int, int, int]] = {}


def fwd_body(dtype: str, e: int, m: int, n_rb: int, d_in_b: int, br: int,
             n_sm: int, quant: bool) -> Tuple[int, int, int, int]:
    """The body a forward runs, as (body, tile_m, tile_n, cluster): the
    int8 forward's (``quant``) from ``quant_body``, the full-width one's
    from ``fwd_tile_n`` (the wgmma body at its width, or the grid body);
    inside ``forced_body``, the forced one."""
    if quant in _FORCED:
        return _FORCED[quant]
    if quant:
        return quant_body(dtype, e, m, n_rb, d_in_b, br, n_sm)
    return body_of_tile_n(fwd_tile_n(dtype, e, m, n_rb, br, n_sm))


def body_of_tile_n(tile_n: int) -> Tuple[int, int, int, int]:
    """The full-width forward's body of tile width ``tile_n`` (0: the grid
    body), as ``fwd_body`` gives it."""
    return (BODY_WGMMA, _WGMMA_BM, tile_n, 1) if tile_n \
        else (BODY_GRID, 0, 0, 1)


@contextlib.contextmanager
def forced_body(body: Optional[Tuple[int, int, int, int]],
                quant: bool = True):
    """Inside, the forward's plans (``quant``: the int8 forward's) run
    ``body`` ((body, tile_m, tile_n, cluster); None: the rule's pick)
    whatever the rule picks. For the tests and the timing tools."""
    if body is not None:
        _FORCED[quant] = tuple(body)
    fwd_plan.cache_clear()
    try:
        yield
    finally:
        _FORCED.pop(quant, None)
        fwd_plan.cache_clear()


def _fwd_quant_stream_launch(e: int, m: int, n_rb: int, d_in_b: int,
                             bl: int, br: int, tile_m: int, cluster: int, *,
                             has_bias: bool) -> Launch:
    """``csd_spmm_fwd_quant_stream_kernel``: CTA (rank, j, ex) of a
    (cluster, n_out / 128, E) grid, clusters along x, reads columns [128 j,
    128 j + 128) of right block 128 j // bR of expert ex for its rows (at
    most tile_m) over fan-in slots [rank per, rank per + per); rank 0 adds
    the other ranks' sums through distributed shared memory and alone
    writes y, so its slots are the cluster's: all d_in_b."""
    n_out = n_rb * br
    per = _ceil(d_in_b, cluster)
    rows = min(m, tile_m)

    def geo(c):
        rank, col0, ex = c[:, 0], c[:, 1] * _STREAM_BN, c[:, 2]
        rb = col0 // br
        f0 = rank * per
        nsl = np.clip(np.minimum(d_in_b - f0, per), 0, None)
        return rank, col0, rb, col0 - rb * br, ex, f0, nsl

    def writes(c):
        rank, col0, _, _, ex, _, _ = geo(c)
        return [_empty_where(_box("y", len(c), (ex * m, ex * m + rows),
                                  (col0, col0 + _STREAM_BN)), rank != 0)]

    def reads(c, pats):
        rank, col0, rb, n0, ex, f0, nsl = geo(c)
        n = len(c)
        idx = pats["block_idx"]
        out = [_box("block_idx", n, (rb, rb + 1), (f0, f0 + nsl))]
        for fl in range(per):
            skip = fl >= nsl
            f = np.where(skip, 0, f0 + fl)
            lb = idx[np.minimum(rb, idx.shape[0] - 1),
                     np.minimum(f, idx.shape[1] - 1)].astype(np.int64)
            out.append(_empty_where(_box(
                "x", n, (ex * m, ex * m + rows), (lb * bl, lb * bl + bl)),
                skip))
            out.append(_empty_where(_box(
                "w", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1), (0, bl),
                (n0, n0 + _STREAM_BN)), skip))
            out.append(_empty_where(_box(
                "w_scale", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1)),
                skip))
        if has_bias:
            out.append(_empty_where(_box(
                "bias", n, (ex, ex + 1), (col0, col0 + _STREAM_BN)),
                rank != 0))
        return out

    def slots(c):
        rank, _, _, _, _, f0, nsl = geo(c)
        first = rank == 0
        return np.where(first, 0, f0), np.where(first, d_in_b, f0 + nsl)

    return Launch(
        kernel="csd_spmm_fwd_quant_stream_kernel",
        grid=(cluster, n_out // _STREAM_BN, e), threads=_STREAM_THREADS,
        smem=stream_smem(tile_m), writes=writes, reads=reads,
        fan_in=d_in_b, fan_in_axis="cluster" if cluster > 1 else "loop",
        slots=slots, epilogue=True,
        tiles=(("n_out", n_out, _STREAM_BN, False),
               ("bR", br, _STREAM_BN, False), ("bL", bl, _STREAM_BK, False),
               ("M", m, tile_m, True)),
        cluster=(cluster, 1, 1))


@functools.lru_cache(maxsize=4096)
def fwd_plan(e: int, m: int, n_in: int, n_rb: int, d_in_b: int, bl: int,
             br: int, dtype: str, *, has_bias: bool, save_preact: bool,
             quant: bool, n_sm: int, n_splits: Optional[int] = None
             ) -> LaunchPlan:
    """The plan of ``csd_spmm_fwd`` (``quant``: ``csd_spmm_fwd_quant``)
    over E experts of M rows (E = 1: the 4-D junction), running the body
    ``fwd_body`` picks for ``n_sm`` SMs. The full-width forward passes it
    to the library as ``tile_n``: the persistent wgmma body, or (0) the
    grid body, whose ``n_splits`` defaults to ``split_count``'s choice (a
    test may force it; every split must own a slot). The int8 forward (the
    stream body, the wgmma body over int8 tiles, or for f32 the grid body)
    passes ``body``, ``tile_m``, ``tile_n`` and ``cluster``."""
    n_out = n_rb * br
    size = _itemsize(dtype)
    buffers = {
        "x": Buffer((e * m, n_in), size, "in"),
        "w": Buffer((e, n_rb, d_in_b, bl, br), 1 if quant else size, "in"),
        "block_idx": Buffer((n_rb, d_in_b), 4, "in"),
        "y": Buffer((e * m, n_out), size, "out"),
    }
    if quant:
        buffers["w_scale"] = Buffer((e, n_rb, d_in_b), 4, "in")
    if has_bias:
        buffers["bias"] = Buffer((e, n_out), size, "in")
    if save_preact:
        buffers["z"] = Buffer((e * m, n_out), size, "out")
    name = "csd_spmm_fwd_quant" if quant else "csd_spmm_fwd"
    kw = dict(has_bias=has_bias, save_preact=save_preact)
    body, tile_m, bn, cluster = fwd_body(dtype, e, m, n_rb, d_in_b, br,
                                         n_sm, quant)
    if body != BODY_GRID:
        if n_splits not in (None, 1):
            what = "stream" if body == BODY_STREAM else "wgmma"
            raise ValueError(f"{name}: the {what} body does not split the "
                             f"fan-in over launches")
        n_splits = 1
        launches = (
            _fwd_quant_stream_launch(e, m, n_rb, d_in_b, bl, br, tile_m,
                                     cluster, has_bias=has_bias)
            if body == BODY_STREAM else
            _fwd_wgmma_launch(e, m, n_rb, d_in_b, bl, br, bn, n_sm,
                              quant=quant, **kw),)
    else:
        if n_splits is None:
            n_splits = split_count(m, n_out, d_in_b, n_sm, e)
        split = functools.partial(_fwd_split_launch, f"{name}_kernel", e, m,
                                  n_rb, d_in_b, bl, br, dtype, quant=quant,
                                  **kw)
        if n_splits == 1:
            launches = (split(n_splits=1, target="y"),)
        else:
            buffers["partial"] = Buffer((n_splits, e * m, n_out), 4,
                                        "scratch")
            launches = (
                split(n_splits=n_splits, target="partial"),
                _reduce_launch(e, m, n_out, n_splits, has_bias, save_preact))
    args = dict(E=e, M=m, n_rb=n_rb, bR=br, n_splits=n_splits, n_sm=n_sm,
                tile_n=bn, dtype=_code(dtype))
    if quant:
        args.update(d_in_b=d_in_b, body=body, tile_m=tile_m,
                    cluster=cluster)
    return LaunchPlan(name, buffers, launches, n_splits, args)


# ---------------------------------------------------------------------------
# csrc/csd_spmm_dx.cu, csrc/csd_spmm_dw.cu and csrc/csd_mask_cotangent.cu
# ---------------------------------------------------------------------------

_RING_BOX = 64 * 64 * 2  # one 64 x 64 bf16 box, bytes
_F32_STAGES = 3    # cp.async ring of the f32 (CUDA-core) kernels


def _ring_smem(stage_bytes: int) -> int:
    """``DxRing``/``DwRing::SMEM``: 4 stages (``kRingStages``), 1024 bytes
    to align the ring, a full and an empty barrier per stage."""
    return 4 * stage_bytes + 1024 + 2 * 4 * 8


def _widest(block: int) -> int:
    """The widest of 256, 128 and 64 that divides ``block``."""
    return next(t for t in (256, 128, 64) if block % t == 0)


def dx_tile(bl: int, dtype: str) -> Tuple[int, int]:
    """(rows, columns) of a dx tile: bf16 128 x the widest of 256, 128, 64
    that divides bL; f32 64 x 64."""
    if dtype == "float32":
        return 64, 64
    return 128, _widest(bl)


def dw_tile(bl: int, br: int, dtype: str) -> Tuple[int, int]:
    """(rows in bL, columns in bR) of a dw tile: bf16 128 (64 where
    bL % 128 != 0) x the widest of 256, 128, 64 that divides bR; f32
    64 x 64."""
    if dtype == "float32":
        return 64, 64
    return (128 if bl % 128 == 0 else 64), _widest(br)


@functools.lru_cache(maxsize=4096)
def dx_plan(e: int, m: int, n_rb: int, d_in_b: int, bl: int, br: int,
            n_lb: int, d_out_b: int, dtype: str, *, n_sm: int
            ) -> LaunchPlan:
    """The plan of ``csd_spmm_dx`` on the masked cotangent g. A tile is the
    BM x BN block of dx at columns [BN x, BN x + BN) of left block
    BN x // bL and rows [BM y, BM y + BM) of expert z (``dx_tile``); its
    CTA loops over the left block's d_out_b scatter slots. f32: one CTA per
    tile, grid (x, y, z). bf16: n_ctas = min(tiles, n_sm) persistent CTAs,
    CTA b taking tiles b, b + n_ctas, ... in the order (z, x, y), y
    fastest; a producer and two wgmma warpgroups on a TMA ring."""
    bm, bn = dx_tile(bl, dtype)
    m_tiles = _ceil(m, bm)
    n_in, n_out = n_lb * bl, n_rb * br
    n_col = n_in // bn
    n_tiles = n_col * m_tiles * e
    size = _itemsize(dtype)
    f32 = dtype == "float32"
    n_ctas = 0 if f32 else min(n_tiles, n_sm)
    buffers = {
        "g": Buffer((e * m, n_out), size, "in"),
        "w": Buffer((e, n_rb, d_in_b, bl, br), size, "in"),
        "out_idx": Buffer((n_lb, d_out_b), 4, "in"),
        "out_slot": Buffer((n_lb, d_out_b), 4, "in"),
        "dx": Buffer((e * m, n_in), size, "out"),
    }

    def tiles(c):
        """(tile geometry, skip) per round of the CTAs ``c``."""
        if f32:
            yield (c[:, 0], c[:, 1], c[:, 2]), np.zeros(len(c), bool)
            return
        for tile, skip in _rounds(n_tiles, n_ctas, c):
            rest = tile // m_tiles
            yield (rest % n_col, tile % m_tiles, rest // n_col), skip

    def geo(t):
        col0 = t[0] * bn
        lb = col0 // bl
        m0 = t[1] * bm
        return col0, lb, col0 - lb * bl, t[2], m0, np.minimum(m0 + bm, m)

    def writes(c):
        out = []
        for t, skip in tiles(c):
            col0, _, _, ex, m0, m1 = geo(t)
            out.append(_empty_where(_box(
                "dx", len(c), (ex * m + m0, ex * m + m1), (col0, col0 + bn)),
                skip))
        return out

    def reads(c, pats):
        n = len(c)
        oidx, oslot = pats["out_idx"], pats["out_slot"]
        out = []
        for t, skip in tiles(c):
            col0, lb, n0, ex, m0, m1 = geo(t)
            lbc = np.minimum(lb, oidx.shape[0] - 1)
            out += [_empty_where(_box(k, n, (lb, lb + 1), (0, d_out_b)), skip)
                    for k in ("out_idx", "out_slot")]
            for g in range(d_out_b):
                rb = oidx[lbc, g].astype(np.int64)
                f = oslot[lbc, g].astype(np.int64)
                out.append(_empty_where(_box(
                    "g", n, (ex * m + m0, ex * m + m1),
                    (rb * br, rb * br + br)), skip))
                out.append(_empty_where(_box(
                    "w", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1),
                    (n0, n0 + bn), (0, br)), skip))
        return out

    launch = Launch(
        kernel="csd_spmm_dx_f32_kernel" if f32 else "csd_spmm_dx_wgmma_kernel",
        grid=(n_col, m_tiles, e) if f32 else (n_ctas, 1, 1),
        threads=128 if f32 else 384,
        smem=_F32_STAGES * 2 * 64 * 36 * 4 if f32
        else _ring_smem((bm + bn) * 64 * 2),
        writes=writes, reads=reads, fan_in=d_out_b, fan_in_axis="loop",
        slots=lambda c: (np.zeros(len(c), np.int64),
                         np.full(len(c), d_out_b, np.int64)),
        epilogue=True,
        tiles=(("n_in", n_in, bn, False), ("bL", bl, bn, False),
               ("bR", br, 32 if f32 else 64, False), ("M", m, bm, True)))
    return LaunchPlan("csd_spmm_dx", buffers, (launch,), 1,
                      dict(E=e, M=m, n_lb=n_lb, bL=bl, dtype=_code(dtype),
                           n_ctas=n_ctas))


@functools.lru_cache(maxsize=4096)
def dw_plan(e: int, m: int, n_in: int, n_rb: int, d_in_b: int, bl: int,
            br: int, dtype: str, *, want_db: bool) -> LaunchPlan:
    """The plan of ``csd_spmm_dw`` on the masked cotangent g: CTA (x, y, z)
    owns the BI x BJ tile (rows BI y, columns BJ x; ``dw_tile``) of block
    (rb, f) of expert ex, z = (ex n_rb + rb) d_in_b + f, and loops over all
    M rows; the CTAs of f = 0 and y = 0 also write db (bf16: a producer
    and one wgmma warpgroup per 64 rows on a TMA ring, f32: the CUDA
    cores)."""
    bi, bj = dw_tile(bl, br, dtype)
    n_out = n_rb * br
    size = _itemsize(dtype)
    buffers = {
        "x": Buffer((e * m, n_in), size, "in"),
        "g": Buffer((e * m, n_out), size, "in"),
        "block_idx": Buffer((n_rb, d_in_b), 4, "in"),
        "dw": Buffer((e, n_rb, d_in_b, bl, br), size, "out"),
    }
    if want_db:
        buffers["db"] = Buffer((e, n_out), 4, "out")

    def geo(c):
        j0, i0, z = c[:, 0] * bj, c[:, 1] * bi, c[:, 2]
        ex, blk = z // (n_rb * d_in_b), z % (n_rb * d_in_b)
        return j0, i0, ex, blk // d_in_b, blk % d_in_b

    def writes(c):
        j0, i0, ex, rb, f = geo(c)
        n = len(c)
        out = [_box("dw", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1),
                    (i0, i0 + bi), (j0, j0 + bj))]
        if want_db:
            col = rb * br + j0
            out.append(_empty_where(_box("db", n, (ex, ex + 1),
                                         (col, col + bj)),
                                    (f != 0) | (i0 != 0)))
        return out

    def reads(c, pats):
        j0, i0, ex, rb, f = geo(c)
        n = len(c)
        idx = pats["block_idx"]
        lb = idx[np.minimum(rb, idx.shape[0] - 1),
                 np.minimum(f, idx.shape[1] - 1)].astype(np.int64)
        rows = (ex * m, ex * m + m)
        return [_box("block_idx", n, (rb, rb + 1), (f, f + 1)),
                _box("x", n, rows, (lb * bl + i0, lb * bl + i0 + bi)),
                _box("g", n, rows, (rb * br + j0, rb * br + j0 + bj))]

    f32 = dtype == "float32"
    launch = Launch(
        kernel="csd_spmm_dw_f32_kernel" if f32 else "csd_spmm_dw_wgmma_kernel",
        grid=(br // bj, bl // bi, e * n_rb * d_in_b),
        threads=128 if f32 else 128 * (1 + bi // 64),
        smem=_F32_STAGES * 2 * 32 * 68 * 4 if f32
        else _ring_smem((bi + bj) // 64 * _RING_BOX),
        writes=writes, reads=reads, fan_in=1, fan_in_axis="loop",
        slots=lambda c: (np.zeros(len(c), np.int64),
                         np.ones(len(c), np.int64)),
        epilogue=True,
        tiles=(("bR", br, bj, False), ("bL", bl, bi, False),
               ("n_in", n_in, bl, False),
               ("M", m, 32 if f32 else 64, True)))
    return LaunchPlan("csd_spmm_dw", buffers, (launch,), 1,
                      dict(E=e, n_rb=n_rb, d_in_b=d_in_b, bL=bl, bR=br,
                           dtype=_code(dtype)))


_MASK_THREADS = 256


@functools.lru_cache(maxsize=4096)
def mask_plan(rows: int, n_out: int, dtype: str) -> LaunchPlan:
    """The plan of ``csd_mask_cotangent`` over a (rows, n_out) cotangent
    (E x M rows of the expert-batched form): thread i of CTA x masks the
    16-byte chunk t = 256 x + i of the flat cotangent, reading the same
    chunk of dy and aux and writing it to g; past the whole chunks, thread
    t masks one element of the tail (rows x n_out not a multiple of the
    chunk), so CTA x covers the flat elements [start(256 x),
    start(256 x + 256)), start(t) = t x chunk up to the last whole chunk,
    one element a thread after it."""
    size = _itemsize(dtype)
    per = 16 // size  # elements per chunk
    total = rows * n_out
    n_chunks, tail = divmod(total, per)
    buffers = {k: Buffer((rows, n_out), size, "out" if k == "g" else "in")
               for k in ("dy", "aux", "g")}

    def start(t):
        return np.where(t <= n_chunks, t * per, n_chunks * per + t - n_chunks)

    def rng(c):
        t = c[:, 0] * _MASK_THREADS
        return start(t), start(np.minimum(t + _MASK_THREADS,
                                          n_chunks + tail))

    launch = Launch(
        kernel="csd_mask_cotangent_kernel",
        grid=(_ceil(n_chunks + tail, _MASK_THREADS), 1, 1),
        threads=_MASK_THREADS, smem=0,
        writes=lambda c: _flat_boxes("g", *rng(c), n_out),
        reads=lambda c, p: _flat_boxes("dy", *rng(c), n_out)
        + _flat_boxes("aux", *rng(c), n_out),
        fan_in=1, fan_in_axis="loop",
        slots=lambda c: (np.zeros(len(c), np.int64),
                         np.ones(len(c), np.int64)),
        epilogue=True,
        tiles=(("rows*n_out", total, _MASK_THREADS * per, True),))
    return LaunchPlan("csd_mask_cotangent", buffers, (launch,), 1,
                      dict(rows=rows, n_out=n_out, dtype=_code(dtype)))


# ---------------------------------------------------------------------------
# csrc/csd_spmm_small.cu (forward, int8 forward and dx) and
# csrc/csd_spmm_small_dw.cu (dw): the small-block forms
# ---------------------------------------------------------------------------

_SMALL_THREADS = 256            # the gather kernel's CTA (kThreads)
_SMALL_TR = 8                   # rows a thread of it (kTR)
_SMALL_ROWS = (64, 32, 16, 8)   # its tile heights
_SMALL_MAX_STAGES = 3
_DW_THREADS = 256
_SMALL_MAX_CLUSTER = 8
# an H100 SM's shared memory, the part the system keeps per CTA, and the
# gather kernel's CTAs an SM holds by registers (__launch_bounds__(256, 2))
SMEM_PER_SM, _SMEM_RESERVED, _SMALL_REG_CTAS = 233472, 1024, 2
# the rules' knobs: an output range keeps at least _SMALL_MIN_NCG column
# groups (a floor, not swept); dw's M splits over a cluster while the CTAs
# stay at most twice the SMs and each rank keeps _DW_MIN_ROWS rows (read
# off tools/time_small.py --splits: PERF.md, section 6)
_SMALL_MIN_NCG = 8
_DW_MIN_ROWS = 16
# the dw kernel: a ring of 3 stages of 32 KiB behind a header of the
# batch's slabs (256 ints), the warps' counts and a resume position
_DW_STAGES, _DW_STAGE_BYTES = 3, 32768
_DW_HEADER = 4 * (_DW_THREADS + 16)

_FORCED_SMALL: Dict[str, int] = {}


class GatherSplit(NamedTuple):
    """The gather kernel's launch geometry: ``rows`` a tile, ``ncg``
    column groups a CTA (``groups`` ranges), the fan-in split over ``ks``
    ranks of the CTA, ``stages`` in the ring, ``y`` CTAs along the row
    tiles (each walks tiles y, y + Y, ...)."""
    rows: int
    ncg: int
    groups: int
    ks: int
    stages: int
    y: int


def small_column_group(width: int) -> int:
    """``column_group`` (csd_spmm_small.cu): the output columns a thread of
    the gather kernel owns (CW, of the output block width) and the fan-in
    elements it steps at once (KQ, of the input block width): the largest
    of 4, 2, 1 that divides ``width``."""
    return 4 if width % 4 == 0 else 2 if width % 2 == 0 else 1


def small_block_stride(iw: int, size: int, rows: int) -> int:
    """``block_stride``: elements between staged input blocks of ``iw``
    elements, with 16 bytes of padding in 8-row tiles (where a warp's lanes
    read one row) where a block's bytes are an even number of 16-byte bank
    groups (bL 16 f32), so the blocks the lanes gather spread over all 8
    groups."""
    b = iw * size
    return iw + 16 // size if rows == _SMALL_TR and b % 16 == 0 \
        and (b // 16) % 2 == 0 else iw


def small_gather_rs(in_cols: int, iw: int, size: int, rows: int) -> int:
    """Elements between staged input rows (of padded blocks): a multiple
    of 128 bytes and 16 more, so a warp's rows of one column fall in
    distinct bank groups."""
    return _ceil(in_cols // iw * small_block_stride(iw, size, rows),
                 128 // size) * (128 // size) + 16 // size


def small_gather_stage(in_cols: int, iw: int, size: int, rows: int,
                       rc: int, ks: int) -> int:
    """``GatherGeo::stage``: bytes of one ring stage, the tile's staged
    input rows or (when the fan-in is split) the ranks' f32 partial sums
    of its rows x ``rc`` columns, whichever is larger."""
    x = rows * small_gather_rs(in_cols, iw, size, rows) * size
    red = 4 * ks * rows * rc if ks > 1 else 0
    return _ceil(max(x, red), 16) * 16


def small_gather_fits(in_cols: int, iw: int, size: int) -> bool:
    """Whether 8 rows of ``in_cols`` inputs in blocks of ``iw`` fit one
    stage: the widest input the gather kernel takes."""
    return small_gather_stage(in_cols, iw, size, 8, 1, 1) <= SMEM_OPTIN


def _occupancy(smem: int) -> int:
    """The gather kernel's CTAs an SM holds: by registers, and by shared
    memory."""
    return max(1, min(_SMALL_REG_CTAS,
                      SMEM_PER_SM // (smem + _SMEM_RESERVED)))


def small_gather_split(e: int, m: int, n_ob: int, ow: int, iw: int,
                       in_cols: int, n_slots: int, size: int,
                       n_sm: int) -> GatherSplit:
    """The rule that picks the gather kernel's geometry for E experts of M
    rows, n_ob output blocks of width ``ow`` over ``n_slots`` fan-in slots
    of ``iw``-wide blocks of an ``in_cols``-wide input (``size`` bytes an
    element), on ``n_sm`` SMs:

    * rows: the tallest tile (64 to 8, at most M rounded up to 8) whose
      stage leaves room for a second and whose tiles, with the output
      split only as the threads need, give at least one CTA an SM; else 8
      (more rows re-read the slab less often, fewer fill the card);
    * output ranges: doubled while the CTAs number fewer than the SMs and a
      range keeps at least ``_SMALL_MIN_NCG`` column groups;
    * ks: the threads left over split the slots, every rank owning one,
      except where they would only double it in an 8-row tile (each
      thread's rows the whole tile), whose ranks' pass over the tile costs
      more than it saves (``forced_small_split`` overrides it);
    * y: the CTAs the SMs hold at once (two where shared memory allows),
      each walking its tiles; stages: as many (up to 3) as a CTA has tiles
      and the SM holds without losing a resident CTA.
    """
    cw = small_column_group(ow)
    n_cg = n_ob * ow // cw
    top = _ceil(m, _SMALL_TR) * _SMALL_TR

    def groups_at(rows):
        cap = _SMALL_THREADS // (rows // _SMALL_TR)
        return _ceil(n_cg, min(n_cg, cap))

    rows = _SMALL_TR
    for r in _SMALL_ROWS[:-1]:
        if r <= top and 2 * small_gather_stage(
                in_cols, iw, size, r, 1, 1) <= SMEM_OPTIN \
                and e * groups_at(r) * _ceil(m, r) >= n_sm:
            rows = r
            break
    nrg = rows // _SMALL_TR
    tiles = _ceil(m, rows)
    groups = groups_at(rows)
    while e * groups * tiles < n_sm \
            and _ceil(n_cg, 2 * groups) >= _SMALL_MIN_NCG:
        groups *= 2
    ncg = _ceil(n_cg, groups)
    groups = _ceil(n_cg, ncg)
    spare = _SMALL_THREADS // (nrg * ncg)
    room = max(1, min(n_slots, spare))
    ks = _FORCED_SMALL.get("gather",
                           1 if spare <= 2 and rows == _SMALL_TR else room)
    ks = max(1, min(ks, room))
    ks = _ceil(n_slots, _ceil(n_slots, ks))
    stage = small_gather_stage(in_cols, iw, size, rows, ncg * cw, ks)
    occ = _occupancy(stage)
    y = min(tiles, _ceil(occ * n_sm, groups * e))
    stages = 1
    for st in range(min(_SMALL_MAX_STAGES, _ceil(tiles, y)), 1, -1):
        if st * stage <= SMEM_OPTIN and _occupancy(st * stage) == occ:
            stages = st
            break
    return GatherSplit(rows, ncg, groups, ks, stages, y)


def small_dw_tile(bl: int, br: int) -> Tuple[int, int]:
    """``tile_rows``/``tile_cols`` (csd_spmm_small_dw.cu): the TI x TJ part
    of one slab a dw thread owns (16 x 4 at the paper's 16 x 4 blocks)."""
    ti = 16 if bl % 16 == 0 else 4 if bl % 4 == 0 else 2 if bl % 2 == 0 \
        else 1
    return ti, small_column_group(br)


def small_dw_batch(bl: int, br: int) -> int:
    """Slabs a dw batch holds (``qg``): as many whole slabs as give at most
    256 thread tiles, at least one."""
    ti, tj = small_dw_tile(bl, br)
    return max(1, _DW_THREADS // ((bl // ti) * (br // tj)))


def small_dw_fits(bl: int, br: int, size: int) -> bool:
    """Whether one row of a dw stage (the x strip and a batch's g strips)
    fits a 32 KiB stage."""
    step = 16 // size
    row = _ceil(bl, step) * step + _ceil(small_dw_batch(bl, br) * br,
                                         step) * step
    return row * size <= _DW_STAGE_BYTES


def small_dw_cluster(e: int, m: int, n_lb: int, n_sm: int) -> int:
    """The rule that picks the dw kernel's M split: the largest cluster of
    1, 2, 4 or 8 CTAs whose CTAs (``e`` x ``n_lb`` x C) stay at most twice
    ``n_sm`` and whose ranks keep at least ``_DW_MIN_ROWS`` rows each
    (``forced_small_split`` overrides it)."""
    c = _FORCED_SMALL.get("dw")
    if c is None:
        c = 1
        while 2 * c <= _SMALL_MAX_CLUSTER and e * n_lb * 2 * c <= 2 * n_sm \
                and m // (2 * c) >= _DW_MIN_ROWS:
            c *= 2
    return max(1, min(c, _SMALL_MAX_CLUSTER, m))


@contextlib.contextmanager
def forced_small_split(gather: Optional[int] = None,
                       dw: Optional[int] = None):
    """Inside, the small-block plans split the gather kernel's fan-in over
    ``gather`` ranks of the CTA and the dw kernel's M over a cluster of
    ``dw`` CTAs (None: the rule's; both clamped to what the shape takes)
    whatever the rules pick. For the tests and the timing tools."""
    for k, v in (("gather", gather), ("dw", dw)):
        if v is not None:
            _FORCED_SMALL[k] = v
    for f in (fwd_small_plan, dx_small_plan, dw_small_plan):
        f.cache_clear()
    try:
        yield
    finally:
        _FORCED_SMALL.clear()
        for f in (fwd_small_plan, dx_small_plan, dw_small_plan):
            f.cache_clear()


def _small_gather_launch(e: int, m: int, n_ob: int, ow: int, iw: int,
                         n_slots: int, in_name: str, in_cols: int, size: int,
                         sp: GatherSplit, *, outs, reads_slot, table_reads,
                         has_bias: bool) -> Launch:
    """The gather kernel's launch: CTA (grp, y, ex) owns output columns
    [grp ncg CW, ...) of expert ex and row tiles y, y + Y, ...; it stages
    each tile's whole input rows, sums every slot of its column groups
    (over ks ranks, added in rank order) and stores its tiles' rows.
    ``reads_slot(ob, s, ex, j0, j1, pats, n)`` gives the slab boxes one
    output block reads at slot s, ``table_reads`` those of the pattern
    tables."""
    cw = small_column_group(ow)
    out_cols = n_ob * ow
    R, Y = sp.rows, sp.y
    tiles = _ceil(m, R)
    rounds = _ceil(tiles, Y)
    width = sp.ncg * cw
    nob = _ceil(width, ow) + 1

    def geo(c):
        col0 = c[:, 0] * width
        return col0, np.minimum(col0 + width, out_cols), c[:, 1], c[:, 2]

    def rows_of(y, k):
        t = y + k * Y
        lo = np.minimum(t * R, m)
        return lo, np.where(t < tiles, np.minimum(t * R + R, m), lo)

    def writes(c):
        col0, col1, y, ex = geo(c)
        n = len(c)
        out = []
        for k in range(rounds):
            lo, hi = rows_of(y, k)
            out += [_box(name, n, (ex * m + lo, ex * m + hi), (col0, col1))
                    for name in outs]
        return out

    def reads(c, pats):
        col0, col1, y, ex = geo(c)
        n = len(c)
        ob0 = col0 // ow
        out = list(table_reads(ob0, (col1 - 1) // ow + 1, n))
        for k in range(rounds):
            lo, hi = rows_of(y, k)
            out.append(_box(in_name, n, (ex * m + lo, ex * m + hi),
                            (0, in_cols)))
        for b in range(nob):
            ob = ob0 + b
            obc = np.minimum(ob, n_ob - 1)
            j0 = np.clip(col0 - ob * ow, 0, ow)
            j1 = np.maximum(np.clip(col1 - ob * ow, 0, ow), j0)
            skip = ob * ow >= col1
            for s in range(n_slots):
                out += [_empty_where(a, skip) for a in
                        reads_slot(obc, s, ex, j0, j1, pats, n)]
        if has_bias:
            out.append(_box("bias", n, (ex, ex + 1), (col0, col1)))
        return out

    return Launch(
        kernel="csd_spmm_small_gather_kernel",
        grid=(sp.groups, Y, e), threads=_SMALL_THREADS,
        smem=sp.stages * small_gather_stage(in_cols, iw, size, R, width,
                                            sp.ks),
        writes=writes, reads=reads, fan_in=n_slots, fan_in_axis="loop",
        slots=lambda c: (np.zeros(len(c), np.int64),
                         np.full(len(c), n_slots, np.int64)),
        epilogue=True,
        tiles=(("output columns", out_cols, width, True),
               ("block width", ow, cw, False), ("M", m, R, True)))


@functools.lru_cache(maxsize=4096)
def fwd_small_plan(e: int, m: int, n_in: int, n_rb: int, d_in_b: int,
                   bl: int, br: int, dtype: str, *, has_bias: bool,
                   save_preact: bool, n_sm: int = H100_SMS,
                   quant: bool = False) -> LaunchPlan:
    """The plan of the small-block forward (``csd_spmm_small_fwd``): the
    gather kernel over the n_rb right blocks (width bR), each summing
    x[:, block_idx[rb, f]] w[rb, f] over its slots, in the geometry
    ``small_gather_split`` picks for ``n_sm`` SMs (x's, whatever the
    slab's type). ``quant``: the int8 form (``csd_spmm_small_fwd_quant``),
    an int8 slab whose every slot also reads its block's f32 scale
    ``w_scale`` (E, n_rb, d_in_b); no pre-activation."""
    if quant and save_preact:
        raise ValueError("the int8 small-block forward has no save_preact")
    n_out = n_rb * br
    size = _itemsize(dtype)
    buffers = {
        "x": Buffer((e * m, n_in), size, "in"),
        "w": Buffer((e, n_rb, d_in_b, bl, br), 1 if quant else size, "in"),
        "block_idx": Buffer((n_rb, d_in_b), 4, "in"),
        "y": Buffer((e * m, n_out), size, "out"),
    }
    if quant:
        buffers["w_scale"] = Buffer((e, n_rb, d_in_b), 4, "in")
    if has_bias:
        buffers["bias"] = Buffer((e, n_out), size, "in")
    if save_preact:
        buffers["z"] = Buffer((e * m, n_out), size, "out")
    sp = small_gather_split(e, m, n_rb, br, bl, n_in, d_in_b, size, n_sm)

    def reads_slot(rb, f, ex, j0, j1, pats, n):
        out = [_box("w", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1),
                    (0, bl), (j0, j1))]
        if quant:
            out.append(_box("w_scale", n, (ex, ex + 1), (rb, rb + 1),
                            (f, f + 1)))
        return out

    def table_reads(ob0, ob1, n):
        return [_box("block_idx", n, (ob0, ob1), (0, d_in_b))]

    ln = _small_gather_launch(
        e, m, n_rb, br, bl, d_in_b, "x", n_in, size, sp,
        outs=("y", "z") if save_preact else ("y",), reads_slot=reads_slot,
        table_reads=table_reads, has_bias=has_bias)
    name = "csd_spmm_fwd_quant_small" if quant else "csd_spmm_fwd_small"
    return LaunchPlan(name, buffers, (ln,), 1,
                      dict(E=e, n_ob=n_rb, ow=br, iw=bl, in_cols=n_in,
                           n_slots=d_in_b, dtype=_code(dtype), R=sp.rows,
                           ncg=sp.ncg, ks=sp.ks, stages=sp.stages, Y=sp.y))


@functools.lru_cache(maxsize=4096)
def dx_small_plan(e: int, m: int, n_rb: int, d_in_b: int, bl: int, br: int,
                  n_lb: int, d_out_b: int, dtype: str, *,
                  n_sm: int = H100_SMS) -> LaunchPlan:
    """The plan of the small-block dx (``csd_spmm_small_dx``) on the masked
    cotangent g: the gather kernel over the n_lb left blocks (width bL),
    each summing g[:, out_idx[lb, s]] w[out_idx, out_slot]^T over its
    slots, in the geometry ``small_gather_split`` picks."""
    n_in, n_out = n_lb * bl, n_rb * br
    size = _itemsize(dtype)
    buffers = {
        "g": Buffer((e * m, n_out), size, "in"),
        "w": Buffer((e, n_rb, d_in_b, bl, br), size, "in"),
        "out_idx": Buffer((n_lb, d_out_b), 4, "in"),
        "out_slot": Buffer((n_lb, d_out_b), 4, "in"),
        "dx": Buffer((e * m, n_in), size, "out"),
    }
    sp = small_gather_split(e, m, n_lb, bl, br, n_out, d_out_b, size, n_sm)

    def reads_slot(lb, s, ex, j0, j1, pats, n):
        rb = pats["out_idx"][lb, s].astype(np.int64)
        f = pats["out_slot"][lb, s].astype(np.int64)
        return [_box("w", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1),
                     (j0, j1), (0, br))]

    def table_reads(ob0, ob1, n):
        return [_box(k, n, (ob0, ob1), (0, d_out_b))
                for k in ("out_idx", "out_slot")]

    ln = _small_gather_launch(
        e, m, n_lb, bl, br, d_out_b, "g", n_out, size, sp, outs=("dx",),
        reads_slot=reads_slot, table_reads=table_reads, has_bias=False)
    return LaunchPlan("csd_spmm_dx_small", buffers, (ln,), 1,
                      dict(E=e, n_ob=n_lb, ow=bl, iw=br, in_cols=n_out,
                           n_slots=d_out_b, dtype=_code(dtype), R=sp.rows,
                           ncg=sp.ncg, ks=sp.ks, stages=sp.stages, Y=sp.y))


def small_dw_items(block_idx: np.ndarray, lb: int, bl: int, br: int,
                   cluster: int, rank: int) -> List[Tuple[int, int, int]]:
    """The (flat slab rb d_in_b + f, ti, tj) thread tiles whose sums rank
    ``rank`` of left block ``lb``'s dw cluster stores: the slabs of lb in
    flat order, in batches of ``small_dw_batch`` slabs, each batch's tiles
    (slab-major) in groups of at most 256, rank ``rank`` taking its
    ceil(ni / C) share of each group (csd_spmm_small_dw_kernel)."""
    ti, tj = small_dw_tile(bl, br)
    ntj = br // tj
    tp = (bl // ti) * ntj
    qg = small_dw_batch(bl, br)
    pairs = np.flatnonzero(np.asarray(block_idx).reshape(-1) == lb)
    out = []
    for b0 in range(0, len(pairs), qg):
        batch = pairs[b0:b0 + qg]
        items = len(batch) * tp
        for it0 in range(0, items, _DW_THREADS):
            ni = min(_DW_THREADS, items - it0)
            ipr = _ceil(ni, cluster)
            lo = min(ni, rank * ipr)
            for it in range(it0 + lo, it0 + min(ni, lo + ipr)):
                t2 = it % tp
                out.append((int(batch[it // tp]), t2 // ntj, t2 % ntj))
    return out


@functools.lru_cache(maxsize=4096)
def dw_small_plan(e: int, m: int, n_in: int, n_rb: int, d_in_b: int,
                  bl: int, br: int, dtype: str, *, want_db: bool,
                  n_sm: int = H100_SMS) -> LaunchPlan:
    """The plan of the small-block dw (``csd_spmm_small_dw``) on the masked
    cotangent g: CTA (rank, lb, ex) of a (C, n_lb, E) grid, C from
    ``small_dw_cluster``, clusters along x, sums rows [rank ceil(M / C),
    ...) of expert ex for every slab whose input block is lb and stores
    the cluster's sums for its share of their thread tiles
    (``small_dw_items``); the tiles of slot 0 also store db. Its writes
    follow the pattern."""
    n_lb, n_out = n_in // bl, n_rb * br
    size = _itemsize(dtype)
    C = small_dw_cluster(e, m, n_lb, n_sm)
    ti, tj = small_dw_tile(bl, br)
    mpr = _ceil(m, C)
    buffers = {
        "x": Buffer((e * m, n_in), size, "in"),
        "g": Buffer((e * m, n_out), size, "in"),
        "block_idx": Buffer((n_rb, d_in_b), 4, "in"),
        "dw": Buffer((e, n_rb, d_in_b, bl, br), size, "out"),
    }
    if want_db:
        buffers["db"] = Buffer((e, n_out), 4, "out")

    def writes(c, pats):
        idx = np.asarray(pats["block_idx"])
        per = {}
        for rank, lb in {(int(r), int(b)) for r, b in c[:, :2]}:
            per[rank, lb] = small_dw_items(idx, lb, bl, br, C, rank)
        k_max = max((len(v) for v in per.values()), default=0)
        n = len(c)
        lists = [per[int(r), int(b)] for r, b in c[:, :2]]
        ex = c[:, 2]
        out = []
        for k in range(k_max):
            have = np.array([k < len(v) for v in lists])
            fl = np.array([v[k][0] if k < len(v) else 0 for v in lists])
            t_i = np.array([v[k][1] if k < len(v) else 0 for v in lists])
            t_j = np.array([v[k][2] if k < len(v) else 0 for v in lists])
            rb, f = fl // d_in_b, fl % d_in_b
            out.append(_empty_where(_box(
                "dw", n, (ex, ex + 1), (rb, rb + 1), (f, f + 1),
                (t_i * ti, t_i * ti + ti), (t_j * tj, t_j * tj + tj)),
                ~have))
            if want_db:
                out.append(_empty_where(_box(
                    "db", n, (ex, ex + 1),
                    (rb * br + t_j * tj, rb * br + t_j * tj + tj)),
                    ~have | (f != 0) | (t_i != 0)))
        return out

    def reads(c, pats):
        idx = np.asarray(pats["block_idx"]).reshape(-1)
        rank, lb, ex = c[:, 0], c[:, 1], c[:, 2]
        n = len(c)
        lo = np.minimum(rank * mpr, m)
        hi = np.minimum(lo + mpr, m)
        rows = (ex * m + lo, ex * m + hi)
        slabs = {int(b): np.flatnonzero(idx == b) for b in np.unique(lb)}
        k_max = max((len(v) for v in slabs.values()), default=0)
        out = [_box("block_idx", n, (0, n_rb), (0, d_in_b)),
               _empty_where(_box("x", n, rows, (lb * bl, lb * bl + bl)),
                            np.array([len(slabs[int(b)]) == 0
                                      for b in lb]))]
        for k in range(k_max):
            have = np.array([k < len(slabs[int(b)]) for b in lb])
            rb = np.array([slabs[int(b)][k] // d_in_b
                           if k < len(slabs[int(b)]) else 0 for b in lb])
            out.append(_empty_where(_box("g", n, rows,
                                         (rb * br, rb * br + br)), ~have))
        return out

    ln = Launch(
        kernel="csd_spmm_small_dw_kernel", grid=(C, n_lb, e),
        threads=_DW_THREADS, smem=_DW_HEADER + _DW_STAGES * _DW_STAGE_BYTES,
        writes=writes, reads=reads, fan_in=C,
        fan_in_axis="cluster" if C > 1 else "loop",
        slots=lambda c: (np.zeros(len(c), np.int64),
                         np.full(len(c), C, np.int64)),
        epilogue=True,
        tiles=(("bL", bl, ti, False), ("bR", br, tj, False),
               ("M", m, mpr, True)),
        cluster=(C, 1, 1), pattern_writes=True)
    return LaunchPlan("csd_spmm_dw_small", buffers, (ln,), 1,
                      dict(E=e, n_lb=n_lb, cluster=C, dtype=_code(dtype)))


# ---------------------------------------------------------------------------
# csrc/paged_decode.cu
# ---------------------------------------------------------------------------

_PAGED_THREADS = 256
_PAGED_WARPS = 8
_PAGED_MERGE_THREADS = 256
_PAGED_STAGES = 4            # K/V tiles in the ring at most (kMaxStages)
_PAGED_RING_BYTES = 98304    # its shared memory at most (kRingBytes)
_PAGED_TILE_BYTES = 16384    # bytes of K a tile holds at most
_PAGED_MAX_PPS = 1024        # page-table entries a CTA holds at most
# query heads a CTA of the CUDA-core form holds (kMaxG); a larger group
# runs there in chunks of 8 over grid y
PAGED_MAX_G = 8
# the split rule (measured with tools/time_decode.py --splits on the H100):
# a row of at most _PAGED_ONE_LAUNCH_TILES tiles of table runs in one
# launch; a longer one in splits of whole tiles until the (row, head,
# chunk of 8 query heads, split) CTAs number _PAGED_WAVES per SM
_PAGED_ONE_LAUNCH_TILES = 8
_PAGED_WAVES = 2

# the tensor-core form (paged_decode_mma_kernel; the source's mma_rule):
# bf16 q over bf16 or int8 pages, G0 to 48 query heads a KV head as the
# rows of up to 3 mma tiles, whole 128-byte rows of K and V, one CTA per
# (split, KV head, row) for the whole group
PAGED_MMA_MIN_G = 5            # G0 (kMmaMinG)
PAGED_MMA_MAX_G = 48           # 3 row tiles of 16 heads (kMmaMaxMT)
_PAGED_MMA_TILE_KEYS = 64      # keys a tile at least (kMmaTileKeys)
_PAGED_MMA_STAGE_BYTES = 65536  # K and V of a tile at most (kMmaStageBytes)
_PAGED_MMA_RING_BYTES = 98304  # the ring, at least 2 stages (kMmaRingBytes)
# its split rule (measured with tools/time_decode.py --splits on the H100):
# a row of at most _PAGED_MMA_ONE_LAUNCH_TILES tiles runs in one launch, in
# one tile where the shared memory holds two stages of it; a longer one in
# splits of whole tiles until the (row, KV head, split) CTAs
# number _PAGED_MMA_WAVES per SM for a CTA of 4 warps (one row tile), one
# per SM for the larger CTAs (which an SM's registers hold one of)
_PAGED_MMA_ONE_LAUNCH_TILES = 4
_PAGED_MMA_WAVES = 2
PAGED_FORMS = ("cores", "mma")  # the form codes of the sources: 0, 1
_FORCED_FORM: List[Optional[str]] = [None]


def paged_bucket(dh: int) -> int:
    """The head-dim bucket of the split kernel's register form."""
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


def paged_chunks(g: int) -> int:
    """Chunks of 8 query heads a group runs in: one CTA each per (row, KV
    head, split)."""
    return _ceil(g, PAGED_MAX_G)


def paged_tile(g: int, dh: int, page_size: int, page_itemsize: int) -> int:
    """Keys per tile of the paged-decode kernel: one softmax chunk of
    every consumer warp (8 warps x the keys a warp step covers, 256 /
    bucket, x 4 slots, 2 from G 4 up, groups above 8 as the 8 form), at
    most ``_PAGED_TILE_BYTES`` of K, in whole pages (at least one)."""
    keys = _PAGED_WARPS * (256 // paged_bucket(dh)) * (4 if g <= 2 else 2)
    keys = min(keys, _PAGED_TILE_BYTES // (dh * page_itemsize))
    return max(1, keys // page_size) * page_size


def paged_mma_dh(dh: int, quant: bool) -> bool:
    """Whether rows of ``dh`` values are whole 128-byte column blocks the
    tensor-core form is built for (bf16 Dh 64, 128, 256; int8 128, 256)."""
    return dh in (128, 256) or (dh == 64 and not quant)


def paged_mma_tile(page_size: int) -> int:
    """Keys a tile of the tensor-core form: 64 rounded up to whole pages
    and 16-key chunks."""
    lcm = 16 // math.gcd(16, page_size) * page_size
    return _ceil(_PAGED_MMA_TILE_KEYS, lcm) * lcm


def paged_mma_warps(g: int, dh: int) -> Tuple[int, int, int]:
    """(row tiles, head-dim slices, key slices) of the tensor-core form's
    warps: ceil(G / 16) row tiles; 2 slices of the output's head dims from
    Dh 256; 4 key slices, 2 where row tiles x dim slices pass 3."""
    mt, ds = _ceil(g, 16), 2 if dh > 128 else 1
    return mt, ds, 4 if mt * ds <= 3 else 2


def paged_mma_legal(g: int, dh: int, dtype: str, quant: bool) -> bool:
    """Whether the tensor-core form can take the call when it is forced
    (``mma_legal``): bf16 q, 1 to 48 heads, rows of whole 128-byte
    blocks."""
    return dtype == "bfloat16" and 1 <= g <= PAGED_MMA_MAX_G \
        and paged_mma_dh(dh, quant)


def paged_rule(g: int, dh: int, page_size: int, dtype: str,
               quant: bool) -> str:
    """The form a paged decode call runs (``mma_rule`` of
    csrc/paged_decode.cu): ``"mma"``, the tensor-core form, for bf16 q over
    bf16 or int8 pages with G0 (5) to 48 query heads a KV head, rows of
    whole 128-byte blocks and a tile of K and V within 64 KiB; else
    ``"cores"``: groups of 1, 2 and 4 (below SDPA on the H100 already),
    f32 (its 2e-5 gate would not survive bf16 rounding of q or P) and
    what the tensor-core form is not built for."""
    itemsize = 1 if quant else 2
    ok = dtype == "bfloat16" and PAGED_MMA_MIN_G <= g <= PAGED_MMA_MAX_G \
        and paged_mma_dh(dh, quant) \
        and 2 * paged_mma_tile(page_size) * dh * itemsize \
        <= _PAGED_MMA_STAGE_BYTES
    return "mma" if ok else "cores"


@contextlib.contextmanager
def forced_paged_form(form: Optional[str]):
    """Inside, paged decode plans run ``form`` (``"cores"`` or ``"mma"``;
    None: the rule's), passed to the library as its form code. For the
    tests and the timing tools."""
    if form is not None and form not in PAGED_FORMS:
        raise ValueError(f"no paged decode form {form!r}")
    old, _FORCED_FORM[0] = _FORCED_FORM[0], form
    paged_decode_plan.cache_clear()
    try:
        yield
    finally:
        _FORCED_FORM[0] = old
        paged_decode_plan.cache_clear()


def mma_split_plan(b: int, hkv: int, g: int, dh: int, page_size: int,
                   n_pages: int, page_itemsize: int, n_sm: int) -> tuple:
    """(keys per tile, pages per split, splits) of the tensor-core form:
    ``split_plan``'s rule over its own tiles and CTAs (one per row, KV
    head and split; no chunks of the group): one launch up to
    ``_PAGED_MMA_ONE_LAUNCH_TILES`` tiles of table, there the whole table
    in one tile where two stages of it fit the shared memory (the serving
    runs' short tables: each warp's chunks in one round of the ring);
    else
    contiguous ranges of whole tiles until the CTAs number
    ``_PAGED_MMA_WAVES`` per SM where a CTA is 4 warps, one per SM where it
    is larger, a CTA holding at most ``_PAGED_MAX_PPS`` page-table
    entries."""
    kt = paged_mma_tile(page_size)
    tile_pages = kt // page_size
    n_tiles = _ceil(n_pages, tile_pages)
    splits = 1
    if n_tiles <= _PAGED_MMA_ONE_LAUNCH_TILES:
        for k in range(n_tiles, 1, -1):  # the whole table in one tile
            if paged_mma_smem(g, dh, k * kt, k * tile_pages, page_itemsize,
                              page_itemsize == 1) <= SMEM_OPTIN:
                kt, tile_pages = k * kt, k * tile_pages
                break
        n_tiles = _ceil(n_pages, tile_pages)
    else:
        waves = _PAGED_MMA_WAVES if np.prod(paged_mma_warps(g, dh)) == 4 \
            else 1
        splits = min(n_tiles, _ceil(waves * n_sm, max(b * hkv, 1)))
    tiles_per_split = min(_ceil(n_tiles, splits),
                          max(1, _PAGED_MAX_PPS // tile_pages))
    pps = tiles_per_split * tile_pages
    return kt, pps, _ceil(n_pages, pps)


def paged_mma_smem(g: int, dh: int, keys_per_tile: int,
                   pages_per_split: int, page_itemsize: int,
                   quant: bool) -> int:
    """``mma_layout(...).total`` of csrc/paged_decode.cu: 1024 bytes of
    alignment slack; the ring (1024-byte stages of a K and a V tile in
    128-byte column blocks, and int8 scales; up to 4 within 96 KiB, at
    least 2), reused for the key slices' outputs (rows of Dh floats and 8,
    int8 16, of padding), maxima, sums and weights; q (16 rows a row tile,
    Dh bf16 each padded by 16 bytes), the
    mbarriers and key-visible bytes of 4 stages, and the page ids."""
    def r16(n):
        return _ceil(n, 16) * 16
    mt, _, ks = paged_mma_warps(g, dh)
    rows, kt = 16 * mt, keys_per_tile
    kv = kt * dh * page_itemsize
    stage = _ceil(2 * kv + 8 * kt * int(quant), 1024) * 1024
    stages = min(_PAGED_STAGES, max(2, _PAGED_MMA_RING_BYTES // stage))
    # the slices' output rows padded by 8 floats (int8: 16)
    merge = 4 * (ks * rows * (dh + (16 if quant else 8)) + ks * rows * 2
                 + rows * ks + 2 * rows)
    bar = r16(max(stages * stage, merge)) + rows * (2 * dh + 16)
    return r16(bar + 16 * _PAGED_STAGES + _PAGED_STAGES * kt) \
        + 4 * pages_per_split + 1024


def split_plan(b: int, hkv: int, g: int, dh: int, page_size: int,
               n_pages: int, page_itemsize: int, n_sm: int) -> tuple:
    """(keys per tile, pages per split, splits) of the paged-decode kernel.
    A split beyond the first costs the merge launch: on the card about as
    much as three tiles of one CTA, and on the host a second launch in a
    decode step that waits on the host. So a row whose table holds at most
    ``_PAGED_ONE_LAUNCH_TILES`` tiles (the serving runs' 10-page tables)
    runs in one launch with the epilogue in the kernel; a longer row is cut
    into contiguous ranges of whole tiles until the (row, KV head, chunk
    of 8 query heads, split) CTAs number ``_PAGED_WAVES`` per SM. A CTA
    holds at most ``_PAGED_MAX_PPS`` page-table entries."""
    kt = paged_tile(g, dh, page_size, page_itemsize)
    tile_pages = kt // page_size
    n_tiles = _ceil(n_pages, tile_pages)
    splits = 1
    if n_tiles > _PAGED_ONE_LAUNCH_TILES:
        splits = min(n_tiles, _ceil(_PAGED_WAVES * n_sm,
                                    max(b * hkv * paged_chunks(g), 1)))
    tiles_per_split = min(_ceil(n_tiles, splits),
                          max(1, _PAGED_MAX_PPS // tile_pages))
    pps = tiles_per_split * tile_pages
    return kt, pps, _ceil(n_pages, pps)


def paged_smem(g: int, dh: int, keys_per_tile: int, pages_per_split: int,
               page_itemsize: int, quant: bool) -> int:
    """``layout<PT>(...).total`` of csrc/paged_decode.cu: the ring of K/V
    tiles (and int8 scales; 128-byte stages, up to 4 within 96 KiB, at
    least one),
    reused for the warps' states, then q in the Dh bucket, the stages'
    full and empty mbarriers and key-visible bytes, and the CTA's page
    ids; for at most 8 heads (a CTA's chunk of a larger group)."""
    def r16(n):
        return _ceil(n, 16) * 16
    g = min(g, PAGED_MAX_G)
    kt = keys_per_tile
    stage = _ceil(2 * kt * dh * page_itemsize + 8 * kt * int(quant), 128) \
        * 128
    stages = min(_PAGED_STAGES, max(1, _PAGED_RING_BYTES // stage))
    w = _PAGED_WARPS
    merge = 4 * (w * g * dh + w * g * 2 + g * w + 2 * g)
    bar = r16(max(stages * stage, merge)) + 4 * g * paged_bucket(dh)
    return r16(bar + 16 * _PAGED_STAGES + _PAGED_STAGES * kt) \
        + 4 * pages_per_split


@functools.lru_cache(maxsize=4096)
def paged_decode_plan(b: int, hkv: int, g: int, dh: int, page_size: int,
                      n_pages: int, pool: int, dtype: str, *, quant: bool,
                      window: Optional[int], n_sm: int) -> LaunchPlan:
    """The plan of ``paged_decode_attention`` (``quant``: int8 pages with
    f32 per-token scales) in ``paged_rule``'s form, left to the library's
    own rule, which must agree (inside ``forced_paged_form``, the forced
    form, passed to the library). The CUDA-core form: CTA (s, h *
    nc + c, b), nc = ceil(G / 8), reads row b's page-table entries [s pps,
    (s + 1) pps), then each mapped page of them that lies in its visible
    range, KV head h, for query heads [8c, min(G, 8c + 8)). The
    tensor-core form: CTA (s, h, b) the same for the whole group. With more
    than one split a CTA writes unnormalised partial outputs with their
    running max and sum, and the merge kernel's CTA (h, b, z) combines them
    in split order for 256 output elements of the row's G x Dh."""
    size = _itemsize(dtype)
    psize = 1 if quant else size
    forced = _FORCED_FORM[0]
    form = forced or paged_rule(g, dh, page_size, dtype, quant)
    mma = form == "mma"
    if forced == "mma" and not paged_mma_legal(g, dh, dtype, quant):
        raise ValueError(f"the tensor-core form cannot take G {g}, Dh {dh} "
                         f"of {dtype} (int8 pages: {quant})")
    kt, pps, n_splits = (mma_split_plan if mma else split_plan)(
        b, hkv, g, dh, page_size, n_pages, psize, n_sm)
    buffers = {
        "q": Buffer((b, hkv, g, dh), size, "in"),
        "k_pages": Buffer((pool, page_size, hkv, dh), psize, "in"),
        "v_pages": Buffer((pool, page_size, hkv, dh), psize, "in"),
        "page_table": Buffer((b, n_pages), 4, "in"),
        "lengths": Buffer((b,), 4, "in"),
        # as the kernels index it: (g, d) flattened
        "out": Buffer((b, hkv, g * dh), size, "out"),
    }
    if quant:
        buffers["k_scale"] = Buffer((pool, page_size), 4, "in")
        buffers["v_scale"] = Buffer((pool, page_size), 4, "in")

    nc = 1 if mma else paged_chunks(g)

    def heads(c):
        """(KV head, first query head, one past the last) of CTAs c."""
        if mma:
            return c[:, 1], np.zeros(len(c), np.int64), np.full(len(c), g)
        h, g0 = c[:, 1] // nc, c[:, 1] % nc * PAGED_MAX_G
        return h, g0, np.minimum(g0 + PAGED_MAX_G, g)

    def split_writes(c):
        s, r = c[:, 0], c[:, 2]
        h, g0, g1 = heads(c)
        n = len(c)
        if n_splits == 1:
            return [_box("out", n, (r, r + 1), (h, h + 1),
                         (g0 * dh, g1 * dh))]
        part = ((r, r + 1), (h, h + 1), (s, s + 1))
        return [_box("part_o", n, *part, (g0 * dh, g1 * dh)),
                _box("part_ml", n, *part, (g0, g1), (0, 2))]

    def split_reads(c, pats):
        s, r = c[:, 0], c[:, 2]
        h, g0, g1 = heads(c)
        n = len(c)
        table, lengths = pats["page_table"], pats["lengths"]
        out = [_box("q", n, (r, r + 1), (h, h + 1), (g0, g1), (0, dh)),
               _box("lengths", n, (r, r + 1))]
        ln = lengths[np.minimum(r, len(lengths) - 1)].astype(np.int64)
        lo = np.maximum(0, ln - window) if window is not None \
            else np.zeros(n, np.int64)
        p_row_end = np.where(ln > 0, np.minimum(n_pages,
                                                _ceil_arr(ln, page_size)), 0)
        t_end = np.minimum(n_pages, (s + 1) * pps)
        p_first = np.maximum(lo // page_size, s * pps)
        p_end = np.minimum(p_row_end, t_end)
        # every entry of the CTA's range, read before the row length
        out.append(_box("page_table", n, (r, r + 1), (s * pps, t_end)))
        for p in range(pps):
            page = s * pps + p
            pc = np.minimum(page, n_pages - 1)
            pid = table[np.minimum(r, table.shape[0] - 1), pc].astype(
                np.int64)
            skip = (page < p_first) | (page >= p_end) | (pid < 0)
            for k in ("k_pages", "v_pages"):
                out.append(_empty_where(_box(
                    k, n, (pid, pid + 1), (0, page_size), (h, h + 1),
                    (0, dh)), skip))
            if quant:
                for k in ("k_scale", "v_scale"):
                    out.append(_empty_where(_box(
                        k, n, (pid, pid + 1), (0, page_size)), skip))
        return out

    tiles = (("keys_per_tile", kt, page_size, False),
             ("Dh bytes", dh * psize, 128 if mma else 16, False),
             ("n_pages", n_pages, pps, True))
    if mma:
        tiles += (("keys_per_tile (16-key chunks)", kt, 16, False),)
        kernel, threads = "paged_decode_mma_kernel", 32 * int(
            np.prod(paged_mma_warps(g, dh)))
        smem = paged_mma_smem(g, dh, kt, pps, psize, quant)
    else:
        kernel, threads = "paged_decode_kernel", _PAGED_THREADS
        smem = paged_smem(g, dh, kt, pps, psize, quant)
    split = Launch(
        kernel=kernel, grid=(n_splits, hkv * nc, b), threads=threads,
        smem=smem,
        writes=split_writes, reads=split_reads, fan_in=n_splits,
        fan_in_axis="x" if n_splits > 1 else "loop",
        slots=lambda c: (c[:, 0], c[:, 0] + 1), epilogue=n_splits == 1,
        tiles=tiles)
    name = "paged_decode_attention_quant" if quant \
        else "paged_decode_attention"
    args = dict(B=b, Hkv=hkv, G=g, Dh=dh, page_size=page_size,
                n_pages=n_pages, keys_per_tile=kt, pages_per_split=pps,
                dtype=_code(dtype), quant=int(quant),
                form=-1 if forced is None else PAGED_FORMS.index(form))
    if n_splits == 1:
        return LaunchPlan(name, buffers, (split,), 1, args)
    buffers["part_o"] = Buffer((b, hkv, n_splits, g * dh), 4, "scratch")
    buffers["part_ml"] = Buffer((b, hkv, n_splits, g, 2), 4, "scratch")
    # CTA (h, r, z) owns elements [256 z, 256 z + 256) of the row's g x dh
    # output and reads the max and sum of every head
    gd = g * dh

    def elems(c):
        e0 = c[:, 2] * _PAGED_MERGE_THREADS
        return e0, np.minimum(e0 + _PAGED_MERGE_THREADS, gd)

    def merge_writes(c):
        h, r = c[:, 0], c[:, 1]
        return [_box("out", len(c), (r, r + 1), (h, h + 1), elems(c))]

    def merge_reads(c, pats):
        h, r = c[:, 0], c[:, 1]
        n = len(c)
        part = ((r, r + 1), (h, h + 1), (0, n_splits))
        return [_box("part_o", n, *part, elems(c)),
                _box("part_ml", n, *part, (0, g), (0, 2))]

    merge = Launch(
        kernel="paged_decode_merge_kernel",
        grid=(hkv, b, _ceil(gd, _PAGED_MERGE_THREADS)),
        threads=_PAGED_MERGE_THREADS, smem=0, writes=merge_writes,
        reads=merge_reads, fan_in=n_splits, fan_in_axis="loop",
        slots=lambda c: (np.zeros(len(c), np.int64),
                         np.full(len(c), n_splits, np.int64)),
        epilogue=True, tiles=(("g*dh", gd, _PAGED_MERGE_THREADS, True),))
    return LaunchPlan(name, buffers, (split, merge), n_splits, args)


def _ceil_arr(a: np.ndarray, b: int) -> np.ndarray:
    return -(-a // b)


# ---------------------------------------------------------------------------
# csrc/flash_attention.cu
# ---------------------------------------------------------------------------

_FLASH_F32_ROWS = 64      # rows of an f32 CTA (all three kernels)
_FLASH_F32_THREADS = 256
_FLASH_THREADS = 384      # bf16: a producer warpgroup and two consumers
_FLASH_BOX = 128          # bytes of one 128-byte-swizzled box row
_FLASH_STAGES = 2


def _flash_bucket(dh: int) -> int:
    """The head-dim bucket of the kernels' register arrays and tiles."""
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


def flash_tiles(dtype: str, dh: int) -> Dict[str, Dict[str, int]]:
    """Per kernel (``fwd``, ``dq``, ``dkv``): the rows a CTA owns (queries,
    keys for dk/dv), the rows it streams per stage (keys, queries for
    dk/dv) and its threads (``flash_attention.cu``: ``Tiles<DH>`` for
    bf16, ``Layout`` / ``Engine<float>`` for f32)."""
    if dtype == "float32":
        return {k: dict(rows=_FLASH_F32_ROWS, stream=32,
                        threads=_FLASH_F32_THREADS)
                for k in ("fwd", "dq", "dkv")}
    wide = _flash_bucket(dh) == 256
    return {"fwd": dict(rows=128, stream=64 if wide else 128,
                        threads=_FLASH_THREADS),
            "dq": dict(rows=128, stream=64, threads=_FLASH_THREADS),
            "dkv": dict(rows=64 if wide else 128, stream=64,
                        threads=_FLASH_THREADS)}


def flash_smem(dtype: str, dh: int) -> Dict[str, int]:
    """Dynamic shared memory of the forward, dq and dk/dv kernels at head
    dim ``dh``: bf16 ``Tiles<DH>`` (1024 bytes of alignment, the owned
    tiles, two stages of the streamed ones, dk/dv's per-stage lse and D,
    the mbarriers of one ring, or of separate K and V rings in the forward
    and dq, dq's V ring of one stage at Dh 256); f32 ``Layout<float,
    DHMAX>`` (two stream stages where they fit)."""
    if dtype != "float32":
        nb = _flash_bucket(dh) // 64
        t = flash_tiles(dtype, dh)
        box = _FLASH_BOX

        def ring(k):
            return _FLASH_STAGES * 2 * nb * t[k]["stream"] * box

        def bars(rings):
            return 8 * (1 + 2 * _FLASH_STAGES * rings)
        v_slots = 1 if nb == 4 else _FLASH_STAGES  # dq's V at Dh 256
        return {"fwd": 1024 + nb * 128 * box + ring("fwd") + bars(2),
                "dq": 1024 + 2 * nb * 128 * box
                + (_FLASH_STAGES + v_slots) * nb * t["dq"]["stream"] * box
                + bars(2),
                "dkv": 1024 + 2 * nb * t["dkv"]["rows"] * box + ring("dkv")
                + _FLASH_STAGES * 2 * t["dkv"]["stream"] * 4 + bars(1)}
    rows, c, pad = _FLASH_F32_ROWS, 32, 4
    ld = dh + pad
    own = rows * ld * 4
    stream = c * ld * 4
    scores = rows * (c + 4) * 4
    need = {
        "fwd": lambda s: own + 2 * s * stream + scores + rows * 4,
        "dq": lambda s: 2 * own + 2 * s * stream + 2 * scores + 2 * rows * 4,
        "dkv": lambda s: 2 * own + s * (2 * stream + 2 * c * 4)
        + 2 * scores,
    }
    return {k: fn(2) if fn(2) <= SMEM_OPTIN else fn(1)
            for k, fn in need.items()}


def _key_range(q0, rows, sq, skv, causal, window, q_offset):
    """Keys [lo, hi) that some query of [q0, q0 + rows) may see."""
    q_last = np.minimum(q0 + rows, sq) - 1
    lo = np.zeros_like(q0)
    hi = np.full_like(q0, skv)
    if causal:
        hi = np.minimum(hi, q_last + q_offset + 1)
    if window is not None:
        lo = np.maximum(lo, q0 + q_offset - window + 1)
    return lo, np.maximum(lo, hi)


def _query_range(k0, rows, sq, skv, causal, window, q_offset):
    """Queries [lo, hi) that may see some key of [k0, k0 + rows)."""
    k_last = np.minimum(k0 + rows, skv) - 1
    lo = np.zeros_like(k0)
    hi = np.full_like(k0, sq)
    if causal:
        lo = np.maximum(lo, k0 - q_offset)
    if window is not None:
        hi = np.minimum(hi, k_last - q_offset + window)
    lo = np.clip(lo, 0, sq)
    return lo, np.clip(hi, lo, sq)


@functools.lru_cache(maxsize=1024)
def flash_plan(b: int, sq: int, skv: int, hq: int, hkv: int, dh: int,
               dtype: str, *, causal: bool, window: Optional[int],
               q_offset: int, backward: bool) -> LaunchPlan:
    """The plan of ``flash_attention_fwd`` (CTA (t, h, b): query rows
    [R t, R t + R) of head h, looping over the key tiles they can see; R =
    128 in bf16, 64 in f32) or of ``flash_attention_bwd`` (dq as the
    forward's grid, writing D; then dk/dv, CTA (t, hk, b): key rows
    [R' t, R' t + R') of KV head hk, R' = 128 in bf16 up to Dh 128, else
    64, looping over the G query heads and the query tiles that see them).
    Each launch's ``tiles`` give its rows per
    CTA and its streamed tile (``flash_tiles``). The bf16 kernels read
    their (tile, head, batch row) from the linear CTA index, tile slowest
    and longest first (``tile_of``); that is a permutation of the grid,
    which changes no box this plan lists."""
    size = _itemsize(dtype)
    grp = hq // hkv
    smem = flash_smem(dtype, dh)
    tl = flash_tiles(dtype, dh)
    qshape, kshape = (b, sq, hq, dh), (b, skv, hkv, dh)
    buffers = {"q": Buffer(qshape, size, "in"),
               "k": Buffer(kshape, size, "in"),
               "v": Buffer(kshape, size, "in")}
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    args = dict(B=b, Sq=sq, Skv=skv, Hq=hq, Hkv=hkv, Dh=dh,
                dtype=_code(dtype), backward=int(backward))
    slots = dict(fan_in=1, fan_in_axis="loop", epilogue=True,
                 slots=lambda c: (np.zeros(len(c), np.int64),
                                  np.ones(len(c), np.int64)))

    def q_launch(key, writes, reads):
        t = tl[key]
        rows = t["rows"]

        def q_rows(c):
            q0 = c[:, 0] * rows
            return q0, np.minimum(q0 + rows, sq), c[:, 1], c[:, 2]

        def q_side(c, names, lse_names):
            q0, q1, h, r = q_rows(c)
            n = len(c)
            return ([_box(k, n, (r, r + 1), (q0, q1), (h, h + 1), (0, dh))
                     for k in names]
                    + [_box(k, n, (r, r + 1), (h, h + 1), (q0, q1))
                       for k in lse_names])

        def kv_reads(c):
            q0, _, h, r = q_rows(c)
            lo, hi = _key_range(q0, rows, sq, skv, **kw)
            hk = h // grp
            return [_box(k, len(c), (r, r + 1), (lo, hi), (hk, hk + 1),
                         (0, dh)) for k in ("k", "v")]

        return Launch(
            kernel=names[key], grid=(_ceil(sq, rows), hq, b),
            threads=t["threads"], smem=smem[key],
            writes=lambda c: q_side(c, *writes),
            reads=lambda c, p: q_side(c, *reads) + kv_reads(c),
            tiles=(("Dh", dh, 16, False), ("Sq", sq, rows, True),
                   ("Skv", skv, t["stream"], True)), **slots)

    bf16 = dtype != "float32"
    names = {"fwd": "flash_fwd_wgmma_kernel" if bf16 else "flash_fwd_kernel",
             "dq": "flash_dq_wgmma_kernel" if bf16 else "flash_dq_kernel",
             "dkv": "flash_dkv_wgmma_kernel" if bf16
             else "flash_dkv_kernel"}
    if not backward:
        buffers["out"] = Buffer(qshape, size, "out")
        buffers["lse"] = Buffer((b, hq, sq), 4, "out")
        fwd = q_launch("fwd", (("out",), ("lse",)), (("q",), ()))
        return LaunchPlan("flash_attention_fwd", buffers, (fwd,), 1, args)

    for k in ("o", "dout"):
        buffers[k] = Buffer(qshape, size, "in")
    buffers["lse"] = Buffer((b, hq, sq), 4, "in")
    buffers["dq"] = Buffer(qshape, size, "out")
    buffers["dk"] = Buffer(kshape, size, "out")
    buffers["dv"] = Buffer(kshape, size, "out")
    buffers["delta"] = Buffer((b, hq, sq), 4, "scratch")
    dq = q_launch("dq", (("dq",), ("delta",)),
                  (("q", "o", "dout"), ("lse",)))
    krows, qtile = tl["dkv"]["rows"], tl["dkv"]["stream"]

    def dkv_writes(c):
        k0 = c[:, 0] * krows
        k1 = np.minimum(k0 + krows, skv)
        hk, r = c[:, 1], c[:, 2]
        return [_box(k, len(c), (r, r + 1), (k0, k1), (hk, hk + 1), (0, dh))
                for k in ("dk", "dv")]

    def dkv_reads(c, pats):
        k0 = c[:, 0] * krows
        hk, r = c[:, 1], c[:, 2]
        n = len(c)
        lo, hi = _query_range(k0, krows, sq, skv, **kw)
        out = [_box(k, n, (r, r + 1), (k0, np.minimum(k0 + krows, skv)),
                    (hk, hk + 1), (0, dh)) for k in ("k", "v")]
        for gi in range(grp):
            h = hk * grp + gi
            out += [_box(k, n, (r, r + 1), (lo, hi), (h, h + 1), (0, dh))
                    for k in ("q", "dout")]
            out += [_box(k, n, (r, r + 1), (h, h + 1), (lo, hi))
                    for k in ("lse", "delta")]
        return out

    dkv = Launch(
        kernel=names["dkv"], grid=(_ceil(skv, krows), hkv, b),
        threads=tl["dkv"]["threads"], smem=smem["dkv"], writes=dkv_writes,
        reads=dkv_reads,
        tiles=(("Dh", dh, 16, False), ("Skv", skv, krows, True),
               ("Sq", sq, qtile, True)), **slots)
    return LaunchPlan("flash_attention_bwd", buffers, (dq, dkv), 1, args)


# ---------------------------------------------------------------------------
# the libraries' own plans
# ---------------------------------------------------------------------------

# plan name -> (source, exported plan function, its int arguments in order)
PLAN_EXPORTS = {
    "csd_spmm_fwd": ("csd_spmm_fwd", "csd_spmm_fwd_plan",
                     ("E", "M", "n_rb", "bR", "n_splits", "n_sm", "tile_n",
                      "dtype")),
    "csd_spmm_fwd_quant": ("csd_spmm_fwd_quant", "csd_spmm_fwd_quant_plan",
                           ("E", "M", "n_rb", "d_in_b", "bR", "n_splits",
                            "n_sm", "body", "tile_m", "tile_n", "cluster",
                            "dtype")),
    "csd_spmm_dx": ("csd_spmm_dx", "csd_spmm_dx_plan",
                    ("E", "M", "n_lb", "bL", "dtype", "n_ctas")),
    "csd_spmm_dw": ("csd_spmm_dw", "csd_spmm_dw_plan",
                    ("E", "n_rb", "d_in_b", "bL", "bR", "dtype")),
    "csd_mask_cotangent": ("csd_mask_cotangent", "csd_mask_cotangent_plan",
                           ("rows", "n_out", "dtype")),
    "paged_decode_attention": (
        "paged_decode", "paged_decode_attention_plan",
        ("B", "Hkv", "G", "Dh", "page_size", "n_pages", "keys_per_tile",
         "pages_per_split", "dtype", "quant", "form")),
    "flash_attention_fwd": ("flash_attention", "flash_attention_plan",
                            ("B", "Sq", "Skv", "Hq", "Hkv", "Dh", "dtype",
                             "backward")),
    "csd_spmm_fwd_small": ("csd_spmm_small", "csd_spmm_small_gather_plan",
                           ("E", "n_ob", "ow", "iw", "in_cols", "n_slots",
                            "dtype", "R", "ncg", "ks", "stages", "Y")),
    "csd_spmm_dw_small": ("csd_spmm_small_dw", "csd_spmm_small_dw_plan",
                          ("E", "n_lb", "cluster", "dtype")),
    "csd_spmm_fwd_injected_alias": (
        "csd_spmm_fwd_injected_alias", "csd_spmm_fwd_injected_alias_plan",
        ("E", "M", "n_rb", "bR", "d_in_b", "dtype")),
}
PLAN_EXPORTS["paged_decode_attention_quant"] = \
    PLAN_EXPORTS["paged_decode_attention"]
PLAN_EXPORTS["flash_attention_bwd"] = PLAN_EXPORTS["flash_attention_fwd"]
PLAN_EXPORTS["csd_spmm_dx_small"] = PLAN_EXPORTS["csd_spmm_fwd_small"]
PLAN_EXPORTS["csd_spmm_fwd_quant_small"] = PLAN_EXPORTS["csd_spmm_fwd_small"]


def library_dims(plan: LaunchPlan
                 ) -> List[Tuple[Tuple[int, int, int], int, int, int]]:
    """(grid, threads, shared memory, cluster size) of every launch the
    kernel's library makes for the plan's arguments, from its exported
    ``<name>_plan`` (which shares the launcher's host code); builds the
    library if needed. ``plan.dims()`` must equal it."""
    import ctypes

    from . import build
    source, export, names = PLAN_EXPORTS[plan.name]
    fn = getattr(build.load(source), export)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(names) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    k = 6  # ints per launch (plan.cuh, plan::put)
    out = (ctypes.c_int * (2 * k))()
    n = fn(*[int(plan.args[a]) for a in names], ctypes.addressof(out))
    if n < 0:
        raise ValueError(f"{export} refused {plan.args}")
    return [((out[k * i], out[k * i + 1], out[k * i + 2]), out[k * i + 3],
             out[k * i + 4], out[k * i + 5]) for i in range(n)]
