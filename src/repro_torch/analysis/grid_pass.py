"""Pass 1 — launch-plan analysis of the port's CUDA kernels (the port's
counterpart of ``repro.analysis.grid_pass``).

The TPU runs a Pallas grid in order on one core, and the reference's
checks are about revisits of a tile in that order. On the GPU the CTAs of
a launch run concurrently, in any order, so the checks here are about who
writes what. For every CTA of every launch of a captured ``LaunchPlan``
(``capture.py``) the pass evaluates the plan's ``writes`` and ``reads``
boxes — following the real pattern arrays, page tables and lengths — and
proves, per kernel case:

* **SL101 (races)** — every element of every buffer a launch writes is
  written by exactly one of its CTAs: two CTAs that store one tile race,
  whatever their indices, and an element no CTA stores is garbage. Scratch
  buffers count as outputs (each (split, tile) of the forward's partial
  sums has one writer), and a later launch may read only scratch an
  earlier launch of the call wrote.
* **SL102 (divisibility)** — every tile divides the extent it cuts, unless
  the plan declares that edge masked (the M tails); a thread-block cluster
  tiles its grid and holds at most 8 CTAs (the portable size).
* **SL103 (epilogue)** — the bias / activation / pre-activation / softmax
  normalisation epilogue fires exactly once per element of each of the
  call's outputs, in a CTA that runs the whole fan-in: the CTA itself when
  the fan-in is a loop inside it (``n_splits == 1``), the rank that adds
  its thread-block cluster's sums when the cluster splits it (its slots
  are the cluster's), else the reduce or merge launch; never in a split
  CTA.
* **SL104 (shared memory)** — dynamic shared memory per CTA within the
  budget: the H100's opt-in maximum of 227 KiB (232,448 B) by default; the
  CLI reads the card's own with ``--device cuda``.
* **SL105 (bounds)** — every read and write box lies inside its tensor; a
  corrupt ``block_idx``, ``out_idx``/``out_slot`` or page-table entry
  surfaces here.

Coverage is counted exactly on the grid of the boxes' own boundaries
(coordinate compression), so a full-width plan of ten thousand CTAs costs
a few numpy passes. Each case also gets a cost report: grid, CTA count,
shared memory per CTA and the bytes its CTAs load from and store to
global memory.

The registry (``kernel_cases``) holds every shipped kernel family at a
demo size like the reference's (128 x 128 blocks, 4 x 4 at density 0.5)
and at the full-width junction and attention shapes of gemma3-4b and
granite-moe-1b-a400m at the M values ``chip_smoke.py`` runs (decode M 4,
training M 4096 or 1280 rows per expert). ``--selftest-inject`` adds TPU
kernel #9's counterpart, the race-broken forward of
``csrc/csd_spmm_fwd_injected_alias.cu`` (``injected_alias_case``), which
must give exactly ``["SL101"]``. The 4-D dx case on a shard-local pattern
(``out_valid``) waits for the multi-device slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import csd_spmm, launch
from ..kernels.launch import Access, LaunchPlan
from .capture import capture_launch
from .findings import Finding

DEFAULT_SMEM_BUDGET = launch.SMEM_OPTIN


# ---------------------------------------------------------------------------
# coverage on the compressed grid of box boundaries
# ---------------------------------------------------------------------------


def _nonempty(a: Access) -> np.ndarray:
    return (a.hi > a.lo).all(axis=1)


def _stack(accs: Sequence[Access]) -> Tuple[np.ndarray, np.ndarray]:
    keep = [_nonempty(a) for a in accs]
    lo = np.concatenate([a.lo[k] for a, k in zip(accs, keep)])
    hi = np.concatenate([a.hi[k] for a, k in zip(accs, keep)])
    return lo, hi


class _Grid:
    """The cells between the distinct boundaries of some boxes of one
    tensor, with an exact per-cell count of the boxes that cover them."""

    def __init__(self, shape, lo, hi, extra=()):
        self.bounds = [np.unique(np.concatenate(
            [[0, n], lo[:, d], hi[:, d]] + [e[:, d] for e in extra]))
            for d, n in enumerate(shape)]
        self.counts = self.count(lo, hi)

    def _index(self, lo, hi):
        return ([np.searchsorted(b, lo[:, d]) for d, b in
                 enumerate(self.bounds)],
                [np.searchsorted(b, hi[:, d]) for d, b in
                 enumerate(self.bounds)])

    def count(self, lo, hi) -> np.ndarray:
        """How many of the boxes cover each cell."""
        rank = len(self.bounds)
        diff = np.zeros([len(b) for b in self.bounds], np.int64)
        ilo, ihi = self._index(lo, hi)
        for corner in np.ndindex(*([2] * rank)):
            sign = (-1) ** sum(corner)
            idx = tuple(ihi[d] if c else ilo[d] for d, c in enumerate(corner))
            np.add.at(diff, idx, sign)
        for d in range(rank):
            diff = np.cumsum(diff, axis=d)
        return diff[tuple(slice(0, len(b) - 1) for b in self.bounds)]

    def cell_start(self, cell) -> Tuple[int, ...]:
        return tuple(int(b[i]) for b, i in zip(self.bounds, cell))

    def box_sums(self, values: np.ndarray, lo, hi) -> np.ndarray:
        """Sum of ``values`` (one per cell) over each box, whose bounds must
        be among the grid's."""
        rank = len(self.bounds)
        sat = np.pad(values, [(1, 0)] * rank)
        for d in range(rank):
            sat = np.cumsum(sat, axis=d)
        ilo, ihi = self._index(lo, hi)
        total = np.zeros(len(lo), np.int64)
        for corner in np.ndindex(*([2] * rank)):
            sign = (-1) ** (rank - sum(corner))
            idx = tuple(ihi[d] if c else ilo[d] for d, c in enumerate(corner))
            total += sign * sat[idx]
        return total


def _clip(plan: LaunchPlan, name: str, lo, hi):
    shape = np.asarray(plan.buffers[name].shape)
    return np.clip(lo, 0, shape), np.clip(hi, 0, shape)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def analyze_plan(plan: LaunchPlan, subject: str,
                 smem_budget: int = DEFAULT_SMEM_BUDGET
                 ) -> Tuple[List[Finding], dict]:
    """Run all grid-pass checks on one plan; (findings, cost)."""
    findings: List[Finding] = []
    pats = plan.pattern_arrays()
    written: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
    epilogue: Dict[str, List[Tuple[np.ndarray, np.ndarray]]] = {}
    non_epilogue_out = []
    bytes_read = bytes_written = 0
    for li, ln in enumerate(plan.launches):
        where = f"launch {li} ({ln.kernel}, grid {ln.grid})"
        # -- SL104: shared memory per CTA ---------------------------------
        if ln.smem > smem_budget:
            findings.append(Finding(
                "SL104", subject,
                f"{where}: {ln.smem} B of dynamic shared memory per CTA "
                f"exceeds the budget of {smem_budget} B",
                {"smem": ln.smem, "budget": smem_budget}))
        # -- SL102: tiles that do not divide an unmasked extent -----------
        for what, extent, tile, masked in ln.tiles:
            if tile <= 0 or (extent % tile and not masked):
                findings.append(Finding(
                    "SL102", subject,
                    f"{where}: tile {tile} does not divide {what} = "
                    f"{extent} and the kernel does not mask that edge",
                    {"what": what, "extent": extent, "tile": tile}))
        if any(g % c for g, c in zip(ln.grid, ln.cluster)) \
                or math.prod(ln.cluster) > 8:
            findings.append(Finding(
                "SL102", subject,
                f"{where}: cluster {ln.cluster} does not tile the grid or "
                f"holds more than 8 CTAs", {"cluster": list(ln.cluster)}))
        ctas = ln.ctas()
        writes = ln.written(ctas, pats)
        reads = ln.reads(ctas, pats)
        bytes_read += _bytes(plan, reads)
        bytes_written += _bytes(plan, writes)
        # -- SL105: every box inside its tensor ---------------------------
        for kind, accs in (("write", writes), ("read", reads)):
            for a in accs:
                shape = np.asarray(plan.buffers[a.buffer].shape)
                bad = _nonempty(a) & ((a.lo < 0) | (a.hi > shape)).any(1)
                if bad.any():
                    i = int(np.flatnonzero(bad)[0])
                    findings.append(Finding(
                        "SL105", subject,
                        f"{where}: CTA {tuple(int(v) for v in ctas[i])} "
                        f"{kind}s {a.buffer}"
                        f"[{_fmt(a.lo[i], a.hi[i])}] outside its shape "
                        f"{tuple(int(v) for v in shape)} "
                        f"({int(bad.sum())} CTA(s))",
                        {"buffer": a.buffer, "ctas": int(bad.sum())}))
        # -- SL101: one writer per element of each written buffer ---------
        by_buf: Dict[str, List[Access]] = {}
        mine: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for a in writes:
            by_buf.setdefault(a.buffer, []).append(a)
        for name, accs in by_buf.items():
            lo, hi = _clip(plan, name, *_stack(accs))
            grid = _Grid(plan.buffers[name].shape, lo, hi)
            multi, holes = grid.counts > 1, grid.counts == 0
            if multi.any():
                cell = tuple(np.argwhere(multi)[0])
                findings.append(Finding(
                    "SL101", subject,
                    f"{where}: {name} element "
                    f"{grid.cell_start(cell)} is written by "
                    f"{int(grid.counts[cell])} CTAs, which run in no "
                    f"order: the last store wins "
                    f"({int(multi.sum())} aliased region(s), up to "
                    f"{int(grid.counts.max())} writers)",
                    {"buffer": name, "writers": int(grid.counts.max())}))
            if holes.any():
                cell = tuple(np.argwhere(holes)[0])
                findings.append(Finding(
                    "SL101", subject,
                    f"{where}: {name} element {grid.cell_start(cell)} is "
                    f"written by no CTA ({int(holes.sum())} region(s) left "
                    f"unwritten)", {"buffer": name}))
            mine[name] = (lo, hi)
        # scratch read by this launch must have been written before it
        scratch = [a for a in reads
                   if plan.buffers[a.buffer].role == "scratch"]
        for name in sorted({a.buffer for a in scratch}):
            rlo, rhi = _clip(plan, name, *_stack(
                [a for a in scratch if a.buffer == name]))
            prior = written.get(name, [])
            if not prior:
                findings.append(Finding(
                    "SL101", subject,
                    f"{where}: reads scratch {name} that no earlier launch "
                    f"wrote", {"buffer": name}))
                continue
            wlo = np.concatenate([w[0] for w in prior])
            whi = np.concatenate([w[1] for w in prior])
            grid = _Grid(plan.buffers[name].shape, wlo, whi,
                         extra=(rlo, rhi))
            unread = grid.box_sums((grid.counts == 0).astype(np.int64),
                                   rlo, rhi)
            if (unread > 0).any():
                findings.append(Finding(
                    "SL101", subject,
                    f"{where}: reads {name} elements no earlier launch "
                    f"wrote ({int((unread > 0).sum())} box(es))",
                    {"buffer": name}))
        for name, box in mine.items():
            written.setdefault(name, []).append(box)
        # -- SL103 bookkeeping --------------------------------------------
        outs = [a for a in writes if plan.buffers[a.buffer].role == "out"]
        if ln.epilogue:
            lo, hi = ln.slots(ctas)
            split = (lo != 0) | (hi != ln.fan_in)
            fires = np.zeros(len(ctas), bool)
            for a in writes:
                fires |= _nonempty(a)
            bad = split & fires
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                findings.append(Finding(
                    "SL103", subject,
                    f"{where}: the epilogue fires in CTA "
                    f"{tuple(int(v) for v in ctas[i])}, which covers only "
                    f"fan-in slots [{int(lo[i])}, {int(hi[i])}) of "
                    f"{ln.fan_in} (fan-in on grid axis {ln.fan_in_axis}): "
                    f"a split CTA finishes outputs from a partial sum",
                    {"ctas": int(bad.sum())}))
            for a in outs:
                epilogue.setdefault(a.buffer, []).append(
                    _clip(plan, a.buffer, *_stack([a])))
        elif outs:
            non_epilogue_out.append((where, sorted({a.buffer
                                                    for a in outs})))

    # -- SL103: exactly one epilogue write per output element ------------
    for where, names in non_epilogue_out:
        findings.append(Finding(
            "SL103", subject,
            f"{where}: stores the call's output(s) {names} without the "
            f"epilogue", {}))
    for name, buf in plan.buffers.items():
        if buf.role != "out":
            continue
        parts = epilogue.get(name, [])
        if not parts:
            findings.append(Finding(
                "SL103", subject, f"no launch finishes output {name}", {}))
            continue
        lo = np.concatenate([p[0] for p in parts])
        hi = np.concatenate([p[1] for p in parts])
        grid = _Grid(buf.shape, lo, hi)
        if (grid.counts != 1).any():
            findings.append(Finding(
                "SL103", subject,
                f"the epilogue of output {name} fires "
                f"{int(grid.counts.min())}..{int(grid.counts.max())} times "
                f"per element across the call's launches, not once",
                {"buffer": name}))
    if any(f.code in ("SL101", "SL105") for f in findings):
        # the epilogue contract is moot where outputs race or run out of
        # bounds; report the root cause alone, as the reference does
        findings = [f for f in findings if f.code != "SL103"]

    cost = {
        "launches": [ln.kernel for ln in plan.launches],
        "grid": [ln.grid for ln in plan.launches],
        "ctas": [ln.n_ctas for ln in plan.launches],
        "smem_per_cta": [ln.smem for ln in plan.launches],
        "n_splits": plan.n_splits,
        "global_bytes_read": bytes_read,
        "global_bytes_written": bytes_written,
    }
    return findings, cost


def _bytes(plan: LaunchPlan, accs: Sequence[Access]) -> int:
    total = 0
    for a in accs:
        vol = np.prod(np.maximum(a.hi - a.lo, 0), axis=1)
        total += int(vol.sum()) * plan.buffers[a.buffer].itemsize
    return total


def _fmt(lo, hi) -> str:
    return ", ".join(f"{int(a)}:{int(b)}" for a, b in zip(lo, hi))


# ---------------------------------------------------------------------------
# Kernel case registry
# ---------------------------------------------------------------------------


class _Maker:
    """Operands of one case on ``device``: ``meta`` float tensors and CPU
    pattern tensors for a capture; random values from ``seed`` on a real
    device (what ``chip_smoke.py`` launches)."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.meta = self.device.type == "meta"
        self.gen = None if self.meta else \
            torch.Generator(device=self.device).manual_seed(seed)

    def randn(self, shape, dtype, scale: float = 1.0):
        if self.meta:
            return torch.empty(shape, dtype=dtype, device="meta")
        return (torch.randn(shape, generator=self.gen, device=self.device)
                * scale).to(dtype)

    def int8(self, shape):
        if self.meta:
            return torch.empty(shape, dtype=torch.int8, device="meta")
        return torch.randint(-127, 128, shape, generator=self.gen,
                             device=self.device, dtype=torch.int8)

    def scales(self, shape):
        if self.meta:
            return torch.empty(shape, dtype=torch.float32, device="meta")
        return (torch.rand(shape, generator=self.gen, device=self.device)
                + 0.5) / 127.0

    def pattern(self, array):
        dev = "cpu" if self.meta else self.device
        return torch.as_tensor(np.asarray(array), dtype=torch.int32,
                               device=dev)


@dataclasses.dataclass
class KernelCase:
    """One registry entry: a port wrapper and how to make its operands."""

    name: str
    fn: Callable
    make_args: Callable[[_Maker], Tuple[tuple, dict]]

    def args(self, device="meta", seed: int = 0) -> Tuple[tuple, dict]:
        return self.make_args(_Maker(device, seed))

    def build(self, n_sm: int = launch.H100_SMS) -> LaunchPlan:
        args, kw = self.args("meta")
        return capture_launch(self.fn, *args, n_sm=n_sm, **kw)


def _demo_pattern(block_in=128, block_out=128, n_lb=4, n_rb=4, rho=0.5,
                  seed=0):
    from ..core.block_pattern import make_block_pattern
    return make_block_pattern(
        n_lb * block_in, n_rb * block_out, rho,
        block_in=block_in, block_out=block_out, seed=seed)


def _fwd_case(name: str, bp, m: int, dtype, *, experts: Optional[int] = None,
              activation: Optional[str] = None, bias: bool = False,
              save_preact: bool = False, quant: bool = False) -> KernelCase:
    lead = () if experts is None else (experts,)

    def make(mk: _Maker):
        shape = lead + (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
        kw = dict(activation=activation)
        if quant:
            w = mk.int8(shape)
            kw["w_scale"] = mk.scales(shape[:-2])
        else:
            w = mk.randn(shape, dtype, 1 / math.sqrt(bp.d_in_b * bp.block_in))
        if bias:
            kw["bias"] = mk.randn(lead + (bp.n_out,), dtype, 0.1)
        if save_preact:
            kw["save_preact"] = True
        x = mk.randn(lead + (m, bp.n_in), dtype)
        return (x, w, mk.pattern(bp.block_idx)), kw

    fn = csd_spmm.csd_spmm_fwd_cuda if experts is None \
        else csd_spmm.csd_spmm_fwd_batched_cuda
    return KernelCase(name, fn, make)


def _dx_case(name: str, bp, m: int, dtype, *,
             experts: Optional[int] = None) -> KernelCase:
    """``csd_spmm_dx`` on a masked cotangent, as the backward launches it
    (the mask is its own launch: ``_mask_case``)."""
    lead = () if experts is None else (experts,)

    def make(mk: _Maker):
        g = mk.randn(lead + (m, bp.n_out), dtype)
        w = mk.randn(lead + (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out),
                     dtype, 1 / math.sqrt(bp.d_in_b * bp.block_in))
        return (g, w, mk.pattern(bp.out_idx), mk.pattern(bp.out_slot)), {}

    fn = csd_spmm.csd_spmm_dx_cuda if experts is None \
        else csd_spmm.csd_spmm_dx_batched_cuda
    return KernelCase(name, fn, make)


def _dw_case(name: str, bp, m: int, dtype, *, experts: Optional[int] = None,
             want_db: bool = False) -> KernelCase:
    """``csd_spmm_dw`` on a masked cotangent, as the backward launches
    it."""
    lead = () if experts is None else (experts,)

    def make(mk: _Maker):
        x = mk.randn(lead + (m, bp.n_in), dtype)
        g = mk.randn(lead + (m, bp.n_out), dtype)
        return (x, g, mk.pattern(bp.block_idx)), dict(
            block_in=bp.block_in, block_out=bp.block_out, want_db=want_db)

    fn = csd_spmm.csd_spmm_dw_cuda if experts is None \
        else csd_spmm.csd_spmm_dw_batched_cuda
    return KernelCase(name, fn, make)


def _mask_case(name: str, m: int, n_out: int, dtype, *,
               experts: Optional[int] = None,
               activation: str = "gelu") -> KernelCase:
    """``csd_mask_cotangent``: the cotangent of an (experts x) M x n_out
    junction output masked once per backward."""
    lead = () if experts is None else (experts,)

    def make(mk: _Maker):
        dy = mk.randn(lead + (m, n_out), dtype)
        return (dy, mk.randn(dy.shape, dtype), activation), {}

    return KernelCase(name, csd_spmm.csd_mask_cotangent_cuda, make)


def _flash_case(name: str, b: int, s: int, hq: int, hkv: int, dh: int,
                dtype, *, window: Optional[int],
                backward: bool) -> KernelCase:
    from ..kernels import flash_attention as fa
    kw = dict(causal=True, window=window)

    def make(mk: _Maker):
        q = mk.randn((b, s, hq, dh), dtype)
        k = mk.randn((b, s, hkv, dh), dtype)
        v = mk.randn((b, s, hkv, dh), dtype)
        if not backward:
            return (q, k, v), kw
        if mk.meta:
            o = torch.empty_like(q)
            lse = torch.empty((b, hq, s), dtype=torch.float32, device="meta")
        else:  # a consistent forward: the backward recomputes P from lse
            o, lse = fa._flash_impl(q.device, False)(q, k, v,
                                                     return_lse=True, **kw)
        return (q, k, v, o, lse, mk.randn(q.shape, dtype)), kw

    fn = fa.flash_attention_bwd_cuda if backward else fa.flash_attention_cuda
    return KernelCase(name, fn, make)


def _page_table(lengths: Sequence[int], n_pages: int, page: int,
                window: Optional[int], seed: int = 1):
    """(table, pool pages): each row's pages mapped to distinct pool pages
    in a shuffled order, -1 for the table's tail and, with a window, for
    the leading pages every query has left (as the engine reclaims them);
    pool page 0 is the engine's write-discard page and stays unmapped."""
    need = sum(-(-n // page) for n in lengths)
    perm = np.random.default_rng(seed).permutation(need) + 1
    table = np.full((len(lengths), n_pages), -1, np.int32)
    k = 0
    for i, n in enumerate(lengths):
        for p in range(-(-n // page)):
            if window is None or (p + 1) * page > n - window:
                table[i, p] = perm[k]
            k += 1
    return table, need + 1


def _paged_case(name: str, hkv: int, g: int, dh: int, dtype, *,
                lengths: Sequence[int], n_pages: int, page: int,
                window: Optional[int], quant: bool) -> KernelCase:
    from ..kernels import flash_attention as fa
    table, pool = _page_table(lengths, n_pages, page, window)

    def make(mk: _Maker):
        b = len(lengths)
        q = mk.randn((b, hkv, g, dh), dtype)
        shape = (pool, page, hkv, dh)
        kw = dict(window=window)
        if quant:
            kp, vp = mk.int8(shape), mk.int8(shape)
            kw.update(k_scale=mk.scales((pool, page)),
                      v_scale=mk.scales((pool, page)))
        else:
            kp, vp = mk.randn(shape, dtype), mk.randn(shape, dtype)
        return (q, kp, vp, mk.pattern(table), mk.pattern(lengths)), kw

    return KernelCase(name, fa.paged_decode_attention_cuda, make)


def demo_cases() -> List[KernelCase]:
    """Every shipped kernel family at the reference's demo size: 128 x 128
    blocks, 4 x 4 at density 0.5, M 256, two experts in the 5-D forms; the
    bf16 backward also at a ragged M of 77 rows over 64 x 64 blocks and
    over three experts; the bf16 forward's wgmma body at a ragged M of
    1000 rows of three experts over 64 x 64 blocks (64-column tiles); the
    bf16 int8 forward's stream body at M 5 (a cluster of 2) and 40 rows of
    three experts, its wgmma body at 300 rows of three experts over 64 x
    64 blocks; the paged decode's tensor-core form over 12-key pages and
    over int8 pages in splits."""
    bp = _demo_pattern()
    bp64 = _demo_pattern(block_in=64, block_out=64, n_lb=4, n_rb=6)
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        _fwd_case("csd_spmm_fwd_4d_relu", bp, 256, f32, activation="relu",
                  bias=True),
        _fwd_case("csd_spmm_fwd_4d_gelu_preact", bp, 256, f32,
                  activation="gelu", bias=True, save_preact=True),
        _fwd_case("csd_spmm_fwd_4d_plain", bp, 256, f32),
        _fwd_case("csd_spmm_fwd_5d_batched", bp, 256, f32, experts=2,
                  activation="relu", bias=True),
        _fwd_case("csd_spmm_fwd_5d_bf16_bl64_e3_m1000", bp64, 1000, bf16,
                  experts=3, activation="gelu", bias=True, save_preact=True),
        _fwd_case("csd_spmm_fwd_quant_4d", bp, 256, f32, activation="relu",
                  bias=True, quant=True),
        _fwd_case("csd_spmm_fwd_quant_5d_batched", bp, 256, f32, experts=2,
                  quant=True),
        _fwd_case("csd_spmm_fwd_quant_4d_bf16_m5", bp, 5, bf16,
                  activation="gelu", bias=True, quant=True),
        _fwd_case("csd_spmm_fwd_quant_5d_bf16_e3_m40", bp, 40, bf16,
                  experts=3, activation="relu", bias=True, quant=True),
        _fwd_case("csd_spmm_fwd_quant_5d_bf16_bl64_e3_m300", bp64, 300,
                  bf16, experts=3, activation="gelu", bias=True,
                  quant=True),
        _dx_case("csd_spmm_dx_4d", bp, 256, f32),
        _dx_case("csd_spmm_dx_5d_batched", bp, 256, f32, experts=2),
        _dw_case("csd_spmm_dw_4d_db", bp, 256, f32, want_db=True),
        _dw_case("csd_spmm_dw_5d_batched", bp, 256, f32, experts=2),
        _dx_case("csd_spmm_dx_4d_bf16_bl64_m77", bp64, 77, bf16),
        _dw_case("csd_spmm_dw_4d_bf16_bl64_m77_db", bp64, 77, bf16,
                 want_db=True),
        _dx_case("csd_spmm_dx_5d_bf16_e3_m77", bp, 77, bf16, experts=3),
        _dw_case("csd_spmm_dw_5d_bf16_e3_m77_db", bp, 77, bf16, experts=3,
                 want_db=True),
        _mask_case("csd_mask_cotangent_relu", 256, bp.n_out, f32,
                   activation="relu"),
        _mask_case("csd_mask_cotangent_5d_gelu", 77, bp.n_out, bf16,
                   experts=3),
        _flash_case("flash_attention_fwd", 2, 256, 4, 2, 64, bf16,
                    window=128, backward=False),
        _flash_case("flash_attention_bwd", 2, 256, 4, 2, 64, bf16,
                    window=128, backward=True),
        _paged_case("paged_decode_attention", 2, 2, 64, bf16,
                    lengths=(19, 10), n_pages=4, page=8, window=None,
                    quant=False),
        _paged_case("paged_decode_attention_quant", 2, 2, 64, bf16,
                    lengths=(19, 10), n_pages=4, page=8, window=None,
                    quant=True),
        # the tensor-core form: 12-key pages (its cp.async copies) under a
        # window in one launch; 48 heads over int8 pages in splits
        _paged_case("paged_decode_attention_mma", 2, 12, 64, bf16,
                    lengths=(150, 37, 0), n_pages=16, page=12, window=100,
                    quant=False),
        _paged_case("paged_decode_attention_quant_mma", 1, 48, 128, bf16,
                    lengths=(600, 3), n_pages=40, page=16, window=None,
                    quant=True),
    ]


# chip_smoke.py's shapes: 4 decode slots, training batch 2 x seq 2048, its
# paged-decode rows (lengths past 1024, one empty, page 16, 72-entry table)
# and a decode step of its serving runs (lengths 97-160, 10-entry table);
# the int8 forward's prefill rows: 4 slots of 8-token chunks (32, the
# stream body's 32-row tile), one 64-token chunk, and 256 (4 slots of 64;
# rows per expert in granite's batched form)
DECODE_M, TRAIN_B, TRAIN_S = 4, 2, 2048
PREFILL_SMALL, PREFILL_CHUNK, PREFILL_M = 32, 64, 256
PAGED_LENGTHS, PAGED_PAGES, PAGE = (1100, 517, 0, 1040), 72, 16
SERVING_LENGTHS, SERVING_PAGES = (150, 97, 128, 160), 10


def _layer0_patterns(cfg) -> Dict[str, object]:
    """Layer 0's junction patterns of ``cfg`` by attribute name."""
    from .pattern_pass import model_patterns
    return {name.split(".", 3)[-1]: bp
            for name, bp in model_patterns(cfg, "m")
            if name.startswith("m.layers.0.")}


def full_width_cases() -> List[KernelCase]:
    """The junction, attention and decode shapes of gemma3-4b and
    granite-moe-1b-a400m (with the 128 x 256 expert blocks it runs with)
    at full width, bf16, at the M values ``chip_smoke.py`` launches."""
    from ..configs import get_config, granite_moe_1b_a400m
    bf16 = torch.bfloat16
    g = get_config("gemma3_4b")
    gp = _layer0_patterns(g)
    gate, down = gp["ffn.gate.pattern"], gp["ffn.down.pattern"]
    tm = TRAIN_B * TRAIN_S
    cases = [
        _fwd_case("gemma3_4b/decode/fwd_gate_gelu", gate, DECODE_M, bf16,
                  activation="gelu"),
        _fwd_case("gemma3_4b/decode/fwd_down", down, DECODE_M, bf16),
        _fwd_case("gemma3_4b/decode/fwd_quant_gate_gelu", gate, DECODE_M,
                  bf16, activation="gelu", quant=True),
        _fwd_case("gemma3_4b/decode/fwd_quant_down", down, DECODE_M, bf16,
                  quant=True),
        _fwd_case("gemma3_4b/prefill/fwd_quant_down_m32", down,
                  PREFILL_SMALL, bf16, quant=True),
        _fwd_case("gemma3_4b/prefill/fwd_quant_gate_gelu_m64", gate,
                  PREFILL_CHUNK, bf16, activation="gelu", quant=True),
        _fwd_case("gemma3_4b/prefill/fwd_quant_gate_gelu", gate, PREFILL_M,
                  bf16, activation="gelu", quant=True),
        _fwd_case("gemma3_4b/prefill/fwd_quant_down", down, PREFILL_M, bf16,
                  quant=True),
        _fwd_case("gemma3_4b/train/fwd_gate_gelu_preact", gate, tm, bf16,
                  activation="gelu", save_preact=True),
        _fwd_case("gemma3_4b/train/fwd_down", down, tm, bf16),
        # the gelu gate junction's backward: the mask, then dx and dw on g
        _mask_case("gemma3_4b/train/mask_gate_gelu", tm, gate.n_out, bf16),
        _dx_case("gemma3_4b/train/dx_gate_gelu", gate, tm, bf16),
        _dx_case("gemma3_4b/train/dx_down", down, tm, bf16),
        _dw_case("gemma3_4b/train/dw_gate_gelu", gate, tm, bf16),
        _dw_case("gemma3_4b/train/dw_down", down, tm, bf16),
    ]
    for window in (None, g.attn_window):
        tag = "global" if window is None else "local"
        for backward in (False, True):
            cases.append(_flash_case(
                f"gemma3_4b/train/flash_{'bwd' if backward else 'fwd'}_{tag}",
                TRAIN_B, TRAIN_S, g.n_heads, g.n_kv_heads, g.head_dim, bf16,
                window=window, backward=backward))
    for window, quant in ((None, False), (g.attn_window, False),
                          (None, True)):
        cases.append(_paged_case(
            f"gemma3_4b/decode/paged{'_quant' if quant else ''}"
            f"{'' if window is None else '_window'}", g.n_kv_heads,
            g.n_heads // g.n_kv_heads, g.head_dim, bf16,
            lengths=PAGED_LENGTHS, n_pages=PAGED_PAGES, page=PAGE,
            window=window, quant=quant))
    for quant in (False, True):
        cases.append(_paged_case(
            f"gemma3_4b/serve/paged{'_quant' if quant else ''}",
            g.n_kv_heads, g.n_heads // g.n_kv_heads, g.head_dim, bf16,
            lengths=SERVING_LENGTHS, n_pages=SERVING_PAGES, page=PAGE,
            window=g.attn_window, quant=quant))

    r = granite_moe_1b_a400m.card_config()
    rp = _layer0_patterns(r)
    up, edown = rp["ffn.up_pat"], rp["ffn.down_pat"]
    e = r.moe.n_routed
    c_train = max(math.ceil(tm * r.moe.top_k / e * r.moe.capacity_factor),
                  1)
    c_decode = max(math.ceil(DECODE_M * r.moe.top_k / e
                             * (e / r.moe.top_k)), 1)  # dropless serving
    for jname, bp in (("up", up), ("down", edown)):
        cases += [
            _fwd_case(f"granite/decode/fwd_{jname}", bp, c_decode, bf16,
                      experts=e),
            _fwd_case(f"granite/decode/fwd_quant_{jname}", bp, c_decode,
                      bf16, experts=e, quant=True),
            _fwd_case(f"granite/prefill/fwd_quant_{jname}", bp, PREFILL_M,
                      bf16, experts=e, quant=True),
            _fwd_case(f"granite/train/fwd_{jname}", bp, c_train, bf16,
                      experts=e),
            _dx_case(f"granite/train/dx_{jname}", bp, c_train, bf16,
                     experts=e),
            _dw_case(f"granite/train/dw_{jname}", bp, c_train, bf16,
                     experts=e),
        ]
    for backward in (False, True):
        cases.append(_flash_case(
            f"granite/train/flash_{'bwd' if backward else 'fwd'}", TRAIN_B,
            TRAIN_S, r.n_heads, r.n_kv_heads, r.head_dim, bf16, window=None,
            backward=backward))
    for quant in (False, True):
        cases.append(_paged_case(
            f"granite/decode/paged{'_quant' if quant else ''}", r.n_kv_heads,
            r.n_heads // r.n_kv_heads, r.head_dim, bf16,
            lengths=PAGED_LENGTHS, n_pages=PAGED_PAGES, page=PAGE,
            window=None, quant=quant))
        cases.append(_paged_case(
            f"granite/serve/paged{'_quant' if quant else ''}", r.n_kv_heads,
            r.n_heads // r.n_kv_heads, r.head_dim, bf16,
            lengths=SERVING_LENGTHS, n_pages=SERVING_PAGES, page=PAGE,
            window=None, quant=quant))
    return cases


# gemma2-9b's paged rows: one past its 4096 window (the 4,160-token request
# of chip_smoke.py phase 5e), 300-page tables
GEMMA2_LENGTHS, GEMMA2_PAGES = (4160, 517, 0, 4097), 300
# long context: 4 rows of 8192 keys, 512-page tables
LONG_LENGTHS, LONG_PAGES = (8192,) * 4, 512


def dense_decoder_cases() -> List[KernelCase]:
    """The decode (M 4) and prefill (M 256) forwards of gemma2-9b's,
    qwen2-7b's and granite-34b's FFN junctions at full width (bf16; gemma2
    also int8, as it is served), and their paged decode: gemma2's G 2 at
    Dh 256 over rows past its window, qwen2's G 7 at Dh 128, granite-34b's
    48 query heads over one KV head (also at 4 x 8192 keys) and a group of
    12 (the tensor-core form from G 5), bf16 and int8 pages; the group of
    12 also under f32 q (the chunked CUDA-core form)."""
    from ..configs import get_config
    bf16 = torch.bfloat16
    cases = []
    for arch in ("gemma2_9b", "qwen2_7b", "granite_34b"):
        cfg = get_config(arch)
        pats = _layer0_patterns(cfg)
        act = "gelu" if cfg.act.startswith("gelu") else None
        quants = (False, True) if arch == "gemma2_9b" else (False,)
        for quant in quants:
            q = "_quant" if quant else ""
            for tag, m in (("decode", DECODE_M), ("prefill", PREFILL_M)):
                cases += [
                    _fwd_case(f"{arch}/{tag}/fwd{q}_gate", pats[
                        "ffn.gate.pattern"], m, bf16, activation=act,
                        quant=quant),
                    _fwd_case(f"{arch}/{tag}/fwd{q}_down", pats[
                        "ffn.down.pattern"], m, bf16, quant=quant)]
    heads = {a: (c.n_kv_heads, c.n_heads // c.n_kv_heads, c.head_dim)
             for a in ("gemma2_9b", "qwen2_7b", "granite_34b")
             for c in (get_config(a),)}
    for quant in (False, True):
        q = "_quant" if quant else ""
        cases += [
            _paged_case(f"gemma2_9b/decode/paged{q}_window",
                        *heads["gemma2_9b"], bf16, lengths=GEMMA2_LENGTHS,
                        n_pages=GEMMA2_PAGES, page=PAGE, window=4096,
                        quant=quant),
            _paged_case(f"qwen2_7b/decode/paged{q}", *heads["qwen2_7b"],
                        bf16, lengths=PAGED_LENGTHS, n_pages=PAGED_PAGES,
                        page=PAGE, window=None, quant=quant),
            _paged_case(f"granite_34b/decode/paged{q}",
                        *heads["granite_34b"], bf16, lengths=PAGED_LENGTHS,
                        n_pages=PAGED_PAGES, page=PAGE, window=None,
                        quant=quant),
            _paged_case(f"granite_34b/serve/paged{q}", *heads["granite_34b"],
                        bf16, lengths=SERVING_LENGTHS, n_pages=SERVING_PAGES,
                        page=PAGE, window=None, quant=quant),
            _paged_case(f"g12/decode/paged{q}", 4, 12, 128, bf16,
                        lengths=PAGED_LENGTHS, n_pages=PAGED_PAGES,
                        page=PAGE, window=None, quant=quant),
            _paged_case(f"granite_34b/long/paged{q}",
                        *heads["granite_34b"], bf16, lengths=LONG_LENGTHS,
                        n_pages=LONG_PAGES, page=PAGE, window=None,
                        quant=quant),
            # f32 q keeps the chunked CUDA-core form (a CTA per chunk of 8
            # query heads) above G 8
            _paged_case(f"g12/decode/paged{q}_f32", 4, 12, 128,
                        torch.float32, lengths=PAGED_LENGTHS,
                        n_pages=PAGED_PAGES, page=PAGE, window=None,
                        quant=quant)]
    return cases


# the paper MLP's batch (train_mlp's default) and training set, and the LM
# smoke runs' shapes: training batch 2 x seq 32, 4 decode slots
MLP_BATCH, MLP_FULL, SMOKE_TRAIN_M = 256, 8000, 2 * 32


def small_block_cases() -> List[KernelCase]:
    """The small-block forms (``csrc/csd_spmm_small.cu``) and the mask's
    tail at the paper MLP's junctions, f32 at its batch of 256 rows: Table
    I's 800 -> 100 in 16 x 4 blocks (fan-in 10), Table II's MNIST_4J
    100 -> 100 in 4 x 4 (fan-in 20), TIMIT's 39 -> 390 in 1 x 2 and
    390 -> 39 in 2 x 1, CIFAR's 4000 -> 500 (fan-in 50); Table I's and
    CIFAR's forward, dx and dw also at the training set's 8000 rows (the
    gather kernel's tall tiles and ring, the dw kernel's M split); and at
    the LM smoke configurations' 16 x 16 blocks: gemma3-4b's gelu gate and
    its down junction, training (64 rows) and decode (4: one tile, the
    down forward's fan-in split over ranks of the CTA), and granite-moe's
    expert-batched up junction (8 experts). The int8 small-block forward
    (``csd_spmm_fwd_quant_small``) at Table I's and CIFAR's junctions and
    TIMIT's two at the batch, the smoke down junction at a decode step
    and granite-moe's smoke experts at 4 rows each."""
    from ..configs import get_config
    from ..configs import paper_mlp as pm
    from ..nn.mlp import mlp_patterns
    f32 = torch.float32
    m = MLP_BATCH
    table1 = mlp_patterns(pm.MNIST_2J, pm.rho_from_dout(pm.MNIST_2J,
                                                         (20, 10)))[0]
    mnist4 = mlp_patterns(pm.MNIST_4J, pm.rho_from_dout(
        pm.MNIST_4J, (80, 80, 80, 10)))[1]
    t_in, t_out = mlp_patterns(pm.TIMIT, (0.2, 0.2))
    cifar = mlp_patterns(pm.CIFAR_MLP, (0.2, 0.5))[0]
    cases = [
        _fwd_case("paper_mlp/table1/fwd_relu", table1, m, f32,
                  activation="relu", bias=True),
        _mask_case("paper_mlp/table1/mask_relu", m, table1.n_out, f32,
                   activation="relu"),
        _dw_case("paper_mlp/table1/dw_db", table1, m, f32, want_db=True),
        _fwd_case("paper_mlp/mnist4j/fwd_relu", mnist4, m, f32,
                  activation="relu", bias=True),
        _dx_case("paper_mlp/mnist4j/dx", mnist4, m, f32),
        _dw_case("paper_mlp/mnist4j/dw_db", mnist4, m, f32, want_db=True),
        _fwd_case("paper_mlp/timit/fwd_in_relu", t_in, m, f32,
                  activation="relu", bias=True),
        _mask_case("paper_mlp/timit/mask_relu_390", m, t_in.n_out, f32,
                   activation="relu"),
        _dw_case("paper_mlp/timit/dw_in_db", t_in, m, f32, want_db=True),
        _fwd_case("paper_mlp/timit/fwd_out", t_out, m, f32, bias=True),
        _dx_case("paper_mlp/timit/dx_out", t_out, m, f32),
        _dw_case("paper_mlp/timit/dw_out_db", t_out, m, f32, want_db=True),
        _mask_case("paper_mlp/timit/mask_relu_39", 33, 39, f32,
                   activation="relu"),
        _fwd_case("paper_mlp/cifar/fwd_relu", cifar, m, f32,
                  activation="relu", bias=True),
    ]
    for jname, bp in (("table1", table1), ("cifar", cifar)):
        cases += [
            _fwd_case(f"paper_mlp/{jname}/fwd_relu_m{MLP_FULL}", bp,
                      MLP_FULL, f32, activation="relu", bias=True),
            _dx_case(f"paper_mlp/{jname}/dx_m{MLP_FULL}", bp, MLP_FULL, f32),
            _dw_case(f"paper_mlp/{jname}/dw_db_m{MLP_FULL}", bp, MLP_FULL,
                     f32, want_db=True),
        ]
    g = _layer0_patterns(get_config("gemma3_4b", smoke=True))
    gate, down = g["ffn.gate.pattern"], g["ffn.down.pattern"]
    cases += [
        _fwd_case("gemma3_4b_smoke/train/fwd_gate_gelu_preact", gate,
                  SMOKE_TRAIN_M, f32, activation="gelu", save_preact=True),
        _mask_case("gemma3_4b_smoke/train/mask_gate_gelu", SMOKE_TRAIN_M,
                   gate.n_out, f32),
        _dx_case("gemma3_4b_smoke/train/dx_gate", gate, SMOKE_TRAIN_M, f32),
        _dw_case("gemma3_4b_smoke/train/dw_gate", gate, SMOKE_TRAIN_M, f32),
        _dx_case("gemma3_4b_smoke/train/dx_down", down, SMOKE_TRAIN_M, f32),
        _fwd_case("gemma3_4b_smoke/decode/fwd_down", down, DECODE_M, f32),
    ]
    r = get_config("granite_moe_1b_a400m", smoke=True)
    up = _layer0_patterns(r)["ffn.up_pat"]
    e = r.moe.n_routed
    c = max(math.ceil(SMOKE_TRAIN_M * r.moe.top_k / e
                      * r.moe.capacity_factor), 1)
    cases += [
        _fwd_case("granite_smoke/train/fwd_up", up, c, f32, experts=e),
        _dx_case("granite_smoke/train/dx_up", up, c, f32, experts=e),
        _dw_case("granite_smoke/train/dw_up", up, c, f32, experts=e),
    ]
    q = dict(activation="relu", bias=True, quant=True)
    cases += [
        _fwd_case("paper_mlp/table1/fwd_quant_relu", table1, m, f32, **q),
        _fwd_case("paper_mlp/cifar/fwd_quant_relu", cifar, m, f32, **q),
        _fwd_case("paper_mlp/timit/fwd_quant_in_relu", t_in, m, f32, **q),
        _fwd_case("paper_mlp/timit/fwd_quant_out", t_out, m, f32, bias=True,
                  quant=True),
        _fwd_case("gemma3_4b_smoke/decode/fwd_quant_down", down, DECODE_M,
                  f32, quant=True),
        _fwd_case("granite_smoke/decode/fwd_quant_up", up, DECODE_M, f32,
                  experts=e, quant=True),
    ]
    return cases


# the SSM models' junctions at full width: (arch, junction, module path)
SSM_JUNCTIONS = (("mamba2_130m", "out_proj", "layers.0.mixer.out_proj"),
                 ("zamba2_1p2b", "in_proj", "layers.0.mixer.in_proj"),
                 ("zamba2_1p2b", "out_proj", "layers.0.mixer.out_proj"),
                 ("zamba2_1p2b", "shared gate", "shared.ffn.gate"),
                 ("zamba2_1p2b", "shared down", "shared.ffn.down"))


def ssm_junctions():
    """(config, junction, pattern, activation of its epilogue) of
    ``SSM_JUNCTIONS``: mamba2-130m's out_proj (one 768-wide right block,
    fan-in 6; its in_proj is dense), zamba2-1.2b's mixer in_proj (131 right
    blocks of 64, fan-in 8) and out_proj (fan-in 16), and its shared FFN's
    gate (gelu, fan-in 4 of 8) and down (fan-in 32)."""
    from ..configs import get_config
    from .pattern_pass import model_patterns
    for arch, name, path in SSM_JUNCTIONS:
        cfg = get_config(arch)
        yield (cfg, name, dict(model_patterns(cfg, "m"))[f"m.{path}.pattern"],
               "gelu" if name.endswith("gate") else None)


def ssm_cases() -> List[KernelCase]:
    """``ssm_junctions``' forwards, bf16 and int8, at a decode step's (M 4)
    and a prefill's (M 256) rows, and zamba2-1.2b's shared block's paged
    decode (32 KV heads, one query head each, Dh 128, bf16 pages: its
    pools stay full width in int8 serving)."""
    from ..configs import canonical, get_config
    bf16 = torch.bfloat16
    cases = []
    for cfg, name, bp, act in ssm_junctions():
        tag = f"{canonical(cfg.name)}/{name.replace(' ', '_')}"
        for quant in (False, True):
            for phase, m in (("decode", DECODE_M), ("prefill", PREFILL_M)):
                cases.append(_fwd_case(
                    f"{tag}/{phase}/fwd{'_quant' if quant else ''}", bp, m,
                    bf16, activation=act, quant=quant))
    z = get_config("zamba2_1p2b")
    for lengths, n_pages, tag in ((PAGED_LENGTHS, PAGED_PAGES, "decode"),
                                  (SERVING_LENGTHS, SERVING_PAGES, "serve")):
        cases.append(_paged_case(
            f"zamba2_1p2b/{tag}/paged_shared", z.n_kv_heads,
            z.n_heads // z.n_kv_heads, z.head_dim, bf16, lengths=lengths,
            n_pages=n_pages, page=PAGE, window=None, quant=False))
    return cases


def kernel_cases() -> List[KernelCase]:
    """Every shipped kernel family: the demo cases, the full-width shapes
    of the two models, the dense decoders', the SSM models' and the
    small-block forms' cases."""
    return demo_cases() + full_width_cases() + dense_decoder_cases() \
        + ssm_cases() + small_block_cases()


# ---------------------------------------------------------------------------
# Self-test injection: TPU kernel #9's counterpart, a deliberately
# race-broken copy of csd_spmm_fwd whose fan-in slots are split over CTAs
# that all store straight into y (csrc/csd_spmm_fwd_injected_alias.cu).
# Used by `lint --selftest-inject`, chip_smoke.py and the linter's tests to
# prove that SL101 catches the bug class; never by a serving or training
# path.
# ---------------------------------------------------------------------------

INJECTED = "csd_spmm_fwd_injected_alias"


def injected_alias_plan(e: int, m: int, n_in: int, n_rb: int, d_in_b: int,
                        bl: int, br: int, dtype: str) -> LaunchPlan:
    """The race-broken forward's plan: csd_spmm_fwd's kernel over d_in_b
    fan-in splits, one slot each, every split storing into y."""
    size = launch._itemsize(dtype)
    buffers = {
        "x": launch.Buffer((e * m, n_in), size, "in"),
        "w": launch.Buffer((e, n_rb, d_in_b, bl, br), size, "in"),
        "block_idx": launch.Buffer((n_rb, d_in_b), 4, "in"),
        "y": launch.Buffer((e * m, n_rb * br), size, "out"),
    }
    split = launch._fwd_split_launch(
        "csd_spmm_fwd_kernel", e, m, n_rb, d_in_b, bl, br, dtype,
        n_splits=d_in_b, quant=False, has_bias=False, save_preact=False,
        target="y")
    return LaunchPlan(INJECTED, buffers, (split,), d_in_b,
                      dict(E=e, M=m, n_rb=n_rb, bR=br, d_in_b=d_in_b,
                           dtype=launch._code(dtype)))


def csd_spmm_fwd_injected_alias_cuda(x: torch.Tensor, w: torch.Tensor,
                                     block_idx: torch.Tensor
                                     ) -> torch.Tensor:
    """Launch ``csrc/csd_spmm_fwd_injected_alias.cu`` on the current
    stream: x (M, n_in) f32/bf16, w (n_rb, d_in_b, bL, bR) like x,
    block_idx int32 -> y (M, n_rb * bR), which races (each element ends as
    one slot's product). Its plain version, what it was meant to compute,
    is ``csd_spmm_fwd_plain``. Raises on what the kernel does not take."""
    name = "csd_spmm_fwd_injected_alias_cuda"
    launch.check_device(name, (x, w, block_idx))
    csd_spmm._check_dtypes(name, (x, w), (block_idx,))
    e, m, n_in, n_rb, d_in_b, bl, br = csd_spmm._check_fwd_shapes(
        name, x, w, block_idx, None, False)
    y = torch.empty((m, n_rb * br), dtype=x.dtype, device=x.device)
    plan = injected_alias_plan(e, m, n_in, n_rb, d_in_b, bl, br,
                               csd_spmm._dtype(x)) \
        .with_patterns(block_idx=block_idx)
    launch.run(plan, dict(x=x, w=w, block_idx=block_idx, y=y),
               lambda: csd_spmm._bind(INJECTED, 4, 8)(
                   x.data_ptr(), w.data_ptr(), block_idx.data_ptr(),
                   y.data_ptr(), e, m, n_in, n_rb, d_in_b, bl, br,
                   csd_spmm._DTYPE_CODE[x.dtype], csd_spmm._stream()))
    csd_spmm_fwd_injected_alias_cuda.launches += 1
    return y


csd_spmm_fwd_injected_alias_cuda.launches = 0


def injected_alias_case() -> KernelCase:
    """The race-broken forward at the demo shape: x (256, 512) f32, w (4,
    2, 128, 128), the demo pattern (fan-in 2)."""
    bp = _demo_pattern()

    def make(mk: _Maker):
        x = mk.randn((256, bp.n_in), torch.float32)
        w = mk.randn((bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out),
                     torch.float32, 1 / math.sqrt(bp.d_in_b * bp.block_in))
        return (x, w, mk.pattern(bp.block_idx)), {}

    return KernelCase(INJECTED, csd_spmm_fwd_injected_alias_cuda, make)


# the shipped forward's tolerance in f32 (sums in another order)
FWD_TOL_F32 = 1e-4


def injected_alias_evidence(device, seed: int = 0) -> dict:
    """Launch the race-broken kernel once on ``device`` (a card) at the
    demo shape from random inputs, with the shipped forward forced to the
    same split count (d_in_b) on the same inputs: the largest |error| of
    each against the plain version (what both were meant to compute), and
    whether the race shows (error > 10x the shipped tolerance) while the
    shipped kernel passes."""
    case = injected_alias_case()
    (x, w, idx), _ = case.args(device, seed)
    bad = csd_spmm_fwd_injected_alias_cuda(x, w, idx)
    good, _, _ = csd_spmm._launch_fwd("csd_spmm_fwd_cuda", x, w, idx, None,
                                      None, False, batched=False,
                                      n_splits=w.shape[1])
    ref = csd_spmm.csd_spmm_fwd_plain(x, w, idx)
    torch.cuda.synchronize(device)
    scale = float(ref.abs().max())
    err_bad = float((bad - ref).abs().max())
    err_good = float((good - ref).abs().max())
    tol = FWD_TOL_F32 * (1.0 + scale)
    return dict(kernel=INJECTED, shape=[list(x.shape), list(w.shape)],
                n_splits=int(w.shape[1]), max_abs_err=err_bad,
                shipped_max_abs_err=err_good, max_abs_plain=scale,
                tolerance=tol, race_shows=err_bad > 10 * tol,
                shipped_within=err_good <= tol)


def run(smem_budget: int = DEFAULT_SMEM_BUDGET, inject: bool = False,
        n_sm: int = launch.H100_SMS
        ) -> Tuple[List[Finding], dict, List[str]]:
    """Run the grid pass over the kernel registry, with plans for ``n_sm``
    SMs. Returns (findings, cost-by-kernel, covered subjects)."""
    findings: List[Finding] = []
    cost = {}
    covered = []
    cs = kernel_cases()
    if inject:
        cs.append(injected_alias_case())
    for case in cs:
        try:
            plan = case.build(n_sm)
        except Exception as e:
            findings.append(Finding(
                "SL105", case.name,
                f"plan capture failed: {type(e).__name__}: {e}", {}))
            continue
        f, c = analyze_plan(plan, case.name, smem_budget)
        findings.extend(f)
        cost[case.name] = c
        covered.append(case.name)
    return findings, cost, covered
