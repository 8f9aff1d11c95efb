"""Pass 3 — BlockPattern / PartitionedPattern invariant checks (port of
``repro.analysis.pattern_pass``).

These are the software form of the constraints the paper's hardware flow
certifies before synthesis: the interleaver (pattern) must be clash-free,
every neuron (block) must stay connected, and parallel lanes (shards) must
carry equal work. A pattern violating them doesn't crash — it trains to a
silently wrong or silently slower model — which is why the checks run
statically here and (behind ``debug=True``) at pattern construction time.

Checks:

* **SL301** — duplicate edge: one right block lists the same left block in
  two fan-in slots (gather form), or the scatter form emits one (right
  block, slot) cell twice. The tile would be applied twice.
* **SL302** — coverage hole: a left block feeding nothing or a right block
  fed by nothing (dead neurons by construction).
* **SL303** — scatter/gather disagreement: ``out_idx``/``out_slot`` (with
  ``out_valid`` honored) must be exactly the transpose of ``block_idx``.
  dx consumes the scatter form while the forward consumes the gather form;
  a mismatch means forward and backward silently use different networks.
* **SL304** — degree/bounds: indices within range, fan-in degree uniform
  and <= n_lb.
* **SL305** — shard imbalance: per-shard valid-slot counts must be equal.

Collection walks every registered config at its smoke and its full size
and reads each junction's pattern from the model built on the ``meta``
device: the layers call ``fit_block_pattern`` with their own seeds exactly
as they do on a real device, and no parameter memory is allocated.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .findings import Finding


def check_pattern(bp, subject: str) -> List[Finding]:
    """All single-pattern invariants for one ``BlockPattern``."""
    f: List[Finding] = []
    n_lb, n_rb = bp.n_lb, bp.n_rb
    idx = np.asarray(bp.block_idx)

    # SL304: shape + range sanity first — later checks assume it
    if idx.ndim != 2 or idx.shape[0] != n_rb:
        f.append(Finding("SL304", subject,
                         f"block_idx shape {idx.shape} != (n_rb={n_rb}, "
                         f"d_in_b)", {}))
        return f
    d_in_b = idx.shape[1]
    if d_in_b < 1 or d_in_b > n_lb:
        f.append(Finding("SL304", subject,
                         f"fan-in degree {d_in_b} outside [1, n_lb={n_lb}]",
                         {}))
    if idx.size and (idx.min() < 0 or idx.max() >= n_lb):
        f.append(Finding("SL304", subject,
                         f"block_idx entries outside [0, {n_lb}): "
                         f"min={idx.min()}, max={idx.max()}", {}))
        return f

    # SL301: duplicate edges in gather form
    for r in range(n_rb):
        row = idx[r]
        if len(np.unique(row)) != len(row):
            vals, counts = np.unique(row, return_counts=True)
            f.append(Finding(
                "SL301", subject,
                f"right block {r} lists left block(s) "
                f"{vals[counts > 1].tolist()} in multiple fan-in slots",
                {"row": r}))

    # SL302: coverage (every left block feeds something)
    used = np.zeros(n_lb, bool)
    used[idx.reshape(-1)] = True
    missing = np.flatnonzero(~used)
    if missing.size:
        f.append(Finding(
            "SL302", subject,
            f"{missing.size} left block(s) feed no right block "
            f"(dead input blocks): {missing[:8].tolist()}...",
            {"n_missing": int(missing.size)}))

    # SL303/SL301(scatter): scatter form must be the exact transpose
    oi = np.asarray(bp.out_idx)
    osl = np.asarray(bp.out_slot)
    ov = np.asarray(bp.out_valid) if bp.out_valid is not None else \
        np.ones_like(oi)
    if oi.shape != osl.shape or oi.shape[0] != n_lb:
        f.append(Finding("SL303", subject,
                         f"scatter form shapes {oi.shape}/{osl.shape} "
                         f"inconsistent with n_lb={n_lb}", {}))
        return f
    gather_edges = {(int(idx[r, s]), r, s)
                    for r in range(n_rb) for s in range(d_in_b)}
    scatter_edges = set()
    for lb in range(n_lb):
        for g in range(oi.shape[1]):
            if not ov[lb, g]:
                continue
            r, s = int(oi[lb, g]), int(osl[lb, g])
            if r < 0 or r >= n_rb or s < 0 or s >= d_in_b:
                f.append(Finding(
                    "SL304", subject,
                    f"scatter entry ({lb},{g}) -> (rb={r}, slot={s}) out "
                    f"of range", {}))
                continue
            e = (lb, r, s)
            if e in scatter_edges:
                f.append(Finding(
                    "SL301", subject,
                    f"scatter form emits (rb={r}, slot={s}) twice from "
                    f"left block {lb} — the tile would accumulate twice",
                    {"edge": e}))
            scatter_edges.add(e)
    if scatter_edges != gather_edges and not any(
            x.code == "SL304" for x in f):
        only_g = sorted(gather_edges - scatter_edges)[:4]
        only_s = sorted(scatter_edges - gather_edges)[:4]
        f.append(Finding(
            "SL303", subject,
            "scatter form disagrees with gather form (FF and BP would use "
            f"different networks); gather-only={only_g}, "
            f"scatter-only={only_s}",
            {"n_gather": len(gather_edges), "n_scatter": len(scatter_edges)}))
    return f


def check_partition(part, subject: str) -> List[Finding]:
    """Invariants for a ``PartitionedPattern``: every shard individually
    valid, shards disjointly cover the parent rows, and slot counts are
    balanced across shards (SL305)."""
    f: List[Finding] = []
    for s, shard in enumerate(part.shards):
        # SL302 does not apply per shard: a shard only reads the left
        # blocks its own output rows need; coverage is a union property
        f.extend(x for x in check_pattern(shard, f"{subject}/shard{s}")
                 if x.code != "SL302")
    used = np.zeros(part.parent.n_lb, bool)
    used[np.asarray(part.idx).reshape(-1)] = True
    if not used.all():
        f.append(Finding(
            "SL302", subject,
            f"{int((~used).sum())} left block(s) feed no shard at all "
            f"(union coverage hole): {np.flatnonzero(~used)[:8].tolist()}",
            {}))
    ra = np.asarray(part.row_assign)
    counts = np.bincount(ra, minlength=part.n_shards)
    if len(set(counts.tolist())) != 1:
        f.append(Finding(
            "SL305", subject,
            f"row counts per shard unbalanced: {counts.tolist()} — SPMD "
            "shards must have equal local shapes", {}))
    perm_ok = sorted(np.asarray(part.perm).tolist()) == \
        list(range(part.parent.n_rb))
    if not perm_ok:
        f.append(Finding(
            "SL305", subject,
            "perm is not a permutation of the parent block-rows", {}))
    ov = np.asarray(part.out_valid)
    slot_counts = ov.reshape(part.n_shards, -1).sum(axis=1)
    if len(set(slot_counts.tolist())) != 1:
        f.append(Finding(
            "SL305", subject,
            f"valid scatter-slot counts per shard unbalanced: "
            f"{slot_counts.tolist()} (padded width d_loc="
            f"{ov.shape[-1]} hides idle lanes)",
            {"slots": slot_counts.tolist()}))
    return f


# ---------------------------------------------------------------------------
# Collection
# ---------------------------------------------------------------------------


def lint_configs(config_names: Optional[Sequence[str]] = None):
    """(subject, ModelConfig) for every registered config (or the named
    ones) at its smoke size and its full size."""
    from ..configs import ARCHS, canonical, get_config
    out = []
    for name in (config_names or ARCHS):
        arch = canonical(name)
        out.append((f"{arch}:smoke", get_config(arch, smoke=True)))
        out.append((f"{arch}:full", get_config(arch)))
    return out


@functools.lru_cache(maxsize=None)
def model_patterns(cfg, subject: str) -> List[Tuple[str, object]]:
    """(subject.module.attr, BlockPattern) of every junction the model of
    ``cfg`` instantiates, read from the model built on the meta device
    (cached per config: patterns are a pure function of it)."""
    from ..core.block_pattern import BlockPattern
    from ..nn.model import build_model

    model = build_model(cfg, device="meta")
    return [(f"{subject}.{mod_name}.{attr}" if mod_name
             else f"{subject}.{attr}", v)
            for mod_name, mod in model.named_modules()
            for attr, v in vars(mod).items()
            if isinstance(v, BlockPattern)]


def collect_patterns(config_names: Optional[Sequence[str]] = None
                     ) -> List[Tuple[str, object]]:
    """(subject, BlockPattern) for every junction every registered config
    instantiates, at the smoke and the full size."""
    out: List[Tuple[str, object]] = []
    for subject, cfg in lint_configs(config_names):
        out.extend(model_patterns(cfg, subject))
    return out


SHARD_SIZES = (2, 4)  # the model-axis sizes of the meshes partitions use


def run(config_names: Optional[Sequence[str]] = None
        ) -> Tuple[List[Finding], List[str]]:
    """Run pattern invariants over every config-producible pattern plus the
    partitions a mesh of each size in ``SHARD_SIZES`` would build for it."""
    from ..core.block_pattern import can_partition, partition_pattern

    findings: List[Finding] = []
    covered: List[str] = []
    # dedupe structurally identical junctions (same dims/degree/pattern) so
    # a 34-layer stack doesn't re-check one pattern 34 times
    by_sig = {}
    for subject, bp in collect_patterns(config_names):
        sig = (bp.n_in, bp.n_out, bp.block_in, bp.block_out, bp.d_in_b,
               np.asarray(bp.block_idx).tobytes())
        by_sig.setdefault(sig, (subject, bp))
    for subject, bp in by_sig.values():
        findings.extend(check_pattern(bp, subject))
        covered.append(subject)
        for k in SHARD_SIZES:
            if can_partition(bp, k):
                findings.extend(
                    check_partition(partition_pattern(bp, k),
                                    f"{subject}@shards{k}"))
                covered.append(f"{subject}@shards{k}")
    return findings, covered
