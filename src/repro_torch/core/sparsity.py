"""Pre-defined sparse connection patterns (paper §II, §III-C, Appendix A/C).

A *junction* connects ``n_left`` neurons to ``n_right`` neurons. Pre-defined
sparsity fixes, before training, which of the ``n_left * n_right`` edges exist;
the pattern is held fixed through training and inference.

Three pattern families from the paper:

* ``random``      — Bernoulli-style: |W| edges sampled uniformly without
                    replacement; in/out degrees vary, neurons may disconnect.
* ``structured``  — every left neuron has out-degree exactly ``d_out`` and
                    every right neuron in-degree exactly ``d_in``
                    (``n_left * d_out == n_right * d_in == |W|``).
* ``clash-free``  — the hardware subfamily of structured patterns generated by
                    the banked-memory schedule of §III-C: ``z`` memories of
                    depth ``D = n_left / z``; a seed vector ``phi`` gives the
                    bank addresses read in cycle 0 and subsequent cycles
                    increment cyclically (type 1); type 2 re-seeds per sweep;
                    type 3 uses an arbitrary per-sweep address permutation per
                    bank; *memory dithering* permutes banks per sweep.

The same generators operate at *block* granularity
(``repro_torch.core.block_pattern``): pass block counts instead of neuron
counts. This module is the port's own copy of ``repro.core.sparsity`` and
must give the same ``idx`` bit for bit for the same arguments.

Pattern representation
----------------------
``idx[j, f]`` — the left neuron feeding fan-in slot ``f`` of right neuron
``j``; shape ``(n_right, d_in)`` int32. Within the clash-free family the edge
processed at (cycle ``t``, bank ``m``) is edge-slot ``t*z + m`` (edges are
numbered sequentially by right neuron, paper §III-B), and the left neuron read
is ``addr(t, m) * z + m`` where ``addr`` is the schedule. This module also
exposes the raw *schedule* so tests can assert clash-freedom directly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Tuple

import numpy as np

Method = Literal["random", "structured", "clashfree"]

__all__ = [
    "JunctionSpec",
    "JunctionPattern",
    "possible_densities",
    "quantize_density",
    "degrees_for_density",
    "make_pattern",
    "random_pattern",
    "structured_pattern",
    "clashfree_pattern",
    "clashfree_schedule",
    "schedule_is_clash_free",
    "pattern_from_schedule",
    "in_degrees",
    "out_degrees",
    "disconnected_left",
    "disconnected_right",
    "to_mask",
    "transpose_pattern",
]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JunctionSpec:
    """Static description of one sparse junction (paper §II-A)."""

    n_left: int
    n_right: int
    d_in: int  # in-degree of each right neuron

    def __post_init__(self):
        if self.n_left <= 0 or self.n_right <= 0:
            raise ValueError("junction sizes must be positive")
        if not (1 <= self.d_in <= self.n_left):
            raise ValueError(
                f"d_in={self.d_in} out of range for n_left={self.n_left}")
        if (self.n_right * self.d_in) % self.n_left != 0:
            raise ValueError(
                f"structured constraint violated: n_right*d_in = "
                f"{self.n_right * self.d_in} not divisible by n_left={self.n_left}"
                " (paper eq. (6)) — pick d_in a multiple of "
                f"{self.n_left // math.gcd(self.n_left, self.n_right)}")

    @property
    def d_out(self) -> int:
        return (self.n_right * self.d_in) // self.n_left

    @property
    def n_edges(self) -> int:
        return self.n_right * self.d_in

    @property
    def density(self) -> float:
        return self.n_edges / (self.n_left * self.n_right)


@dataclasses.dataclass(frozen=True)
class JunctionPattern:
    """A concrete pre-defined sparse pattern for one junction.

    ``idx[j, f]`` = left neuron feeding fan-in slot ``f`` of right neuron
    ``j``. For ``method='random'`` the degree constraint does not hold and
    ``idx`` is instead stored as an edge list ``(edges, 2)`` of
    ``(right, left)`` pairs with ``d_in`` reported as -1.
    """

    n_left: int
    n_right: int
    method: str
    idx: np.ndarray  # (n_right, d_in) int32, or (n_edges, 2) for random
    meta: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def d_in(self) -> int:
        if self.method == "random":
            return -1
        return int(self.idx.shape[1])

    @property
    def n_edges(self) -> int:
        if self.method == "random":
            return int(self.idx.shape[0])
        return int(self.idx.size)

    @property
    def density(self) -> float:
        return self.n_edges / (self.n_left * self.n_right)


# ---------------------------------------------------------------------------
# Density quantization (paper Appendix A)
# ---------------------------------------------------------------------------


def possible_densities(n_left: int, n_right: int) -> np.ndarray:
    """Set of admissible structured densities: k/gcd(n_left, n_right)."""
    g = math.gcd(n_left, n_right)
    return np.arange(1, g + 1) / g


def quantize_density(n_left: int, n_right: int, rho: float) -> float:
    """Nearest admissible density >= the requested one (never rounds to 0)."""
    g = math.gcd(n_left, n_right)
    k = max(1, math.ceil(rho * g - 1e-9))
    return min(k, g) / g


def degrees_for_density(n_left: int, n_right: int, rho: float) -> Tuple[int, int]:
    """(d_out, d_in) for the nearest admissible density (Appendix A)."""
    g = math.gcd(n_left, n_right)
    k = max(1, min(g, round(rho * g) or 1))
    d_in = k * (n_left // g)
    d_out = k * (n_right // g)
    return d_out, d_in


# ---------------------------------------------------------------------------
# Random (unstructured) pre-defined sparsity
# ---------------------------------------------------------------------------


def random_pattern(n_left: int, n_right: int, n_edges: int,
                   rng: np.random.Generator) -> JunctionPattern:
    """Uniformly sample ``n_edges`` distinct edges. No degree constraints.

    The paper shows (Table II, blue entries) this underperforms at low density
    because neurons can end up with degree zero.
    """
    total = n_left * n_right
    if not (1 <= n_edges <= total):
        raise ValueError(f"n_edges={n_edges} out of range (total {total})")
    flat = rng.choice(total, size=n_edges, replace=False)
    right, left = np.divmod(flat, n_left)
    edges = np.stack([right, left], axis=1).astype(np.int32)
    return JunctionPattern(n_left, n_right, "random", edges)


# ---------------------------------------------------------------------------
# Structured pre-defined sparsity (fixed degrees, random placement)
# ---------------------------------------------------------------------------


def structured_pattern(spec: JunctionSpec, rng: np.random.Generator,
                       max_tries: int = 200) -> JunctionPattern:
    """Random pattern with exact (d_out, d_in) degrees.

    Sweep construction (the paper's memory view, §III-B): ``d_out`` sweeps;
    each sweep assigns every left neuron to exactly one edge slot via a random
    permutation. Duplicate (left, right) pairs across sweeps are resampled.
    """
    n_left, d_in, d_out = spec.n_left, spec.d_in, spec.d_out
    for _ in range(max_tries):
        # slots[s * n_left + t] = left neuron of global edge slot (s, t)
        slots = np.concatenate(
            [rng.permutation(n_left) for _ in range(d_out)])
        idx = slots.reshape(spec.n_right, d_in)
        # duplicate edge check: same left neuron twice within one row
        srt = np.sort(idx, axis=1)
        if not (srt[:, 1:] == srt[:, :-1]).any():
            return JunctionPattern(spec.n_left, spec.n_right, "structured",
                                   idx.astype(np.int32))
    # Deterministic fallback: fix duplicates by cyclic repair within rows.
    idx = _repair_duplicates(idx, n_left, rng)
    return JunctionPattern(spec.n_left, spec.n_right, "structured",
                           idx.astype(np.int32))


def _canonical_structured(n_left: int, n_right: int, d_in: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Deterministic degree-exact duplicate-free pattern, randomized by a
    left-neuron relabeling and a row shuffle.

    Sweep ``s`` uses the cyclically shifted identity permutation
    ``(t + s) mod n_left``; consecutive global slots then increase by 1 or
    2 (mod n_left) so any row of ``d_in < n_left`` slots is duplicate-free,
    and each left neuron appears exactly once per sweep (out-degree exact).
    """
    if d_in >= n_left:
        idx = np.tile(np.arange(n_left), (n_right, 1))
    else:
        p = np.arange(n_right * d_in)
        idx = ((p % n_left + p // n_left) % n_left).reshape(n_right, d_in)
    idx = rng.permutation(n_left)[idx]
    return idx[rng.permutation(n_right)]


def _repair_duplicates(idx: np.ndarray, n_left: int,
                       rng: np.random.Generator) -> np.ndarray:
    """Swap duplicate entries between rows until all rows are duplicate-free.

    Keeps both degree distributions intact (swaps preserve the global value
    multiset and per-row counts). Dense junctions (d_in close to n_left)
    can strand the random swap search; when it stalls we rebuild from the
    canonical shifted-identity construction, which always exists.

    Raises ``ValueError`` when no duplicate-free arrangement of the given
    multiset exists at all (a row wider than ``n_left``, or one left id
    occurring in more entries than there are rows — each row can hold it
    at most once). Silently substituting a different pattern there would
    hand the caller a network it did not ask for (sparselint SL301).
    """
    idx = idx.copy()
    n_right, d_in = idx.shape
    if d_in > n_left:
        raise ValueError(
            f"duplicate-free repair impossible: rows have {d_in} slots "
            f"but only {n_left} distinct left ids exist")
    vals, counts = np.unique(idx, return_counts=True)
    if counts.size and counts.max() > n_right:
        v = int(vals[int(counts.argmax())])
        raise ValueError(
            f"duplicate-free repair impossible: left id {v} occurs "
            f"{int(counts.max())} times but only {n_right} rows exist "
            f"(each row can hold it once)")
    for _ in range(10 * n_right):
        bad = []
        for j in range(n_right):
            row = idx[j]
            seen: dict = {}
            for f, l in enumerate(row):
                if l in seen:
                    bad.append((j, f))
                else:
                    seen[l] = f
        if not bad:
            return idx
        progressed = False
        for (j, f) in bad:
            a = idx[j, f]
            row_j = set(idx[j]) - {a}
            # scan swap candidates from a random start so dense rows still
            # find the (few) feasible partners
            n_cand = n_right * d_in
            start = int(rng.integers(n_cand))
            for off in range(n_cand):
                c = (start + off) % n_cand
                j2, f2 = divmod(c, d_in)
                if j2 == j:
                    continue
                b = idx[j2, f2]
                if b == a or b in row_j or a in (set(idx[j2]) - {b}):
                    continue
                idx[j, f], idx[j2, f2] = b, a
                progressed = True
                break
        if not progressed:
            break
    return _canonical_structured(n_left, n_right, d_in, rng)


# ---------------------------------------------------------------------------
# Clash-free patterns (paper §III-C, Appendix C)
# ---------------------------------------------------------------------------


def clashfree_schedule(
    spec: JunctionSpec,
    z: int,
    rng: np.random.Generator,
    cf_type: int = 1,
    dither: bool = False,
) -> np.ndarray:
    """Banked-memory access schedule: ``sched[t, m]`` = address read from
    memory ``m`` at cycle ``t``. Shape ``(C, z)`` with ``C = n_edges / z``
    cycles and bank depth ``D = n_left / z``.

    * type 1 — seed vector ``phi`` in {0..D-1}^z; ``sched[t,m] = (phi[m]+t) % D``
    * type 2 — fresh seed per sweep (a sweep = D cycles, one full bank pass)
    * type 3 — per sweep, each bank's address sequence is an arbitrary
      permutation of 0..D-1

    ``dither`` additionally applies a per-sweep permutation of the banks
    (paper Fig. 13(d)); for type 1 a single permutation is used for all sweeps
    (the access pattern does not change across sweeps).
    """
    n_left, d_out = spec.n_left, spec.d_out
    if n_left % z != 0:
        raise ValueError(f"z={z} must divide n_left={n_left} (Appendix B)")
    D = n_left // z
    C = spec.n_edges // z
    if spec.n_edges % z != 0:
        raise ValueError(f"z={z} must divide n_edges={spec.n_edges}")
    if C != D * d_out:
        raise ValueError("inconsistent schedule dimensions")

    if cf_type == 1:
        phi = rng.integers(0, D, size=z)
        t = np.arange(C)[:, None]
        sched = (phi[None, :] + t) % D
    elif cf_type == 2:
        sweeps = []
        for _ in range(d_out):
            phi = rng.integers(0, D, size=z)
            c = np.arange(D)[:, None]
            sweeps.append((phi[None, :] + c) % D)
        sched = np.concatenate(sweeps, axis=0)
    elif cf_type == 3:
        sweeps = []
        for _ in range(d_out):
            cols = [rng.permutation(D) for _ in range(z)]
            sweeps.append(np.stack(cols, axis=1))
        sched = np.concatenate(sweeps, axis=0)
    else:
        raise ValueError(f"unknown clash-free type {cf_type}")

    if dither:
        if cf_type == 1:
            perm = rng.permutation(z)
            sched = sched[:, perm]
        else:
            out = []
            for s in range(d_out):
                perm = rng.permutation(z)
                out.append(sched[s * D:(s + 1) * D][:, perm])
            sched = np.concatenate(out, axis=0)
    return sched.astype(np.int32)


def schedule_is_clash_free(sched: np.ndarray, D: int) -> bool:
    """Each bank is read at most once per cycle *and* each (bank, address)
    cell exactly once per sweep (so every left neuron is read once/sweep)."""
    C, z = sched.shape
    if (sched < 0).any() or (sched >= D).any():
        return False
    # one access per bank per cycle is structural (one column per bank);
    # the sweep property: within each sweep every address appears once/bank.
    if C % D != 0:
        return False
    for s in range(C // D):
        block = sched[s * D:(s + 1) * D]
        for m in range(z):
            if len(set(block[:, m].tolist())) != D:
                return False
    return True


def pattern_from_schedule(spec: JunctionSpec, sched: np.ndarray, z: int,
                          meta: Optional[dict] = None) -> JunctionPattern:
    """Convert a banked access schedule into the ``idx`` pattern.

    Edge slot ``t*z + m`` (numbered by right neuron) reads left neuron
    ``sched[t, m] * z + m`` (paper Fig. 4: neuron = addr * z + bank).
    """
    C = sched.shape[0]
    t = np.arange(C)[:, None]
    m = np.arange(z)[None, :]
    left = sched * z + m
    slots = left.reshape(-1)  # ordered by edge slot
    idx = slots.reshape(spec.n_right, spec.d_in).astype(np.int32)
    return JunctionPattern(spec.n_left, spec.n_right, "clashfree", idx,
                           meta=dict(meta or {}, z=z))


def clashfree_pattern(spec: JunctionSpec, z: int, rng: np.random.Generator,
                      cf_type: int = 1, dither: bool = False,
                      max_tries: int = 100) -> JunctionPattern:
    """Generate a clash-free pattern, resampling if duplicate edges appear.

    Type 1 cannot produce duplicates (same left neuron ⇒ same bank ⇒ cycle
    gap is a multiple of D ⇒ slot gap ≥ n_left ≥ d_in). Types 2/3 can when
    ``d_in > z``; we resample (cheap) and fall back to repair.
    """
    for _ in range(max_tries):
        sched = clashfree_schedule(spec, z, rng, cf_type, dither)
        pat = pattern_from_schedule(
            spec, sched, z,
            meta={"cf_type": cf_type, "dither": dither})
        srt = np.sort(pat.idx, axis=1)
        if not (srt[:, 1:] == srt[:, :-1]).any():
            return dataclasses.replace(pat, meta=dict(pat.meta, sched=sched))
        if cf_type == 1:
            raise AssertionError("type-1 pattern produced duplicate edges")
    idx = _repair_duplicates(pat.idx, spec.n_left, rng)
    return JunctionPattern(spec.n_left, spec.n_right, "clashfree",
                           idx.astype(np.int32),
                           meta={"cf_type": cf_type, "dither": dither,
                                 "repaired": True})


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------


def make_pattern(
    n_left: int,
    n_right: int,
    rho: float,
    method: Method = "clashfree",
    *,
    seed: int = 0,
    z: Optional[int] = None,
    cf_type: int = 1,
    dither: bool = False,
) -> JunctionPattern:
    """Build a pattern at (approximately) density ``rho``.

    For structured/clash-free methods the density is quantized to the nearest
    admissible value (Appendix A). ``z`` defaults to the largest divisor of
    ``n_left`` that is <= d_in-aligned hardware-friendly width.
    """
    rng = np.random.default_rng(seed)
    if method == "random":
        n_edges = max(1, round(rho * n_left * n_right))
        return random_pattern(n_left, n_right, n_edges, rng)

    d_out, d_in = degrees_for_density(n_left, n_right, rho)
    spec = JunctionSpec(n_left, n_right, d_in)
    if method == "structured":
        return structured_pattern(spec, rng)
    if method == "clashfree":
        if z is None:
            z = _default_z(n_left, spec.n_edges)
        return clashfree_pattern(spec, z, rng, cf_type, dither)
    raise ValueError(f"unknown method {method!r}")


def _default_z(n_left: int, n_edges: int) -> int:
    """Largest z <= min(n_left, 128) dividing both n_left and n_edges."""
    for z in range(min(n_left, 128), 0, -1):
        if n_left % z == 0 and n_edges % z == 0:
            return z
    return 1


# ---------------------------------------------------------------------------
# Pattern utilities
# ---------------------------------------------------------------------------


def to_mask(pat: JunctionPattern) -> np.ndarray:
    """(n_left, n_right) float32 0/1 mask; mask[l, j] = edge l->j exists."""
    mask = np.zeros((pat.n_left, pat.n_right), dtype=np.float32)
    if pat.method == "random":
        right, left = pat.idx[:, 0], pat.idx[:, 1]
        mask[left, right] = 1.0
    else:
        j = np.repeat(np.arange(pat.n_right), pat.idx.shape[1])
        mask[pat.idx.reshape(-1), j] = 1.0
    return mask


def in_degrees(pat: JunctionPattern) -> np.ndarray:
    m = to_mask(pat)
    return m.sum(axis=0).astype(np.int64)


def out_degrees(pat: JunctionPattern) -> np.ndarray:
    m = to_mask(pat)
    return m.sum(axis=1).astype(np.int64)


def disconnected_left(pat: JunctionPattern) -> int:
    return int((out_degrees(pat) == 0).sum())


def disconnected_right(pat: JunctionPattern) -> int:
    return int((in_degrees(pat) == 0).sum())


def transpose_pattern(pat: JunctionPattern) -> np.ndarray:
    """Reverse adjacency for BP (paper eq. 3b): ``ridx[l, g] = (j, f)``.

    Returns int32 array (n_left, d_out, 2) listing, for each left neuron, the
    (right neuron, fan-in slot) pairs it feeds. Only defined for structured /
    clash-free patterns.
    """
    if pat.method == "random":
        raise ValueError("transpose_pattern needs fixed degrees")
    n_right, d_in = pat.idx.shape
    d_out = pat.n_edges // pat.n_left
    ridx = np.zeros((pat.n_left, d_out, 2), dtype=np.int32)
    fill = np.zeros(pat.n_left, dtype=np.int64)
    for j in range(n_right):
        for f in range(d_in):
            l = pat.idx[j, f]
            ridx[l, fill[l]] = (j, f)
            fill[l] += 1
    if not (fill == d_out).all():
        raise AssertionError("pattern degrees inconsistent")
    return ridx


# ---------------------------------------------------------------------------
# Counting (paper Appendix C) — number of access patterns, for reporting
# ---------------------------------------------------------------------------


def count_access_patterns(spec: JunctionSpec, z: int, cf_type: int,
                          dither: bool) -> float:
    """log10 of S_M (paper eqs. 10-13). Returned in log10 to avoid overflow."""
    D = spec.n_left // z
    d_out = spec.d_out
    d_in = spec.d_in
    if cf_type == 1:
        base = z * math.log10(D)
    elif cf_type == 2:
        base = z * d_out * math.log10(D)
    elif cf_type == 3:
        base = z * d_out * math.log10(max(math.factorial(D), 1))
    else:
        raise ValueError(cf_type)
    if not dither:
        return base
    if d_in % z == 0 and d_in // z >= 1:
        k = 0.0  # integral cycles per right neuron: dither has no effect
    elif z % d_in == 0:
        k = math.log10(math.factorial(z)) - (z / d_in) * math.log10(
            math.factorial(d_in))
        if cf_type in (2, 3):
            k *= d_out
    else:
        k = math.log10(math.factorial(z))
        if cf_type in (2, 3):
            k *= d_out
    return base + k
