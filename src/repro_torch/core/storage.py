"""Hardware storage-cost model (paper §III-A, Table I): a stdlib-only copy
of ``repro.core.storage``.

Counts words of on-accelerator storage for the junction-pipelined
architecture: activation queues, derivative queues, delta pairs, biases and
the single weight bank per junction. Reproduced exactly from Table I's
expressions.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class StorageBreakdown:
    a: int        # activation queues      sum_{i=0}^{L-1} (2(L-i)+1) N_i
    a_dot: int    # derivative queues      sum_{i=1}^{L-1} (2(L-i)+1) N_i
    delta: int    # delta pairs            2 sum_{i=1}^{L} N_i
    b: int        # biases                 sum_{i=1}^{L} N_i
    w: int        # weights                sum_{i=1}^{L} N_i d_in_i

    @property
    def total(self) -> int:
        return self.a + self.a_dot + self.delta + self.b + self.w


def storage_cost(n_net: Sequence[int],
                 d_in: Sequence[int] | None = None) -> StorageBreakdown:
    """Words of storage for neuronal config ``n_net`` and per-junction
    in-degrees ``d_in`` (defaults to fully connected)."""
    n = list(n_net)
    L = len(n) - 1
    if d_in is None:
        d_in = [n[i - 1] for i in range(1, L + 1)]
    d_in = list(d_in)
    if len(d_in) != L:
        raise ValueError("need one d_in per junction")
    a = sum((2 * (L - i) + 1) * n[i] for i in range(0, L))
    a_dot = sum((2 * (L - i) + 1) * n[i] for i in range(1, L))
    delta = 2 * sum(n[1:])
    b = sum(n[1:])
    w = sum(n[i] * d_in[i - 1] for i in range(1, L + 1))
    return StorageBreakdown(a=a, a_dot=a_dot, delta=delta, b=b, w=w)


def junction_cycles(n_edges: int, z: int, flush: int = 0) -> int:
    """C_i = |W_i| / z_i  (+ optional pipeline-flush cycles, footnote 2)."""
    if n_edges % z:
        raise ValueError(f"z={z} must divide |W|={n_edges}")
    return n_edges // z + flush


def balanced_z(edge_counts: Sequence[int], z_total_budget: int) -> list[int]:
    """Pick z_i proportional to |W_i| so all junction cycles match
    (§III-A: C_i = C for all i), subject to an overall logic budget."""
    total = sum(edge_counts)
    zs = [max(1, round(z_total_budget * e / total)) for e in edge_counts]
    return zs
