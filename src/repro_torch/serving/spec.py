"""Model-free speculative drafting: prompt-lookup (n-gram) proposal (port of
``repro.serving.spec``).

Plain decode issues one token per sequence per step, so when decode
dominates most of the engine's per-step token budget idles. Speculative
decode refills it: a drafter proposes up to ``k`` continuation tokens per
sequence, and the engine verifies pending + drafts in one multi-token
``paged_step`` (the chunk path prefill uses), accepting the longest prefix
that matches the model's own greedy continuation. The output is the same
tokens plain greedy decode gives; only the number of steps changes.

The drafter is prompt lookup: match the sequence's trailing n-gram against
its earlier history and propose the tokens that followed the most recent
earlier occurrence. No draft model and no device work: host numpy only.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["PromptLookupDrafter", "propose_drafts"]


def propose_drafts(tokens: Sequence[int], k: int, *, max_ngram: int = 3,
                   min_ngram: int = 1) -> List[int]:
    """Up to ``k`` draft tokens continuing ``tokens``.

    Tries suffix n-grams from ``max_ngram`` down to ``min_ngram``; for the
    first length with an earlier occurrence, returns the (up to ``k``)
    tokens that followed the most recent one. ``[]`` on no match: the
    engine then decodes that slot one token a step. The match is ``n``
    vectorised comparisons over the history.
    """
    if k <= 0:
        return []
    toks = np.asarray(tokens, np.int64)
    n_tok = len(toks)
    for n in range(max_ngram, min_ngram - 1, -1):
        if n_tok <= n:
            continue
        pat = toks[-n:]
        # candidate starts 0 .. n_tok-n-1 (the suffix itself is excluded);
        # overlapping matches count: they capture periodic runs
        hit = toks[:n_tok - n] == pat[0]
        for j in range(1, n):
            hit &= toks[j:j + n_tok - n] == pat[j]
        idx = np.flatnonzero(hit)
        if idx.size:
            i = int(idx[-1])          # most recent occurrence
            return [int(t) for t in toks[i + n:i + n + k]]
    return []


class PromptLookupDrafter:
    """The callable drafter the scheduler holds: ``drafter(tokens, k)``."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def __call__(self, tokens: Sequence[int], k: int) -> List[int]:
        return propose_drafts(tokens, k, max_ngram=self.max_ngram,
                              min_ngram=self.min_ngram)
