"""Continuous-batching scheduler: admit / evict / preempt + chunked prefill
(port of ``repro.serving.scheduler``).

A fixed per-step token budget is time-multiplexed over the requests in
flight, as the paper's ``z`` multiply-accumulate lanes are time-multiplexed
over a junction of any size. Policy (latency first):

1. **decode first** — every running, fully prefilled sequence gets one
   token of budget per step;
2. **chunked prefill** fills the remaining budget, oldest sequence first,
   in power-of-two chunks (``1, 2, 4, .., prefill_chunk``);
3. **admission** when a slot and at least one page are free;
4. **preemption** when a page allocation fails: the youngest running
   sequence that owns pages is evicted and re-queued for recompute with
   its generated tokens folded into the prompt;
5. **speculative drafts** (``spec_k > 0``): a decode slot may carry up to
   ``spec_k`` draft tokens from ``drafter(tokens, k)``, each one lane of
   the budget; their pages come only from the free pool (drafts never
   preempt), and the engine reports back through ``note_verified``, which
   rolls the rejected tail back with ``kv_cache.truncate``.

All page accounting goes through ``kv_cache.PageState``, which lives on
the host, so the scheduler reads it directly (the JAX scheduler keeps host
mirrors of its device state instead).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import kv_cache
from .kv_cache import PageState


@dataclasses.dataclass
class Request:
    """One generation request (prompt token ids + a budget of new tokens)."""
    req_id: int
    prompt: np.ndarray            # (L,) int32 token ids
    max_new_tokens: int
    # original prompt length; after recompute-preemption the working prompt
    # grows to include generated tokens, but outputs count from this
    orig_prompt_len: int = -1

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.orig_prompt_len < 0:
            self.orig_prompt_len = len(self.prompt)


@dataclasses.dataclass
class ActiveSeq:
    """A request resident in a slot."""
    req: Request
    admit_order: int
    tokens: List[int]             # prompt + generated (grows during decode)
    n_prefilled: int = 0          # tokens whose KV is written to pages

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)

    @property
    def n_generated(self) -> int:
        return len(self.tokens) - self.req.orig_prompt_len

    @property
    def prefilling(self) -> bool:
        return self.n_prefilled < self.prompt_len

    @property
    def pending_token(self) -> int:
        """The sampled-but-not-yet-cached token fed to the next decode."""
        return self.tokens[self.n_prefilled]

    @property
    def done(self) -> bool:
        return (not self.prefilling
                and self.n_generated >= self.req.max_new_tokens)


@dataclasses.dataclass
class StepPlan:
    """What one engine step should execute."""
    decode_slots: List[int]
    # (slot, start_position, chunk_tokens) — chunk lengths are powers of two
    prefills: List[Tuple[int, int, np.ndarray]]
    admitted: List[int] = dataclasses.field(default_factory=list)
    preempted: List[int] = dataclasses.field(default_factory=list)
    # draft tokens per decode slot (absent key = no drafts): the engine
    # verifies pending + drafts in one multi-token step
    drafts: Dict[int, List[int]] = dataclasses.field(default_factory=dict)

    @property
    def n_tokens(self) -> int:
        """Tokens of work this plan issues; each draft takes one lane of
        the budget, as a decode or prefill token does."""
        return (len(self.decode_slots)
                + sum(len(d) for d in self.drafts.values())
                + sum(len(c) for _, _, c in self.prefills))

    @property
    def prefill_groups(self) -> List[List[Tuple[int, int, np.ndarray]]]:
        """Chunks of equal length from different sequences, each group run
        as one batched ``paged_step`` call (every row of a group is fully
        valid). Chunk lengths are powers of two, so there are
        O(log prefill_chunk) groups."""
        groups: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}
        for item in self.prefills:
            groups.setdefault(len(item[2]), []).append(item)
        return [groups[c] for c in sorted(groups)]


def _pow2_chunk(n: int, cap: int) -> int:
    """Largest power of two <= min(n, cap) (n, cap >= 1)."""
    m = min(n, cap)
    return 1 << (m.bit_length() - 1)


class Scheduler:
    """Owns the slot map and the page allocator; emits per-step plans."""

    def __init__(self, *, slots: int, total_pages: int, page_size: int,
                 max_pages_per_seq: int, token_budget: int,
                 prefill_chunk: int, window: Optional[int] = None,
                 spec_k: int = 0,
                 drafter: Optional[Callable[[Sequence[int], int],
                                            List[int]]] = None):
        if prefill_chunk < 1 or token_budget < 1:
            raise ValueError("prefill_chunk and token_budget must be >= 1")
        if window is not None and window < 1:
            raise ValueError("window must be >= 1 (or None)")
        if spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        self.page_size = page_size
        self.token_budget = token_budget
        self.prefill_chunk = prefill_chunk
        # speculative decode: up to spec_k drafts per decode slot from
        # ``drafter(tokens, k)``, verified by the engine in one step
        self.spec_k = spec_k
        self.drafter = drafter
        # sliding-window page reclamation: when every attention layer's
        # window is <= ``window``, pages whose tokens every window has left
        # are freed after each advance, so a sequence holds O(window) pages
        self.window = window
        self.state: PageState = kv_cache.init_page_state(
            slots, total_pages, max_pages_per_seq)
        self.waiting: Deque[Request] = deque()
        self.active: List[Optional[ActiveSeq]] = [None] * slots
        self._admit_counter = 0
        self.stats = {"admitted": 0, "preempted": 0, "finished": 0,
                      "steps": 0, "reclaimed_pages": 0,
                      "spec_drafted": 0, "spec_accepted": 0}

    # -- bookkeeping the engine reports back ------------------------------

    def add(self, req: Request) -> None:
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(
            s is not None for s in self.active)

    def advance_prefill(self, slot: int, n: int) -> None:
        self.active[slot].n_prefilled += n
        self.state = kv_cache.advance(self.state, slot, n)
        self._reclaim(slot)

    def append_token(self, slot: int, token: int) -> None:
        """Record a sampled token (after prefill completes or a decode)."""
        self.active[slot].tokens.append(int(token))

    def note_decoded(self, slot: int) -> None:
        """A decode step wrote the pending token's KV at ``n_prefilled``."""
        self.active[slot].n_prefilled += 1
        self.state = kv_cache.advance(self.state, slot, 1)
        self._reclaim(slot)

    def note_verified(self, slot: int, n_written: int,
                      n_accepted: int) -> None:
        """A verify step wrote ``n_written`` tokens of KV (pending + drafts)
        from ``n_prefilled`` on, of which greedy verification committed the
        first ``n_accepted``. The rejected tail is rolled back with
        ``kv_cache.truncate``, which returns its emptied tail pages to the
        pool. Window reclamation runs only after the rollback: reclaiming
        against the briefly longer length could free pages the rollback
        brings back inside the window."""
        assert 1 <= n_accepted <= n_written
        self.active[slot].n_prefilled += n_accepted
        self.state = kv_cache.advance(self.state, slot, n_written)
        self.state = kv_cache.truncate(self.state, slot,
                                       n_written - n_accepted, self.page_size)
        self.stats["spec_accepted"] += n_accepted - 1
        self._reclaim(slot)

    def _reclaim(self, slot: int) -> None:
        """Free leading pages whose tokens are outside every window: with
        L tokens cached, every later query attends ``kpos > L - window``,
        so positions ``0 .. L - window`` are dead."""
        if self.window is None:
            return
        dead_tokens = int(self.state.seq_lens[slot]) - self.window + 1
        if dead_tokens <= 0:
            return
        n = dead_tokens // self.page_size - int(self.state.first_page[slot])
        if n <= 0:
            return
        self.state = kv_cache.release_prefix(self.state, slot, n)
        self.stats["reclaimed_pages"] += n

    def finish(self, slot: int) -> Tuple[Request, np.ndarray]:
        """Release the slot; returns (request, generated token ids)."""
        seq = self.active[slot]
        self.state = kv_cache.free_slot(self.state, slot)
        self.active[slot] = None
        self.stats["finished"] += 1
        out = np.asarray(seq.tokens[seq.req.orig_prompt_len:], np.int32)
        return seq.req, out

    # -- page helpers -----------------------------------------------------

    def _extent(self, slot: int) -> int:
        """Logical pages mapped so far, window-reclaimed ones included."""
        return int(self.state.first_page[slot] + self.state.n_pages[slot])

    def _pages_for(self, slot: int, new_len: int) -> int:
        """Additional pages needed for ``slot`` to hold ``new_len`` tokens."""
        return max(0, kv_cache.pages_needed(new_len, self.page_size)
                   - self._extent(slot))

    def _try_alloc(self, slot: int, need: int,
                   protected: set, preempted: List[int]) -> bool:
        """Allocate ``need`` pages for ``slot``, preempting younger,
        unprotected sequences if the pool is exhausted."""
        if self._extent(slot) + need > self.state.max_pages_per_seq:
            raise RuntimeError(
                f"slot {slot} exceeds max_pages_per_seq="
                f"{self.state.max_pages_per_seq}")
        while self.state.free_count < need:
            victim = self._youngest_victim(exclude=protected | {slot})
            if victim is None:
                return False
            self._preempt(victim)
            preempted.append(victim)
        self.state = kv_cache.alloc_pages(self.state, slot, need)
        return True

    def _youngest_victim(self, exclude: set) -> Optional[int]:
        """Youngest preemptible sequence that owns pages (evicting one that
        owns none would free nothing)."""
        cands = [(s.admit_order, i) for i, s in enumerate(self.active)
                 if s is not None and i not in exclude
                 and self.state.n_pages[i] > 0]
        return max(cands)[1] if cands else None

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` for recompute: its pages go back to the pool and
        the request is re-queued (front) with generated tokens folded into
        the prompt, so no sampled output is lost."""
        seq = self.active[slot]
        self.state = kv_cache.free_slot(self.state, slot)
        self.active[slot] = None
        # max_new_tokens stays the original budget: n_generated counts from
        # orig_prompt_len, so generated tokens now in the prompt still count
        self.waiting.appendleft(Request(
            req_id=seq.req.req_id,
            prompt=np.asarray(seq.tokens, np.int32),
            max_new_tokens=seq.req.max_new_tokens,
            orig_prompt_len=seq.req.orig_prompt_len))
        self.stats["preempted"] += 1

    def _can_fit(self, slot: int, need: int, protected: set) -> bool:
        """Would ``need`` pages fit, counting preemptible victims' pages?"""
        avail = self.state.free_count
        for i, s in enumerate(self.active):
            if s is not None and i not in protected and i != slot:
                avail += int(self.state.n_pages[i])
        return avail >= need

    # -- the step plan ----------------------------------------------------

    def schedule(self) -> StepPlan:
        plan = StepPlan(decode_slots=[], prefills=[])
        budget = self.token_budget
        self.stats["steps"] += 1

        # 1) admissions: empty slots + at least one free page each
        free_slots = [i for i, s in enumerate(self.active) if s is None]
        while self.waiting and free_slots and \
                self.state.free_count > len(plan.admitted):
            slot = free_slots.pop(0)
            req = self.waiting.popleft()
            self.active[slot] = ActiveSeq(
                req=req, admit_order=self._admit_counter,
                tokens=list(map(int, req.prompt)))
            self._admit_counter += 1
            self.stats["admitted"] += 1
            plan.admitted.append(slot)

        # 2) decode: every running fully-prefilled sequence, one token each
        protected: set = set()
        decode_slots = sorted(
            (s.admit_order, i) for i, s in enumerate(self.active)
            if s is not None and not s.prefilling and not s.done)
        for _, slot in decode_slots:
            if budget <= 0:
                break
            seq = self.active[slot]
            if seq is None:          # preempted by an earlier allocation
                continue
            need = self._pages_for(slot, seq.n_prefilled + 1)
            if not self._try_alloc(slot, need, protected, plan.preempted):
                continue             # pool exhausted even after preemption
            drafts = self._propose_drafts(slot, budget)
            while drafts and not self._alloc_extra(
                    slot, self._pages_for(slot, seq.n_prefilled + 1
                                          + len(drafts))):
                drafts.pop()         # shrink the drafts to what fits for free
            if drafts:
                plan.drafts[slot] = drafts
                self.stats["spec_drafted"] += len(drafts)
            plan.decode_slots.append(slot)
            protected.add(slot)
            budget -= 1 + len(drafts)

        # 3) chunked prefill with the remaining budget, oldest first
        prefillers = sorted(
            (s.admit_order, i) for i, s in enumerate(self.active)
            if s is not None and s.prefilling)
        for _, slot in prefillers:
            if budget <= 0:
                break
            seq = self.active[slot]
            if seq is None:
                continue
            remaining = seq.prompt_len - seq.n_prefilled
            chunk = _pow2_chunk(remaining, min(budget, self.prefill_chunk))
            need = self._pages_for(slot, seq.n_prefilled + chunk)
            while chunk > 1 and not self._can_fit(slot, need, protected):
                chunk //= 2
                need = self._pages_for(slot, seq.n_prefilled + chunk)
            if not self._try_alloc(slot, need, protected, plan.preempted):
                continue
            # _try_alloc never preempts `slot` itself
            start = seq.n_prefilled
            toks = np.asarray(seq.tokens[start:start + chunk], np.int32)
            plan.prefills.append((slot, start, toks))
            protected.add(slot)
            budget -= chunk
        return plan

    def _propose_drafts(self, slot: int, budget: int) -> List[int]:
        """Drafts for a decode slot, capped so that a verify step never
        overshoots: the generation budget (a verify that emits m + 1 tokens
        needs m + 1 <= remaining), the step's token budget (the verify takes
        1 + k lanes) and ``spec_k``."""
        if self.spec_k <= 0 or self.drafter is None:
            return []
        seq = self.active[slot]
        remaining = seq.req.max_new_tokens - seq.n_generated
        k = min(self.spec_k, budget - 1, remaining - 1)
        if k <= 0:
            return []
        return [int(t) for t in self.drafter(seq.tokens, k)][:k]

    def _alloc_extra(self, slot: int, need: int) -> bool:
        """Allocate ``need`` pages for draft tokens from the free pool only:
        never preempts and never exceeds the slot's table row (drafts are
        a bet on throughput, not work that must run)."""
        if need == 0:
            return True
        if need > self.state.free_count \
                or self._extent(slot) + need > self.state.max_pages_per_seq:
            return False
        self.state = kv_cache.alloc_pages(self.state, slot, need)
        return True

    # -- invariant check (used by the tests) ------------------------------

    def check_invariants(self) -> None:
        st = self.state
        total = st.total_pages
        free_n = st.free_count
        owned = int(np.sum(st.n_pages))
        if free_n + owned != total:
            raise AssertionError(
                f"page leak: free={free_n} owned={owned} total={total}")
        seen: set = set(st.free_stack[:free_n].tolist())
        if len(seen) != free_n:
            raise AssertionError("duplicate ids on the free stack")
        for i in range(st.slots):
            lo, hi = int(st.first_page[i]), self._extent(i)
            row = st.page_table[i][lo:hi]
            if not ((row >= 0).all() and (row < total).all()):
                raise AssertionError(f"slot {i} maps invalid pages {row}")
            for p in row.tolist():
                if p in seen:
                    raise AssertionError(f"page {p} double-mapped")
                seen.add(p)
            if not ((st.page_table[i][:lo] == -1).all()
                    and (st.page_table[i][hi:] == -1).all()):
                raise AssertionError(f"slot {i} maps pages outside its extent")
            if not lo * self.page_size <= st.seq_lens[i] <= hi * self.page_size:
                raise AssertionError(f"slot {i} length outside its pages")
            if self.window is not None and st.n_pages[i] > 0:
                dead = int(st.seq_lens[i]) - self.window + 1
                if lo * self.page_size > max(0, dead):
                    raise AssertionError(f"slot {i} reclaimed live pages")
        if seen != set(range(total)):
            raise AssertionError("pages lost from the pool")
