"""Paged KV cache: fixed-size pages, free-list allocator, page tables (port of
``repro.serving.kv_cache``).

A fixed pool of ``total_pages`` KV pages serves sequences of any length by
mapping logical token positions to physical pages through per-sequence
page tables.

* The allocator state (``PageState``) lives on the host in numpy; its
  operations are pure functions ``PageState -> PageState``. Only the page
  table, the positions and the valid counts go to the device each step.
* Per-layer page buffers are ``(total_pages + 1, page_size, Hkv, Dh)``;
  the last page is a write-discard ("trash") page that absorbs the writes
  of inactive batch rows.
* ``page_table`` is ``(slots, max_pages_per_seq)`` int32 with ``-1`` for
  unmapped entries. Token position ``p`` of a slot lives at
  ``(page_table[slot, p // page_size], p % page_size)``; ``first_page`` is
  0 until sliding-window reclamation (``release_prefix``) frees leading
  pages whose positions every window has left.
* Int8 pages (serving with ``QuantConfig(kv=True)``) carry one f32 scale
  per stored token in ``(total_pages + 1, page_size)`` buffers beside them,
  written at append time through the same addresses (trash page included).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PageState:
    """Allocator + mapping state for one page pool (host numpy arrays)."""

    page_table: np.ndarray  # (slots, max_pages_per_seq) int32, -1 = unmapped
    n_pages: np.ndarray     # (slots,) int32 — pages owned per slot
    seq_lens: np.ndarray    # (slots,) int32 — tokens written per slot
    free_stack: np.ndarray  # (total_pages,) int32 — free ids, top at count-1
    free_count: int
    first_page: np.ndarray  # (slots,) int32 — first still-mapped logical page

    @property
    def total_pages(self) -> int:
        return self.free_stack.shape[0]

    @property
    def slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_pages_per_seq(self) -> int:
        return self.page_table.shape[1]


def init_page_state(slots: int, total_pages: int,
                    max_pages_per_seq: int) -> PageState:
    return PageState(
        page_table=np.full((slots, max_pages_per_seq), -1, np.int32),
        n_pages=np.zeros((slots,), np.int32),
        seq_lens=np.zeros((slots,), np.int32),
        free_stack=np.arange(total_pages, dtype=np.int32),
        free_count=total_pages,
        first_page=np.zeros((slots,), np.int32),
    )


def alloc_pages(st: PageState, slot: int, n: int) -> PageState:
    """Pop ``n`` pages from the free list onto ``slot``'s table, appended
    after its currently mapped pages. The caller (the scheduler) guarantees
    that ``n`` pages are free and that the row has room."""
    if n == 0:
        return st
    ids = st.free_stack[st.free_count - n:st.free_count]
    table = st.page_table.copy()
    start = int(st.first_page[slot] + st.n_pages[slot])
    table[slot, start:start + n] = ids
    n_pages = st.n_pages.copy()
    n_pages[slot] += n
    return dataclasses.replace(st, page_table=table, n_pages=n_pages,
                               free_count=st.free_count - n)


def _push(st: PageState, ids: np.ndarray) -> Tuple[np.ndarray, int]:
    stack = st.free_stack.copy()
    stack[st.free_count:st.free_count + len(ids)] = ids
    return stack, st.free_count + len(ids)


def free_slot(st: PageState, slot: int) -> PageState:
    """Return all of ``slot``'s pages to the free list and clear its row."""
    first = int(st.first_page[slot])
    stack, count = _push(
        st, st.page_table[slot, first:first + int(st.n_pages[slot])])
    table = st.page_table.copy()
    table[slot] = -1
    n_pages, seq_lens, first_page = (a.copy() for a in
                                     (st.n_pages, st.seq_lens, st.first_page))
    n_pages[slot] = seq_lens[slot] = first_page[slot] = 0
    return PageState(table, n_pages, seq_lens, stack, count, first_page)


def release_prefix(st: PageState, slot: int, n: int) -> PageState:
    """Sliding-window reclamation: return the first ``n`` still-mapped
    logical pages of ``slot`` to the free list (every window has left their
    positions). Their table entries revert to ``-1`` and ``first_page``
    advances, so later allocations keep appending at the logical tail."""
    if n == 0:
        return st
    first = int(st.first_page[slot])
    stack, count = _push(st, st.page_table[slot, first:first + n])
    table = st.page_table.copy()
    table[slot, first:first + n] = -1
    n_pages, first_page = st.n_pages.copy(), st.first_page.copy()
    n_pages[slot] -= n
    first_page[slot] += n
    return dataclasses.replace(st, page_table=table, n_pages=n_pages,
                               free_stack=stack, free_count=count,
                               first_page=first_page)


def truncate(st: PageState, slot: int, n_tokens: int,
             page_size: int) -> PageState:
    """Speculative-decode rollback, the mirror of ``release_prefix``:
    un-record the last ``n_tokens`` tokens of ``slot`` (rejected draft KV)
    and push the tail pages that now hold no live token onto the free list,
    in logical order. The caller guarantees ``n_tokens <= seq_lens[slot]``
    and that the new length does not fall below ``first_page * page_size``
    (window-reclaimed positions cannot be rolled back into); the clip keeps
    the op total where it does not."""
    if n_tokens == 0:
        return st
    first = int(st.first_page[slot])
    end = first + int(st.n_pages[slot])
    new_len = int(st.seq_lens[slot]) - n_tokens
    # logical pages from ceil(new_len / page_size) on hold no live token
    keep = min(max(-(-new_len // page_size), first), end)
    stack, count = _push(st, st.page_table[slot, keep:end])
    table = st.page_table.copy()
    table[slot, keep:end] = -1
    n_pages, seq_lens = st.n_pages.copy(), st.seq_lens.copy()
    n_pages[slot] = keep - first
    seq_lens[slot] = new_len
    return dataclasses.replace(st, page_table=table, n_pages=n_pages,
                               seq_lens=seq_lens, free_stack=stack,
                               free_count=count)


def advance(st: PageState, slot: int, n_tokens: int) -> PageState:
    """Record ``n_tokens`` more tokens written for ``slot``."""
    seq_lens = st.seq_lens.copy()
    seq_lens[slot] += n_tokens
    return dataclasses.replace(st, seq_lens=seq_lens)


def pages_needed(seq_len: int, page_size: int) -> int:
    return -(-seq_len // page_size)


# ---------------------------------------------------------------------------
# Address translation + page buffer I/O (device tensors, the model's path)
# ---------------------------------------------------------------------------


def physical_addresses(page_table: torch.Tensor,   # (B, max_pages)
                       positions: torch.Tensor,    # (B, C) token positions
                       valid: torch.Tensor,        # (B, C) bool
                       page_size: int,
                       trash_page: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map token positions to (physical page, offset) as int64 tensors;
    invalid rows are redirected to the write-discard page."""
    logical = torch.clamp(positions.long() // page_size, 0,
                          page_table.shape[1] - 1)
    phys = torch.gather(page_table.long(), 1, logical)
    phys = torch.where(valid & (phys >= 0), phys, trash_page)
    return phys, positions.long() % page_size


def write_kv(k_pages: torch.Tensor,  # (P+1, page, Hkv, Dh)
             v_pages: torch.Tensor,
             k_new: torch.Tensor,    # (B, C, Hkv, Dh)
             v_new: torch.Tensor,
             phys: torch.Tensor,     # (B, C)
             off: torch.Tensor       # (B, C)
             ) -> None:
    """Scatter new KV into the page buffers, in place (the JAX package
    returns new buffers and its jitted step donates the old ones)."""
    k_pages[phys, off] = k_new.to(k_pages.dtype)
    v_pages[phys, off] = v_new.to(v_pages.dtype)


def gather_kv(pages: torch.Tensor,       # (P+1, page, Hkv, Dh)
              page_table: torch.Tensor   # (B, max_pages)
              ) -> torch.Tensor:
    """A contiguous (B, max_pages*page, Hkv, Dh) logical view of a batch of
    sequences. Unmapped entries (-1) are clamped to page 0; the caller
    masks them by sequence length."""
    b, m = page_table.shape
    _, page, hkv, dh = pages.shape
    flat = pages[torch.clamp(page_table.long(), 0, pages.shape[0] - 1)]
    return flat.reshape(b, m * page, hkv, dh)


# ---------------------------------------------------------------------------
# Int8 pages: one symmetric f32 scale per stored token
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor  # (B, C, Hkv, Dh)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8 quantization: the amax reduces over (Hkv,
    Dh), one scale per (batch, token). Returns (int8, (B, C) f32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def write_kv_quant(k_pages: torch.Tensor,  # (P+1, page, Hkv, Dh) int8
                   v_pages: torch.Tensor,
                   k_scale: torch.Tensor,  # (P+1, page) f32
                   v_scale: torch.Tensor,
                   k_new: torch.Tensor,    # (B, C, Hkv, Dh) full width
                   v_new: torch.Tensor,
                   phys: torch.Tensor,     # (B, C)
                   off: torch.Tensor       # (B, C)
                   ) -> None:
    """Quantize at append: new KV is reduced to int8 plus a per-token scale
    and both are scattered, in place, through the same (phys, off)
    addresses."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    k_pages[phys, off] = kq
    v_pages[phys, off] = vq
    k_scale[phys, off] = ks
    v_scale[phys, off] = vs


def gather_scales(scales: torch.Tensor,     # (P+1, page)
                  page_table: torch.Tensor  # (B, max_pages)
                  ) -> torch.Tensor:
    """The scales' twin of :func:`gather_kv`: (B, max_pages * page) f32."""
    b, m = page_table.shape
    flat = scales[torch.clamp(page_table.long(), 0, scales.shape[0] - 1)]
    return flat.reshape(b, m * scales.shape[1])
