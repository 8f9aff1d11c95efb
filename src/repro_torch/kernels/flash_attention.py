"""Attention kernels of the port (``repro.kernels.flash_attention``): full-
sequence GQA attention for training, and paged decode attention for
serving. Each has a plain PyTorch version (what a CPU tensor runs and what
the kernel is held against), a wrapper of its hand-written Hopper kernel
(CUDA tensors only, no fallback, with a ``.launches`` count) and a function
that dispatches on the device of ``q``.

**Full-sequence attention** (TPU kernel ``flash_attention``, body
``_flash_kernel``): q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh), the
reference's layout, keywords and defaults. Query head h reads KV head
h // (Hq // Hkv); a key is visible when ``kpos <= qpos + q_offset`` (causal)
and ``kpos > qpos + q_offset - window`` (window); logits are
``softcap * tanh(s / softcap)`` under a softcap; the softmax runs in f32 and
a row with no visible key gives 0.

* ``flash_attention_plain`` — ``ref.mha_ref``'s math, with empty rows 0 and,
  with ``return_lse``, the row log-sum-exp (B, Hq, Sq) in f32 (-1e30 for an
  empty row).
* ``flash_attention_bwd_plain`` — (dq, dk, dv) recomputed from ``lse``:
  D = rowsum(do * o), P = exp(s - lse), dS = P (dP - D), times
  1 - tanh^2 under a softcap, dk and dv summed over each KV head's G query
  heads. The reference has no backward kernel; this is the math the CUDA
  backward implements.
* ``flash_attention_cuda`` / ``flash_attention_bwd_cuda`` — the kernels of
  ``csrc/flash_attention.cu`` (forward; backward as two launches, dq then
  dk/dv, counted as one call). What bounds them on the H100 is operations:
  4 Dh per visible (query, key) pair forward and 10 Dh backward against
  2 Dh bytes of K and V shared by a tile of queries. Their design: a CTA
  owns 64 rows and loops only over the tiles that hold a visible pair; bf16
  scores and products on the tensor cores with f32 accumulation (P rounded
  to bf16 for P.V), f32 on the CUDA cores in full f32; no atomics, so a
  result repeats bit for bit.
* ``flash_attention`` — dispatches on the device; it keeps the reference's
  ``block_q``/``block_k`` check (the sequence lengths must be multiples of
  the blocks), while the CUDA kernel picks its own tile and masks the
  ragged edge.
* ``FlashAttention`` — the ``torch.autograd.Function`` of the training
  path: its forward saves q, k, v, o and lse, its backward runs the backward
  (the CUDA kernels for CUDA tensors, the plain versions on the CPU).

**Paged decode attention** (TPU kernel ``paged_decode_attention``): one
grouped query token over a paged KV cache.

* ``paged_decode_attention_plain`` — the gather form (as the JAX package's
  ``_paged_decode_xla``): materialise each row's logical KV view from its
  page table, then the masked softmax.
* ``paged_decode_attention_cuda`` — the hand-written Hopper kernel
  ``csrc/paged_decode.cu``. What bounds it on the H100 is latency at
  serving lengths (a few hundred keys a row: the launch and the chain
  lengths -> page table -> K/V) and bytes at long context. It has two
  forms of its split kernel, picked by ``launch.paged_rule`` (the source's
  ``mma_rule``). The tensor-core form (``paged_decode_mma_kernel``) takes
  bf16 q over bf16 or int8 pages with 5 to 48 query heads a KV head
  (qwen2-7b's 7, granite-34b's 48): the group's query rows are the rows of
  ``mma.sync`` tiles, one CTA per (split, KV head, row) reads each page of
  its range once, P is rounded to bf16 for P.V. The CUDA-core form
  (``paged_decode_kernel``) takes the rest (groups of 1, 2 and 4, and f32):
  templated on the group size and a head-dim bucket, Dh / 8 lanes a key,
  one softmax max and rescale per chunk of keys; above 8 heads (f32) one
  CTA per chunk of 8 heads. Both fill a TMA ring of K/V tiles (and int8
  scales) from one warp. ``launch.split_plan`` / ``mma_split_plan`` run a
  short table in one launch with the epilogue in the kernel, and cut a
  long one into page ranges whose partial outputs a merge kernel combines
  in split order; no atomics, so a result repeats bit for bit. A group
  above 8 query heads a KV head is counted on
  ``paged_decode_attention_grouped_cuda``.
* ``paged_decode_attention`` — dispatches on the device of ``q``.
* ``dense_decode_attention`` — the same kernel over a dense cache: a
  contiguous (B, S, Hkv, Dh) tensor, S a multiple of ``DENSE_PAGE``, is
  viewed without a copy as a pool of B S / 16 pages of 16 rows, row b's
  page j at b S / 16 + j (``dense_page_table``). With ``lengths`` = pos + 1
  it computes the JAX package's ``decode_attention`` (keys at or before
  pos, the window, the softcap); over an encoder's cache ``lengths`` are
  its frames. Rows past a length (a cache rounded up to whole pages) are
  masked by the lengths, never by the tensor's shape.

Each takes ``k_scale``/``v_scale`` (both or neither): int8 pages with one
f32 scale per stored token, (P, page), from ``serving.kv_cache.
write_kv_quant``. The plain version dequantizes K and V per token in f32
(``float(q8) * scale``) before the dot products, as the JAX package's
kernel does; on the card ``paged_decode_attention_cuda`` runs the int8
kernel (``paged_decode_attention_quant_cuda``), which applies each token's
K scale to its score and V scale to its probability instead (equal up to
f32 rounding).

A key is visible when ``kpos < lengths[b]``, with a window also when
``kpos > lengths[b] - 1 - window``, and when its page-table entry is not
-1. (The JAX package clamps a -1 entry to page 0 and relies on the length
and window masks alone; the two agree wherever the serving engine's tables
can put a -1, which is outside the visible range.) A row with no visible
key gives 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, launch

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_scales(k_scale, v_scale) -> None:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, lengths, *,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None):
    """q (B, Hkv, G, Dh); pages (P, page, Hkv, Dh); page_table (B, n_pages)
    with -1 for unmapped; lengths (B,); with int8 pages their scales
    (P, page) -> (B, Hkv, G, Dh) like q."""
    _check_scales(k_scale, v_scale)
    b, hkv, g, dh = q.shape
    page_size = k_pages.shape[1]
    scale = dh ** -0.5 if scale is None else scale
    table = page_table.long()
    idx = table.clamp(0, k_pages.shape[0] - 1)
    k = k_pages[idx].reshape(b, -1, hkv, dh)      # (B, S, Hkv, Dh)
    v = v_pages[idx].reshape(b, -1, hkv, dh)
    if k_scale is not None:
        k = k.float() * k_scale[idx].reshape(b, -1)[:, :, None, None]
        v = v.float() * v_scale[idx].reshape(b, -1)[:, :, None, None]
    logits = torch.einsum("bhgd,bkhd->bhgk", q.float() * scale, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(k.shape[1], device=q.device)
    lens = lengths.long()[:, None]
    mask = kpos[None] < lens                                   # (B, S)
    if window is not None:
        mask &= kpos[None] > (lens - 1) - window
    mask &= (table >= 0).repeat_interleave(page_size, dim=1)
    logits = torch.where(mask[:, None, None], logits, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(m > _NEG_INF / 2, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.to(q.dtype)


def _bind(source: str, name: str, n_ptrs: int, n_ints: int = 9):
    """Entry point ``name`` of ``csrc/<source>.cu``: ``n_ptrs`` pointers,
    ``n_ints`` ints, two floats, the dtype code and the stream (both
    sources' entry points have this form)."""
    fn = getattr(build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, q, k_pages, v_pages, page_table, lengths, scales, *,
            window, softcap, scale):
    """Check what the kernel takes, then launch ``csrc/paged_decode.cu``'s
    entry point ``name`` (``scales`` = (k_scale, v_scale) for int8 pages,
    else ``()``). Returns the output."""
    tensors = (q, k_pages, v_pages, page_table, lengths) + scales
    launch.check_device(name, tensors)
    page_dtype = torch.int8 if scales else q.dtype
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype \
            or any(t.dtype != torch.float32 for t in scales) \
            or page_table.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: q must be float32/bfloat16, the pages "
                         f"{page_dtype} (scales float32), page_table and "
                         f"lengths int32")
    if q.dim() != 4 or k_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError(f"{name}: q and the pages must be 4-D, page_table "
                         f"2-D")
    b, hkv, g, dh = q.shape
    n_pool, page_size = k_pages.shape[:2]
    if tuple(k_pages.shape) != (n_pool, page_size, hkv, dh) \
            or v_pages.shape != k_pages.shape \
            or any(tuple(t.shape) != (n_pool, page_size) for t in scales) \
            or page_table.shape[0] != b or tuple(lengths.shape) != (b,) \
            or g < 1 or dh > 256 or (dh * k_pages.element_size()) % 16 \
            or (dh * q.element_size()) % 16:
        raise ValueError(
            f"{name}: shapes not taken: q {tuple(q.shape)} (G >= 1, Dh <= "
            f"256 in whole 16-byte rows), pages {tuple(k_pages.shape)}, "
            f"table {tuple(page_table.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    n_pages = page_table.shape[1]
    if b == 0 or hkv == 0 or n_pages == 0:
        return out.zero_()
    plan = launch.paged_decode_plan(
        b, hkv, g, dh, page_size, n_pages, n_pool,
        str(q.dtype).replace("torch.", ""), quant=bool(scales),
        window=None if window is None else int(window),
        n_sm=launch.sm_count(q.device)).with_patterns(
            page_table=page_table, lengths=lengths)
    split = plan.launches[0]
    if split.smem > launch.SMEM_OPTIN:
        raise ValueError(f"{name}: page_size {page_size} needs {split.smem} "
                         f"bytes of shared memory")
    keys_per_tile = plan.args["keys_per_tile"]
    pages_per_split = plan.args["pages_per_split"]
    part_o = part_ml = None
    if plan.n_splits > 1:
        part_o = torch.empty(plan.buffers["part_o"].shape,
                             dtype=torch.float32, device=q.device)
        part_ml = torch.empty(plan.buffers["part_ml"].shape,
                              dtype=torch.float32, device=q.device)
    buffers = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   page_table=page_table, lengths=lengths, out=out,
                   part_o=part_o, part_ml=part_ml)
    if scales:
        buffers.update(k_scale=scales[0], v_scale=scales[1])

    def call():
        ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()] \
            + [t.data_ptr() for t in scales] \
            + [page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
               None if part_o is None else part_o.data_ptr(),
               None if part_ml is None else part_ml.data_ptr()]
        return _bind("paged_decode", name, len(ptrs), 11)(
            *ptrs, b, hkv, g, dh, page_size, n_pages, n_pool, keys_per_tile,
            pages_per_split, -1 if window is None else int(window),
            plan.args["form"], 0.0 if softcap is None else float(softcap),
            float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)

    launch.run(plan, buffers, call)
    PAGED_FORM_LAUNCHES[split.kernel] += 1
    return out


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, lengths, *,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                scale: Optional[float] = None,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None):
    """Launch ``csrc/paged_decode.cu`` on the current stream; the contract
    of ``paged_decode_attention_plain``. ``page_table`` and ``lengths`` are
    int32 tensors on the device of ``q``; table entries must lie in
    ``[-1, P)``. With ``k_scale``/``v_scale`` the int8 kernel runs
    (``paged_decode_attention_quant_cuda``); a group above 8 query heads
    runs the grouped form (``paged_decode_attention_grouped_cuda``). Raises
    on what the kernel does not take."""
    _check_scales(k_scale, v_scale)
    kw = dict(window=window, softcap=softcap, scale=scale)
    if k_scale is not None:
        return paged_decode_attention_quant_cuda(
            q, k_pages, v_pages, page_table, lengths, k_scale=k_scale,
            v_scale=v_scale, **kw)
    if _grouped(q):
        return paged_decode_attention_grouped_cuda(
            q, k_pages, v_pages, page_table, lengths, **kw)
    out = _launch("paged_decode_attention", q, k_pages, v_pages, page_table,
                  lengths, (), **kw)
    paged_decode_attention_cuda.launches += 1
    return out


def paged_decode_attention_quant_cuda(q, k_pages, v_pages, page_table,
                                      lengths, *, k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      window: Optional[int] = None,
                                      softcap: Optional[float] = None,
                                      scale: Optional[float] = None):
    """Launch the int8-page kernel of ``csrc/paged_decode.cu``: q f32/bf16
    (B, Hkv, G, Dh), int8 pages (P, page, Hkv, Dh) with f32 scales
    (P, page); otherwise the contract of ``paged_decode_attention_cuda``
    (a group above 8 query heads runs
    ``paged_decode_attention_quant_grouped_cuda``)."""
    if _grouped(q):
        return paged_decode_attention_quant_grouped_cuda(
            q, k_pages, v_pages, page_table, lengths, k_scale=k_scale,
            v_scale=v_scale, window=window, softcap=softcap, scale=scale)
    out = _launch("paged_decode_attention_quant", q, k_pages, v_pages,
                  page_table, lengths, (k_scale, v_scale), window=window,
                  softcap=softcap, scale=scale)
    paged_decode_attention_quant_cuda.launches += 1
    return out


def _grouped(q) -> bool:
    """Whether q (B, Hkv, G, Dh) has more query heads a KV head than one
    CTA holds, so that the grouped form runs."""
    return q.dim() == 4 and q.shape[2] > launch.PAGED_MAX_G


def _check_grouped(name: str, q) -> None:
    if not _grouped(q):
        raise ValueError(f"{name}: the grouped form takes groups above "
                         f"{launch.PAGED_MAX_G} query heads, q "
                         f"{tuple(q.shape)}")


def paged_decode_attention_grouped_cuda(q, k_pages, v_pages, page_table,
                                        lengths, *,
                                        window: Optional[int] = None,
                                        softcap: Optional[float] = None,
                                        scale: Optional[float] = None):
    """``csrc/paged_decode.cu`` for G above 8 (q (B, Hkv, G, Dh)): the
    tensor-core form up to 48 heads over bf16 pages (``launch.paged_rule``),
    else the CUDA-core form's 8-head form on CTAs (split, (h, chunk), b),
    one per chunk of 8 query heads, the last chunk masked; otherwise the
    contract of ``paged_decode_attention_cuda``."""
    _check_grouped("paged_decode_attention_grouped", q)
    out = _launch("paged_decode_attention", q, k_pages, v_pages, page_table,
                  lengths, (), window=window, softcap=softcap, scale=scale)
    paged_decode_attention_grouped_cuda.launches += 1
    return out


def paged_decode_attention_quant_grouped_cuda(
        q, k_pages, v_pages, page_table, lengths, *, k_scale: torch.Tensor,
        v_scale: torch.Tensor, window: Optional[int] = None,
        softcap: Optional[float] = None, scale: Optional[float] = None):
    """G above 8 over int8 pages (f32 per-token scales (P, page));
    otherwise the contract of ``paged_decode_attention_grouped_cuda``."""
    _check_grouped("paged_decode_attention_quant_grouped", q)
    out = _launch("paged_decode_attention_quant", q, k_pages, v_pages,
                  page_table, lengths, (k_scale, v_scale), window=window,
                  softcap=softcap, scale=scale)
    paged_decode_attention_quant_grouped_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
paged_decode_attention_quant_cuda.launches = 0
paged_decode_attention_grouped_cuda.launches = 0
paged_decode_attention_quant_grouped_cuda.launches = 0
# the paged decode wrappers' launches by the split kernel's form (the
# CUDA-core ``paged_decode_kernel``, the tensor-core
# ``paged_decode_mma_kernel``), counted where they launch
PAGED_FORM_LAUNCHES = {"paged_decode_kernel": 0,
                       "paged_decode_mma_kernel": 0}


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None):
    """Single-token attention over a paged KV cache; returns like ``q``.
    ``k_scale``/``v_scale`` select int8 pages."""
    kw = dict(window=window, softcap=softcap, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
    if q.device.type == "cuda":
        return paged_decode_attention_cuda(q, k_pages, v_pages, page_table,
                                           lengths, **kw)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths, **kw)
    raise ValueError(f"paged_decode_attention: no implementation for "
                     f"{q.device}")


DENSE_PAGE = 16  # rows of a dense cache's page view


def dense_page_table(batch: int, seq: int, device=None) -> torch.Tensor:
    """(B, S / 16) int32: row b's page j of a dense (B, S, ...) cache viewed
    as a page pool is page b S / 16 + j."""
    if seq % DENSE_PAGE:
        raise ValueError(f"a dense cache's length {seq} is not a multiple "
                         f"of {DENSE_PAGE}")
    n = seq // DENSE_PAGE
    return torch.arange(batch * n, dtype=torch.int32,
                        device=device).reshape(batch, n)


def dense_decode_attention(q, k, v, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           page_table: Optional[torch.Tensor] = None):
    """One grouped query token q (B, Hkv, G, Dh) over the dense caches k, v
    (B, S, Hkv, Dh), contiguous, S a multiple of ``DENSE_PAGE``: the keys
    below ``lengths`` (B,) int32 (and inside the window) are visible.
    Runs ``paged_decode_attention`` over the caches' page view
    (``page_table`` is ``dense_page_table``'s, made here when not given);
    returns like q."""
    b, s = k.shape[:2]
    if v.shape != k.shape or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"dense_decode_attention: k and v must be "
                         f"contiguous and alike, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if page_table is None:
        page_table = dense_page_table(b, s, k.device)
    pool = (b * s // DENSE_PAGE, DENSE_PAGE) + tuple(k.shape[2:])
    return paged_decode_attention(q.contiguous(), k.view(pool), v.view(pool),
                                  page_table, lengths, window=window,
                                  softcap=softcap, scale=scale)


# ---------------------------------------------------------------------------
# Full-sequence attention (training): forward, backward, autograd Function
# ---------------------------------------------------------------------------


def _grouped_logits(q, k, *, causal, window, logit_softcap, scale, q_offset):
    """f32 logits (B, Hkv, G, Sq, Skv) after scale and softcap, unmasked,
    and the (Sq, Skv) visibility of key kpos to query qpos + q_offset."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    scale = dh ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, sq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg * scale, k.float())
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return s, mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          logit_softcap: Optional[float] = None,
                          scale: Optional[float] = None, q_offset: int = 0,
                          return_lse: bool = False):
    """Attention in f32 (``ref.mha_ref``'s math; a row with no visible key
    gives 0): q (B, Sq, Hq, Dh), k, v (B, Skv, Hkv, Dh) -> o like q, and
    with ``return_lse`` also the row log-sum-exp (B, Hq, Sq) f32."""
    b, sq, hq, dh = q.shape
    s, mask = _grouped_logits(q, k, causal=causal, window=window,
                              logit_softcap=logit_softcap, scale=scale,
                              q_offset=q_offset)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m > _NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o.reshape(b, sq, hq, dh).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0.0, m + torch.log(torch.where(l > 0.0, l, 1.0)),
                      _NEG_INF)
    return o, lse.reshape(b, hq, sq)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: Optional[int] = None,
                              logit_softcap: Optional[float] = None,
                              scale: Optional[float] = None,
                              q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention_plain`` for the cotangent ``do``,
    recomputed from its output ``o`` and ``lse``: D = rowsum(do * o),
    P = exp(s - lse) on visible keys, dS = P (dP - D), times
    1 - tanh^2(s / softcap) under a softcap; dk and dv summed over the G
    query heads of each KV head. In f32; the gradients in q's dtype."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    s, mask = _grouped_logits(q, k, causal=causal, window=window,
                              logit_softcap=logit_softcap, scale=scale,
                              q_offset=q_offset)
    lse_g = lse.float().reshape(b, hkv, g, sq)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dof = do.float().reshape(b, sq, hkv, g, dh)
    delta = (dof * o.float().reshape(b, sq, hkv, g, dh)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if logit_softcap is not None:
        ds = ds * (1.0 - (s / logit_softcap) ** 2)
    qf = q.float().reshape(b, sq, hkv, g, dh)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(b, sq, hq, dh).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def _check_flash(name: str, tensors, q, k) -> None:
    """Raise on what ``csrc/flash_attention.cu`` does not take."""
    launch.check_device(name, tensors)
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in tensors):
        raise ValueError(f"{name}: q, k, v (and o, do) must all be float32 "
                         f"or all bfloat16")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (B, S, H, Dh)")
    b, _, hq, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or hq % max(k.shape[2], 1) \
            or k.shape[2] == 0 or dh % 16 or not 16 <= dh <= 256:
        raise ValueError(
            f"{name}: shapes not taken: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)} (Hq a multiple of Hkv, Dh a multiple of 16 "
            f"up to 256)")


def _flash_args(q, k, causal, window, logit_softcap, scale, q_offset):
    b, sq, hq, dh = q.shape
    return [b, sq, k.shape[1], hq, k.shape[2], dh, int(bool(causal)),
            -1 if window is None else int(window), int(q_offset),
            0.0 if logit_softcap is None else float(logit_softcap),
            float(dh ** -0.5 if scale is None else scale),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream]


def _flash_plan(q, k, causal, window, q_offset, backward: bool):
    b, sq, hq, dh = q.shape
    return launch.flash_plan(
        b, sq, k.shape[1], hq, k.shape[2], dh,
        str(q.dtype).replace("torch.", ""), causal=bool(causal),
        window=None if window is None else int(window),
        q_offset=int(q_offset), backward=backward)


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         logit_softcap: Optional[float] = None,
                         scale: Optional[float] = None, q_offset: int = 0,
                         return_lse: bool = False):
    """Launch the forward of ``csrc/flash_attention.cu`` on the current
    stream; the contract of ``flash_attention_plain``. Raises on what the
    kernel does not take."""
    _check_flash("flash_attention_cuda", (q, k, v), q, k)
    if v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: v {tuple(v.shape)} unlike "
                         f"k {tuple(k.shape)}")
    b, sq, hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel():
        launch.run(_flash_plan(q, k, causal, window, q_offset, False),
                   dict(q=q, k=k, v=v, out=out, lse=lse),
                   lambda: _bind("flash_attention", "flash_attention_fwd", 5)(
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), lse.data_ptr(),
                       *_flash_args(q, k, causal, window, logit_softcap,
                                    scale, q_offset)))
        flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: Optional[int] = None,
                             logit_softcap: Optional[float] = None,
                             scale: Optional[float] = None,
                             q_offset: int = 0):
    """Launch the backward of ``csrc/flash_attention.cu`` (dq, then dk/dv:
    one call, one count); the contract of ``flash_attention_bwd_plain``.
    ``lse`` is the forward's (B, Hq, Sq) f32. Raises on what the kernels
    do not take."""
    _check_flash("flash_attention_bwd_cuda", (q, k, v, o, do), q, k)
    b, sq, hq, _ = q.shape
    if v.shape != k.shape or o.shape != q.shape or do.shape != q.shape \
            or tuple(lse.shape) != (b, hq, sq) \
            or lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError("flash_attention_bwd_cuda: v like k, o and do like "
                         "q, lse (B, Hq, Sq) contiguous float32 on q's "
                         "device")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    launch.run(_flash_plan(q, k, causal, window, q_offset, True),
               dict(q=q, k=k, v=v, o=o, dout=do, lse=lse, dq=dq, dk=dk,
                    dv=dv, delta=delta),
               lambda: _bind("flash_attention", "flash_attention_bwd", 10)(
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                   *_flash_args(q, k, causal, window, logit_softcap, scale,
                                q_offset)))
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_cuda.launches = 0
flash_attention_bwd_cuda.launches = 0


def _flash_impl(device: torch.device, backward: bool):
    """The forward or backward for tensors on ``device``, looked up at each
    call, so that a caller can swap them."""
    if device.type == "cuda":
        return flash_attention_bwd_cuda if backward else flash_attention_cuda
    if device.type == "cpu":
        return flash_attention_bwd_plain if backward \
            else flash_attention_plain
    raise ValueError(f"flash_attention: no implementation for {device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    return_lse: bool = False):
    """Flash attention forward. Layout (B, S, H, Dh); returns like ``q``
    (and the row log-sum-exp with ``return_lse``). As in the reference, the
    sequence lengths must be multiples of ``block_q`` and ``block_k`` (each
    capped at its length); the kernel's own tile is its choice."""
    sq, skv = q.shape[1], k.shape[1]
    block_q = min(block_q, sq) or 1
    block_k = min(block_k, skv) or 1
    if sq % block_q or skv % block_k:
        raise ValueError("sequence lengths must divide block sizes")
    return _flash_impl(q.device, False)(
        q, k, v, causal=causal, window=window, logit_softcap=logit_softcap,
        scale=scale, q_offset=q_offset, return_lse=return_lse)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention of the training path:
    ``FlashAttention.apply(q, k, v, causal, window, logit_softcap, scale,
    q_offset)`` -> o (B, Sq, Hq, Dh) like q."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_softcap, scale,
                q_offset):
        q, k, v = (t.contiguous() for t in (q, k, v))
        kw = dict(causal=causal, window=window, logit_softcap=logit_softcap,
                  scale=scale, q_offset=q_offset)
        o, lse = _flash_impl(q.device, False)(q, k, v, return_lse=True, **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_impl(do.device, True)(
            q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
