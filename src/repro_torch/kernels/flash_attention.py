"""Paged decode attention (serving): one grouped query token over a paged
KV cache. Port of ``repro.kernels.flash_attention.paged_decode_attention``.

* ``paged_decode_attention_plain`` — the gather form (as the JAX package's
  ``_paged_decode_xla``): materialise each row's logical KV view from its
  page table, then the masked softmax. What a CPU tensor runs and what the
  kernel is held against.
* ``paged_decode_attention_cuda`` — the hand-written Hopper kernel
  ``csrc/paged_decode.cu``; CUDA tensors only, no fallback.
* ``paged_decode_attention`` — dispatches on the device of ``q``.

Each takes ``k_scale``/``v_scale`` (both or neither): int8 pages with one
f32 scale per stored token, (P, page), from ``serving.kv_cache.
write_kv_quant``. K and V are dequantized per token in f32 (``float(q8) *
scale``) before the dot products, as the JAX package's kernel does; on the
card ``paged_decode_attention_cuda`` then runs the int8 kernel
(``paged_decode_attention_quant_cuda``).

A key is visible when ``kpos < lengths[b]``, with a window also when
``kpos > lengths[b] - 1 - window``, and when its page-table entry is not
-1. (The JAX package clamps a -1 entry to page 0 and relies on the length
and window masks alone; the two agree wherever the serving engine's tables
can put a -1, which is outside the visible range.) A row with no visible
key gives 0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # a block's dynamic shared memory on Hopper
_WARPS = 8          # warps per CTA of csrc/paged_decode.cu


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


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bind(name: str, n_ptrs: int):
    fn = getattr(build.load("paged_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 9 \
            + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def split_plan(b: int, hkv: int, page_size: int, n_pages: int,
               n_sm: int) -> tuple:
    """(keys per tile, pages per split, splits) for the kernel: tiles of 64
    keys (whole pages), and a row's pages split into contiguous ranges
    until the (row, head, split) CTAs number about twice the SMs."""
    tile_pages = max(1, 64 // page_size)
    n_tiles = -(-n_pages // tile_pages)
    want = max(1, -(-2 * n_sm // max(b * hkv, 1)))
    pages_per_split = -(-n_tiles // min(n_tiles, want)) * tile_pages
    return (tile_pages * page_size, pages_per_split,
            -(-n_pages // pages_per_split))


def _launch(name: str, q, k_pages, v_pages, page_table, lengths, scales, *,
            window, softcap, scale):
    """Check what the kernel takes, then launch ``csrc/paged_decode.cu``'s
    entry point ``name`` (``scales`` = (k_scale, v_scale) for int8 pages,
    else ``()``). Returns the output."""
    tensors = (q, k_pages, v_pages, page_table, lengths) + scales
    if not q.is_cuda or any(t.device != q.device for t in tensors) \
            or q.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: inputs must be CUDA tensors on the "
                         f"current device")
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
            or g > 8 or dh > 256 or (dh * k_pages.element_size()) % 16 \
            or (dh * q.element_size()) % 16:
        raise ValueError(
            f"{name}: shapes not taken: q {tuple(q.shape)} (G <= 8, Dh <= "
            f"256 in whole 16-byte rows), pages {tuple(k_pages.shape)}, "
            f"table {tuple(page_table.shape)}, lengths "
            f"{tuple(lengths.shape)}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous and 16-byte "
                         f"aligned")
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    n_pages = page_table.shape[1]
    if b == 0 or hkv == 0 or n_pages == 0:
        return out.zero_()
    keys_per_tile, pages_per_split, n_splits = split_plan(
        b, hkv, page_size, n_pages, _sm_count(q.device))
    smem = 2 * keys_per_tile * dh * k_pages.element_size() \
        + 4 * g * dh * (1 + _WARPS) + 8 * _WARPS * g \
        + 8 * keys_per_tile * bool(scales) + 4 * keys_per_tile // page_size
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: page_size {page_size} needs {smem} bytes "
                         f"of shared memory")
    part_o = part_ml = None
    if n_splits > 1:
        part_o = torch.empty((b, hkv, n_splits, g, dh), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((b, hkv, n_splits, g, 2), dtype=torch.float32,
                              device=q.device)
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()] \
        + [t.data_ptr() for t in scales] \
        + [page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
           None if part_o is None else part_o.data_ptr(),
           None if part_ml is None else part_ml.data_ptr()]
    rc = _bind(name, len(ptrs))(
        *ptrs, b, hkv, g, dh, page_size, n_pages, keys_per_tile,
        pages_per_split, -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(scale),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
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
    (``paged_decode_attention_quant_cuda``). Raises on what the kernel does
    not take."""
    _check_scales(k_scale, v_scale)
    kw = dict(window=window, softcap=softcap, scale=scale)
    if k_scale is not None:
        return paged_decode_attention_quant_cuda(
            q, k_pages, v_pages, page_table, lengths, k_scale=k_scale,
            v_scale=v_scale, **kw)
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
    (P, page); otherwise the contract of ``paged_decode_attention_cuda``."""
    out = _launch("paged_decode_attention_quant", q, k_pages, v_pages,
                  page_table, lengths, (k_scale, v_scale), window=window,
                  softcap=softcap, scale=scale)
    paged_decode_attention_quant_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
paged_decode_attention_quant_cuda.launches = 0


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
