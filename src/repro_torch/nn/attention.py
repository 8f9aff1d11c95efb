"""GQA attention for the paged serving step (port of ``repro.nn.attention``'s
``Attention._qkv`` and ``Attention.paged_step``).

Decode (one token per row) runs through the paged decode kernel; a prefill
chunk gathers the row's logical KV view and runs masked grouped attention
in plain torch, as the JAX package does with a gather and einsums.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from ..kernels.flash_attention import paged_decode_attention
from ..serving import kv_cache
from .common import ModelConfig, param_dtype_of
from .layers import Linear, RMSNorm, apply_rope

_NEG_INF = -1e30


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


class Attention(nn.Module):
    """GQA self-attention with rope, optional qk-norm, window and logit
    softcap, and optionally pre-defined-sparse projections."""

    def __init__(self, cfg: ModelConfig, *, window: Optional[int] = None,
                 seed: int = 0, qk_norm: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        self.qk_norm = qk_norm
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.h, self.kv, self.dh = h, kv, dh
        self.groups = h // kv
        sp = cfg.sparsity
        rho = sp.rho_attn
        attn_sp = dataclasses.replace(sp, enabled=sp.enabled and rho is not None)
        pd = param_dtype_of(cfg)
        kw = dict(rho=rho if rho is not None else 1.0, sp=attn_sp, dtype=pd,
                  device=device, generator=generator)
        d = cfg.d_model
        self.wq = Linear(d, h * dh, bias=cfg.qkv_bias, seed=seed + 1, **kw)
        self.wk = Linear(d, kv * dh, bias=cfg.qkv_bias, seed=seed + 2, **kw)
        self.wv = Linear(d, kv * dh, bias=cfg.qkv_bias, seed=seed + 3, **kw)
        self.wo = Linear(h * dh, d, bias=False, seed=seed + 4, **kw)
        if qk_norm:
            self.qnorm = RMSNorm(dh, cfg.rms_eps, pd, device)
            self.knorm = RMSNorm(dh, cfg.rms_eps, pd, device)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        b = x.shape[0]
        q = self.wq(x).reshape(b, -1, self.h, self.dh)
        k = self.wk(x).reshape(b, -1, self.kv, self.dh)
        v = self.wv(x).reshape(b, -1, self.kv, self.dh)
        if self.qk_norm:
            q = self.qnorm(q)
            k = self.knorm(k)
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        return q, k, v

    def paged_step(self, x: torch.Tensor, pos: torch.Tensor,
                   n_new: torch.Tensor, cache: dict,
                   page_table: torch.Tensor) -> torch.Tensor:
        """One serving step against the paged KV cache.

        x: (B, C, d); C == 1 is a decode step, C > 1 one prefill chunk
        (causal within the chunk, attending to earlier pages by gather).
        pos: (B,) tokens already cached per row; n_new: (B,) valid tokens
        in this chunk (0 = inactive row: its KV lands on the discard page).
        cache: {'k_pages', 'v_pages'} of shape (P+1, page, Hkv, Dh),
        addressed through page_table (B, max_pages). The pages are updated
        in place (the JAX package donates them to the jitted step instead).
        Returns (B, C, d).
        """
        cfg = self.cfg
        b, c = x.shape[:2]
        k_pages, v_pages = cache["k_pages"], cache["v_pages"]
        page_size = k_pages.shape[1]
        trash = k_pages.shape[0] - 1
        steps = torch.arange(c, dtype=torch.int32, device=x.device)
        positions = pos[:, None] + steps[None]
        valid = steps[None] < n_new[:, None]

        q, k_new, v_new = self._qkv(x, positions)
        phys, off = kv_cache.physical_addresses(
            page_table, positions, valid, page_size, trash)
        kv_cache.write_kv(k_pages, v_pages, k_new, v_new, phys, off)
        lengths = pos + n_new
        scale = self.dh ** -0.5

        if c == 1:
            qg = q.reshape(b, self.kv, self.groups, self.dh)
            o = paged_decode_attention(
                qg.contiguous(), k_pages, v_pages, page_table, lengths,
                window=self.window, softcap=cfg.logit_softcap, scale=scale)
            o = o.reshape(b, 1, self.h * self.dh).to(x.dtype)
        else:
            k = kv_cache.gather_kv(k_pages, page_table).to(q.dtype)
            v = kv_cache.gather_kv(v_pages, page_table).to(q.dtype)
            qg = q.reshape(b, c, self.kv, self.groups, self.dh)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * scale,
                                  k.float())
            logits = _softcap(logits, cfg.logit_softcap)
            kpos = torch.arange(k.shape[1], device=x.device)
            mask = kpos[None, None] <= positions[:, :, None]      # (B, C, S)
            if self.window is not None:
                mask &= kpos[None, None] > positions[:, :, None] - self.window
            mask &= valid[..., None]
            logits = torch.where(mask[:, None, None], logits, _NEG_INF)
            m = logits.amax(dim=-1, keepdim=True)
            p = torch.exp(logits - torch.clamp_min(m, _NEG_INF / 2))
            p = torch.where(m > _NEG_INF / 2, p, 0.0)
            l = p.sum(dim=-1, keepdim=True)
            p = p / torch.where(l == 0.0, 1.0, l)
            o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
            o = o.reshape(b, c, self.h * self.dh).to(x.dtype)
        return self.wo(o)
