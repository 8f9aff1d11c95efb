"""GQA attention (port of ``repro.nn.attention``): ``Attention.forward`` for
the full sequence (training, prefill and the encoder) and
``chunked_attention``, its reference; ``Attention.decode`` over the dense
per-request cache of ``generate_cached``, ``decode_attention`` its
reference; ``Attention.paged_step`` for the serving engine.

The full-sequence path runs ``kernels.flash_attention.FlashAttention``
(forward, and a backward that recomputes the probabilities from the saved
row log-sum-exp): the hand-written flash-attention kernels on the card,
their plain versions on the CPU, so that both devices run the same wiring.
It is causal self-attention in a decoder, bidirectional in an encoder
(``causal=False``), and bidirectional cross-attention with queries from x
and keys and values from ``x_kv`` (an encoder's output, Sq != Skv) in a
cross layer (``cross=True``: no rope, no QKV bias). This follows the JAX
package's docstrings, where the Pallas kernel takes the place of its
q-chunk scan on real hardware. ``chunked_attention`` is that scan, the JAX
training path's XLA form in plain torch (a loop over query chunks, a static
window span sliced out of KV for sliding-window layers, and for long KV an
online-softmax merge over KV chunks); the model does not call it, and it
stays as the reference the layer is held against.

Decode (one token per row) runs through the paged decode kernel: over the
engine's page pools in ``paged_step``, and in ``decode`` over the dense
cache viewed as a pool of 16-row pages (``kernels.flash_attention.
dense_decode_attention``), a self layer's keys up to its position, a cross
layer's the encoder's frames. ``decode_attention`` is the JAX package's
XLA einsums over the dense cache in plain torch; the model does not call
it. A prefill chunk of the engine gathers the row's logical KV view and
runs masked grouped attention in plain torch, as the JAX package does with
a gather and einsums.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..kernels.flash_attention import (FlashAttention,
                                       dense_decode_attention,
                                       paged_decode_attention)
from ..serving import kv_cache
from .common import ModelConfig, param_dtype_of
from .layers import Linear, RMSNorm, apply_rope

_NEG_INF = -1e30


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _attend_block(q_chunk, k_c, v_c, qpos, kpos, *, causal, window,
                  softcap, scale):
    """One (q-block x kv-block) attention with flash-style partials: the
    un-normalised f32 output (B, Q, Hkv, G, Dh) and the per-row max and
    exp-sum (B, Hkv, G, Q), so that blocks can be merged online."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q_chunk.float() * scale,
                          k_c.float())
    logits = _softcap(logits, softcap)
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=logits.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, _NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - torch.clamp_min(m, _NEG_INF / 2)[..., None])
    p = torch.where((m > _NEG_INF / 2)[..., None], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_c.float())
    return o, m, l


def _per_row(t: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, Q) row statistics -> (B, Q, Hkv, G, 1), to scale o."""
    return t.permute(0, 3, 1, 2)[..., None]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int],
                      softcap: Optional[float], chunk: int, scale: float,
                      q_offset: int = 0,
                      kv_chunk: Optional[int] = None) -> torch.Tensor:
    """Memory-bounded attention (port of ``repro.nn.attention.
    chunked_attention``). q (B, Sq, Hkv, G, Dh) grouped; k, v (B, Skv, Hkv,
    Dh) -> (B, Sq, Hkv, G, Dh) in the dtype of q. Query chunks of ``chunk``
    rows; a windowed causal layer attends to a span of KV rounded up to 128
    keys around each chunk; without a window and for KV longer than
    ``2 * kv_chunk`` the KV chunks are merged online. A row with no visible
    key gives 0."""
    b, sq, hkv, g, dh = q.shape
    skv = k.shape[1]
    chunk = min(chunk, sq)
    pad_q = (-sq) % chunk
    if pad_q:
        q = torch.cat([q, q.new_zeros((b, pad_q, hkv, g, dh))], dim=1)
    n_chunks = (sq + pad_q) // chunk
    use_window_slice = (window is not None and causal
                        and window + chunk < skv)
    span = min(skv, ((window or 0) + chunk + 127) // 128 * 128) \
        if use_window_slice else skv
    use_kv_scan = (kv_chunk is not None and not use_window_slice
                   and skv > 2 * kv_chunk and skv % kv_chunk == 0)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    dev = q.device
    outs = []
    for i in range(n_chunks):
        q_chunk = q[:, i * chunk:(i + 1) * chunk]
        q_start = i * chunk + q_offset
        qpos = q_start + torch.arange(chunk, device=dev)
        if use_window_slice:
            start = min(max(q_start + chunk - span, 0), skv - span)
            k_c, v_c = k[:, start:start + span], v[:, start:start + span]
            kpos = start + torch.arange(span, device=dev)
        else:
            k_c, v_c, kpos = k, v, torch.arange(skv, device=dev)
        if not use_kv_scan:
            o, _, l = _attend_block(q_chunk, k_c, v_c, qpos, kpos, **kw)
        else:
            o = torch.zeros((b, chunk, hkv, g, dh), dtype=torch.float32,
                            device=dev)
            m = torch.full((b, hkv, g, chunk), _NEG_INF, device=dev)
            l = torch.zeros((b, hkv, g, chunk), device=dev)
            for j in range(skv // kv_chunk):
                sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
                o_j, m_j, l_j = _attend_block(
                    q_chunk, k_c[:, sl], v_c[:, sl], qpos, kpos[sl], **kw)
                m_new = torch.maximum(m, m_j)
                c_old = torch.where(m > _NEG_INF / 2, torch.exp(m - m_new),
                                    0.0)
                c_new = torch.where(m_j > _NEG_INF / 2,
                                    torch.exp(m_j - m_new), 0.0)
                l = l * c_old + l_j * c_new
                o = o * _per_row(c_old) + o_j * _per_row(c_new)
                m = m_new
        safe_l = torch.where(l == 0.0, 1.0, l)
        outs.append((o / _per_row(safe_l)).to(q.dtype))
    out = torch.cat(outs, dim=1) if n_chunks > 1 else outs[0]
    return out[:, :sq] if pad_q else out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     pos: int, window: Optional[int],
                     softcap: Optional[float], scale: float) -> torch.Tensor:
    """One query token over a dense cache (port of ``repro.nn.attention.
    decode_attention``): q (B, 1, Hkv, G, Dh), k, v (B, S, Hkv, Dh); keys at
    or before ``pos`` (and inside the window) are visible -> (B, 1, Hkv, G,
    Dh) in the dtype of q."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float() * scale, k.float())
    logits = _softcap(logits, softcap)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos <= pos
    if window is not None:
        mask &= kpos > pos - window
    logits = torch.where(mask, logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.to(q.dtype)


class DecodeView(NamedTuple):
    """What every layer of one dense-cache decode step shares: the position
    ``pos`` being written, as an int and as rope positions (B, 1); the page
    table and lengths (``pos + 1``) that view the self caches as page pools;
    for a decoder with cross-attention those of the encoder caches (lengths
    the encoder's frames), else None."""
    pos: int
    positions: torch.Tensor
    table: torch.Tensor
    lengths: torch.Tensor
    cross_table: Optional[torch.Tensor] = None
    cross_lengths: Optional[torch.Tensor] = None


class Attention(nn.Module):
    """GQA self- or cross-attention with rope, optional qk-norm, window and
    logit softcap, and optionally pre-defined-sparse projections. ``d_in``
    is the width q, k and v are projected from (d_model by default; zamba2's
    shared block reads [h, embedding], 2 x d_model); the output projects
    back to d_model. A cross layer (``cross``) projects k and v from the
    encoder's output, applies no rope and has no QKV bias."""

    def __init__(self, cfg: ModelConfig, *, window: Optional[int] = None,
                 cross: bool = False, seed: int = 0, qk_norm: bool = False,
                 device=None, generator: Optional[torch.Generator] = None,
                 d_in: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        self.window = window
        self.cross = cross
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
        d = d_in or cfg.d_model
        bias = cfg.qkv_bias and not cross
        self.wq = Linear(d, h * dh, bias=bias, seed=seed + 1, **kw)
        self.wk = Linear(d, kv * dh, bias=bias, seed=seed + 2, **kw)
        self.wv = Linear(d, kv * dh, bias=bias, seed=seed + 3, **kw)
        self.wo = Linear(h * dh, cfg.d_model, bias=False, seed=seed + 4, **kw)
        if qk_norm:
            self.qnorm = RMSNorm(dh, cfg.rms_eps, pd, device)
            self.knorm = RMSNorm(dh, cfg.rms_eps, pd, device)

    def _q(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        q = self.wq(x).reshape(x.shape[0], -1, self.h, self.dh)
        if self.qk_norm:
            q = self.qnorm(q)
        return q if self.cross else apply_rope(q, positions,
                                               self.cfg.rope_theta)

    def _kv(self, src: torch.Tensor, positions: torch.Tensor):
        b = src.shape[0]
        k = self.wk(src).reshape(b, -1, self.kv, self.dh)
        v = self.wv(src).reshape(b, -1, self.kv, self.dh)
        if self.qk_norm:
            k = self.knorm(k)
        if not self.cross:
            k = apply_rope(k, positions, self.cfg.rope_theta)
        return k, v

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor,
             x_kv: Optional[torch.Tensor] = None):
        """q from x; k and v from ``x_kv`` (a cross layer's encoder output)
        or x; rope on q and k of a self layer at ``positions``."""
        return (self._q(x, positions),) + self._kv(
            x if x_kv is None else x_kv, positions)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                x_kv: Optional[torch.Tensor] = None, causal: bool = True,
                collect: bool = False):
        """Full-sequence attention through ``FlashAttention``: x (B, S, d),
        positions (B, S) -> (B, S, d); causal unless ``causal`` is False
        or the layer is a cross layer, whose keys and values come from
        ``x_kv`` (B, Skv, d). With ``collect`` also the layer's {"k", "v"}
        (B, Skv, Hkv, Dh), for a prefill to write into its cache."""
        b, sq, _ = x.shape
        q, k, v = self._qkv(x, positions, x_kv)
        o = FlashAttention.apply(q, k, v, causal and not self.cross,
                                 self.window, self.cfg.logit_softcap,
                                 self.dh ** -0.5, 0)
        out = self.wo(o.reshape(b, sq, self.h * self.dh))
        return (out, {"k": k, "v": v}) if collect else out

    def decode(self, x: torch.Tensor, cache: dict,
               view: DecodeView) -> torch.Tensor:
        """One token per row over the dense cache: x (B, 1, d); cache
        {"k", "v"} (B, S, Hkv, Dh), S a multiple of 16. A self layer writes
        its new k and v at ``view.pos`` in place and attends to the keys up
        to it (and inside its window); a cross layer reads its static
        encoder cache and projects no k and v from x. Returns (B, 1, d)."""
        b = x.shape[0]
        q = self._q(x, view.positions)
        if self.cross:
            table, lengths, window = view.cross_table, view.cross_lengths, \
                None
        else:
            k_new, v_new = self._kv(x, view.positions)
            cache["k"][:, view.pos] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][:, view.pos] = v_new[:, 0].to(cache["v"].dtype)
            table, lengths, window = view.table, view.lengths, self.window
        o = dense_decode_attention(
            q.reshape(b, self.kv, self.groups, self.dh), cache["k"],
            cache["v"], lengths, window=window,
            softcap=self.cfg.logit_softcap, scale=self.dh ** -0.5,
            page_table=table)
        return self.wo(o.reshape(b, 1, self.h * self.dh).to(x.dtype))

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
        With ``k_scale``/``v_scale`` ((P+1, page) f32) in the cache the
        pages are int8: new KV is quantized at append, decode runs the int8
        kernel, and a prefill chunk dequantizes the gathered pages in f32.
        Returns (B, C, d).
        """
        cfg = self.cfg
        b, c = x.shape[:2]
        k_pages, v_pages = cache["k_pages"], cache["v_pages"]
        scales = {k: cache[k] for k in ("k_scale", "v_scale") if k in cache}
        page_size = k_pages.shape[1]
        trash = k_pages.shape[0] - 1
        steps = torch.arange(c, dtype=torch.int32, device=x.device)
        positions = pos[:, None] + steps[None]
        valid = steps[None] < n_new[:, None]

        q, k_new, v_new = self._qkv(x, positions)
        phys, off = kv_cache.physical_addresses(
            page_table, positions, valid, page_size, trash)
        if scales:
            kv_cache.write_kv_quant(k_pages, v_pages, scales["k_scale"],
                                    scales["v_scale"], k_new, v_new, phys,
                                    off)
        else:
            kv_cache.write_kv(k_pages, v_pages, k_new, v_new, phys, off)
        lengths = pos + n_new
        scale = self.dh ** -0.5

        if c == 1:
            qg = q.reshape(b, self.kv, self.groups, self.dh)
            o = paged_decode_attention(
                qg.contiguous(), k_pages, v_pages, page_table, lengths,
                window=self.window, softcap=cfg.logit_softcap, scale=scale,
                **scales)
            o = o.reshape(b, 1, self.h * self.dh).to(x.dtype)
        else:
            k = kv_cache.gather_kv(k_pages, page_table)
            v = kv_cache.gather_kv(v_pages, page_table)
            if scales:
                ks = kv_cache.gather_scales(scales["k_scale"], page_table)
                vs = kv_cache.gather_scales(scales["v_scale"], page_table)
                k = k.float() * ks[:, :, None, None]
                v = v.float() * vs[:, :, None, None]
            k, v = k.to(q.dtype), v.to(q.dtype)
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
