"""The decoder blocks (port of ``repro.nn.transformer``).

``TransformerBlock``: pre-norm attention + FFN or MoE, with gemma's
sandwich norms when ``post_norms`` is set; an MoE config with
``first_layer_dense`` gives layer 0 a dense FFN of ``dense_d_ff`` instead
(deepseek-moe's prologue). A decoder block of an encoder-decoder
(``cross``) has a cross-attention (seed + 100) after its self-attention,
with its own pre-norm ``ln_cross``. ``forward`` runs the full sequence
(training, prefill, the encoder with ``causal=False``) and returns the MoE
block's aux values (load balance, router z-loss) beside x for the loss, and
with ``collect`` the KV a prefill writes into the dense cache; ``decode``
one token over the dense cache, ``paged_step`` one serving step of the
engine; both drop the aux values as the JAX block does in serving.

``MambaLayer``: norm + the Mamba2 mixer with a residual (no FFN). Its
serving state is per slot ({"ssd", "conv"} rows of the paged cache), and
per row in the dense-cache loop (``decode``).

``SharedAttnBlock``: zamba2's shared block, one parameter set applied
after every ``hybrid.period`` layers: attention over the normed [h,
embedding] (2 x d_model) back to d_model, then the FFN; each application
has its own KV (a page pool, or a dense cache in the dense-cache loop)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .attention import Attention, DecodeView
from .common import ModelConfig, param_dtype_of
from .ffn import FFN, MoE
from .layers import RMSNorm
from .ssm import Mamba2Block


class TransformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, seed: int = 0,
                 device=None, generator: Optional[torch.Generator] = None,
                 layer_idx: int = 0, cross: bool = False):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        window = cfg.attn_window if kind == "local" else None
        self.attn = Attention(cfg, window=window, seed=seed,
                              qk_norm=cfg.post_norms, device=device,
                              generator=generator)
        self.cross_attn = Attention(cfg, cross=True, seed=seed + 100,
                                    device=device, generator=generator) \
            if cross else None
        moe = cfg.moe
        dense_first = moe is not None and moe.first_layer_dense
        self.is_moe = moe is not None and not (dense_first and layer_idx == 0)
        if self.is_moe:
            self.ffn = MoE(cfg, seed=seed, device=device,
                           generator=generator)
        else:
            self.ffn = FFN(cfg, seed=seed, device=device,
                           generator=generator,
                           d_ff=moe.dense_d_ff if dense_first else None)
        pd = param_dtype_of(cfg)
        norm = lambda: RMSNorm(cfg.d_model, cfg.rms_eps, pd, device)  # noqa: E731
        self.ln_attn = norm()
        self.ln_ffn = norm()
        if cross:
            self.ln_cross = norm()
        if cfg.post_norms:
            self.ln_attn_post = norm()
            self.ln_ffn_post = norm()

    def _ffn_res(self, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h = self.ffn(self.ln_ffn(x))
        h, aux = h if self.is_moe else (h, {})
        if self.cfg.post_norms:
            h = self.ln_ffn_post(h)
        return x + h, aux

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                enc_out: Optional[torch.Tensor] = None, causal: bool = True,
                collect: bool = False):
        """Full-sequence forward: x (B, S, d), positions (B, S) -> (x, the
        MoE block's aux values {"moe_lb", "moe_z"}, or {} for an FFN
        block); with ``collect`` also the KV for the dense cache, {"self":
        {"k", "v"}} and for a cross block "cross": the k and v it projected
        from ``enc_out`` (B, Se, d), the encoder's output. ``causal=False``
        makes the self-attention bidirectional (an encoder)."""
        h = self.attn(self.ln_attn(x), positions, causal=causal,
                      collect=collect)
        if collect:
            h, kv = h
            kvs = {"self": kv}
        if self.cfg.post_norms:
            h = self.ln_attn_post(h)
        x = x + h
        if self.cross_attn is not None:
            h = self.cross_attn(self.ln_cross(x), positions, x_kv=enc_out,
                                causal=False, collect=collect)
            if collect:
                h, kvs["cross"] = h
            x = x + h
        x, aux = self._ffn_res(x)
        return (x, aux, kvs) if collect else (x, aux)

    def decode(self, x: torch.Tensor, cache: dict,
               view: DecodeView) -> torch.Tensor:
        """One token per row over the dense cache ({"self": {"k", "v"}}, and
        a cross block's static "cross" one), the self cache updated in
        place at ``view.pos``."""
        h = self.attn.decode(self.ln_attn(x), cache["self"], view)
        if self.cfg.post_norms:
            h = self.ln_attn_post(h)
        x = x + h
        if self.cross_attn is not None:
            x = x + self.cross_attn.decode(self.ln_cross(x), cache["cross"],
                                           view)
        return self._ffn_res(x)[0]

    def paged_step(self, x: torch.Tensor, pos: torch.Tensor,
                   n_new: torch.Tensor, cache: dict,
                   page_table: torch.Tensor) -> torch.Tensor:
        """Serving step (decode or prefill chunk) against paged KV; the
        layer's pages in ``cache`` are updated in place. A cross block has
        no paged step (encoder-decoders serve through ``generate_cached``),
        as in the JAX package."""
        if self.cross_attn is not None:
            raise NotImplementedError("paged serving: no cross-attention")
        h = self.attn.paged_step(self.ln_attn(x), pos, n_new, cache,
                                 page_table)
        if self.cfg.post_norms:
            h = self.ln_attn_post(h)
        return self._ffn_res(x + h)[0]


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mixer = Mamba2Block(cfg, seed=seed, device=device,
                                 generator=generator)
        self.ln = RMSNorm(cfg.d_model, cfg.rms_eps, param_dtype_of(cfg),
                          device)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                collect: bool = False):
        """Full-sequence forward (training, prefill): (x, {}), the aux
        values of a block without MoE; with ``collect`` also the state
        {"ssd", "conv"} the sequence ends with, for the dense cache."""
        h, state = self.mixer(self.ln(x))
        return (x + h, {}, state) if collect else (x + h, {})

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               view: Optional[DecodeView] = None) -> torch.Tensor:
        """One token per row over the dense-cache loop's state {"ssd": (B,
        H, P, N), "conv": (B, K - 1, C)}, stepped in place (``view`` is
        not read: the state holds the position)."""
        h, new = self.mixer.decode(self.ln(x), cache)
        for k, t in cache.items():
            t.copy_(new[k])
        return x + h

    def paged_step(self, x: torch.Tensor, pos: torch.Tensor,
                   n_new: torch.Tensor, cache: Dict[str, torch.Tensor],
                   page_table: torch.Tensor,
                   slot_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One serving step: the decode form at C == 1, else the chunked
        form with the rows' state carried in. ``cache`` holds the state of
        every slot ({"ssd": (slots, H, P, N), "conv": (slots, K - 1, C)});
        row i of x is slot ``slot_ids[i]`` (slot i without ``slot_ids``).
        The state is updated in place; rows with ``n_new == 0`` keep theirs
        exactly (they still run the mixer on their zero tokens)."""
        rows = cache if slot_ids is None else {
            k: t.index_select(0, slot_ids) for k, t in cache.items()}
        h = self.ln(x)
        if x.shape[1] == 1:
            h, new = self.mixer.decode(h, rows)
        else:
            h, new = self.mixer(h, rows)
        active = n_new > 0
        for k, old in rows.items():
            keep = active.reshape((-1,) + (1,) * (old.dim() - 1))
            upd = torch.where(keep, new[k].to(old.dtype), old)
            if slot_ids is None:
                cache[k].copy_(upd)
            else:
                cache[k].index_copy_(0, slot_ids, upd)
        return x + h


class SharedAttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.concat = cfg.hybrid.concat_embedding
        d = cfg.d_model
        d_in = 2 * d if self.concat else d
        kw = dict(device=device, generator=generator)
        self.attn = Attention(cfg, seed=seed, d_in=d_in, **kw)
        self.ffn = FFN(cfg, seed=seed, d_ff=cfg.hybrid.shared_d_ff, d_in=d,
                       **kw)
        pd = param_dtype_of(cfg)
        self.ln_in = RMSNorm(d_in, cfg.rms_eps, pd, device)
        self.ln_ffn = RMSNorm(d, cfg.rms_eps, pd, device)

    def _input(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, emb], dim=-1) if self.concat else x

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                positions: torch.Tensor, *, collect: bool = False):
        """Full-sequence forward: x and the input embedding ``emb`` (B, S,
        d), positions (B, S) -> (B, S, d); with ``collect`` also {"self":
        {"k", "v"}} for the dense cache."""
        h = self.attn(self.ln_in(self._input(x, emb)), positions,
                      collect=collect)
        if collect:
            h, kv = h
        x = x + h
        x = x + self.ffn(self.ln_ffn(x))
        return (x, {"self": kv}) if collect else x

    def decode(self, x: torch.Tensor, emb: torch.Tensor, cache: dict,
               view: DecodeView) -> torch.Tensor:
        """One token per row over this application's dense cache
        ({"self": {"k", "v"}}, written in place at ``view.pos``)."""
        x = x + self.attn.decode(self.ln_in(self._input(x, emb)),
                                 cache["self"], view)
        return x + self.ffn(self.ln_ffn(x))

    def paged_step(self, x: torch.Tensor, emb: torch.Tensor,
                   pos: torch.Tensor, n_new: torch.Tensor, cache: dict,
                   page_table: torch.Tensor) -> torch.Tensor:
        """One serving step against this application's page pool."""
        x = x + self.attn.paged_step(self.ln_in(self._input(x, emb)), pos,
                                     n_new, cache, page_table)
        return x + self.ffn(self.ln_ffn(x))
