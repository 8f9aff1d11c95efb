"""The decoder block (port of ``repro.nn.transformer.TransformerBlock``):
pre-norm attention + FFN or MoE, with gemma's sandwich norms when
``post_norms`` is set; an MoE config with ``first_layer_dense`` gives
layer 0 a dense FFN of ``dense_d_ff`` instead (deepseek-moe's prologue).
``forward`` runs the full sequence (training) and returns the MoE block's
aux values (load balance, router z-loss) beside x for the loss,
``paged_step`` one serving step, which drops them as the JAX block does in
serving."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .attention import Attention
from .common import ModelConfig, param_dtype_of
from .ffn import FFN, MoE
from .layers import RMSNorm


class TransformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, seed: int = 0,
                 device=None, generator: Optional[torch.Generator] = None,
                 layer_idx: int = 0):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        window = cfg.attn_window if kind == "local" else None
        self.attn = Attention(cfg, window=window, seed=seed,
                              qk_norm=cfg.post_norms, device=device,
                              generator=generator)
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

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence forward: x (B, S, d), positions (B, S) -> (x, the
        MoE block's aux values {"moe_lb", "moe_z"}, or {} for an FFN
        block)."""
        h = self.attn(self.ln_attn(x), positions)
        if self.cfg.post_norms:
            h = self.ln_attn_post(h)
        return self._ffn_res(x + h)

    def paged_step(self, x: torch.Tensor, pos: torch.Tensor,
                   n_new: torch.Tensor, cache: dict,
                   page_table: torch.Tensor) -> torch.Tensor:
        """Serving step (decode or prefill chunk) against paged KV; the
        layer's pages in ``cache`` are updated in place."""
        h = self.attn.paged_step(self.ln_attn(x), pos, n_new, cache,
                                 page_table)
        if self.cfg.post_norms:
            h = self.ln_attn_post(h)
        return self._ffn_res(x + h)[0]
