"""The FFN block (port of ``repro.nn.ffn.FFN``): the junctions where the
paper's pre-defined sparsity attaches. ``rho_ffn = (rho_up, rho_down)``
follows the paper's trend 3 (later junctions denser)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .common import ModelConfig, param_dtype_of
from .layers import Linear, activation

# activation names the fused csd_matmul epilogue understands (the registry
# binds gelu and gelu_tanh to the same tanh-approximate function)
_FUSABLE = {"relu": "relu", "gelu": "gelu", "gelu_tanh": "gelu"}


class FFN(nn.Module):
    """(Gated) feed-forward junction pair, optionally pre-defined sparse.
    The junction seeds are the JAX package's (+11 up, +12 gate, +13 down):
    the seed picks each junction's sparsity pattern."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        sp = cfg.sparsity
        rho_up, rho_down = sp.rho_ffn if sp.enabled else (1.0, 1.0)
        kw = dict(sp=sp, dtype=param_dtype_of(cfg), device=device,
                  generator=generator)
        d, d_ff = cfg.d_model, cfg.d_ff
        self.up = Linear(d, d_ff, rho=rho_up, seed=seed + 11, **kw)
        self.gate = Linear(d, d_ff, rho=rho_up, seed=seed + 12, **kw) \
            if cfg.ffn_gated else None
        self.down = Linear(d_ff, d, rho=rho_down, seed=seed + 13, **kw)
        self.act = activation(cfg.act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = _FUSABLE.get(self.cfg.act)
        if self.gate is not None:
            h = self.up(x)
            # the activation fuses into the *gate* junction's epilogue
            g = self.gate(x, activation=fused)
            if fused is None:
                g = self.act(g)
            h = g * h
        else:
            h = self.up(x, activation=fused)
            if fused is None:
                h = self.act(h)
        return self.down(h)
