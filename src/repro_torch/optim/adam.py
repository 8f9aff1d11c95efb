"""AdamW written by hand, with its schedules and global-norm clipping (port of
``repro.optim.adam``).

Parameters, gradients and the moments are plain dictionaries of tensors
keyed by parameter name. Unlike the JAX package, whose update is pure,
``update`` works in place: it scales the gradients by the clip factor,
updates the moments and steps the parameters without copies, because at
gemma3-4b's size every extra copy of the f32 state is 11 GB of device
memory. The moments are f32 whatever the parameters' dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"  # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup to ``lr``, then cosine or linear decay to
    ``min_lr_ratio * lr`` at ``total_steps``, or constant."""
    step = float(step)
    warm = min(1.0, (step + 1.0) / max(cfg.warmup_steps, 1))
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = min(max((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
        if cfg.schedule == "cosine":
            decay = 0.5 * (1.0 + math.cos(math.pi * frac))
        else:
            decay = 1.0 - frac
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def init(params: Tensors) -> dict:
    """Zero f32 moments for every parameter, and step 0."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    return {"m": zeros(), "v": zeros(), "step": 0}


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-d tensor on
    the tensors' device; no host sync)."""
    total = None
    for t in tensors.values():
        tf = t.detach().float().reshape(-1)
        sq = torch.dot(tf, tf)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Tensors, state: dict, params: Tensors
           ) -> Tuple[Tensors, dict, dict]:
    """One AdamW step, in place on ``grads`` (clipped), ``state`` and
    ``params``. Weight decay applies to parameters with ndim >= 2 only (the
    matrices and slabs, not the norm scales). Returns (params, state,
    {"grad_norm", "lr"}), the norm taken before clipping."""
    step = state["step"]
    gnorm = global_norm(grads)
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        for g in grads.values():
            g.mul_(scale.to(g.dtype))
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step + 1
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for name, p in params.items():
        g = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        step_v = (m / bc1).div_(denom)
        del denom
        if cfg.weight_decay and p.ndim >= 2:  # decay matrices only
            step_v.add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(step_v, alpha=lr)
        else:
            p.copy_(p.float().sub_(step_v, alpha=lr))
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}
