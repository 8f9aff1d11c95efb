"""The training engine (port of ``repro.train.trainer``): one optimizer step
per batch, with gradient accumulation over micro-batches and the AdamW
update written by hand.

The model's parameters stay in their parameter dtype (f32) and the forward
runs in the compute dtype (bf16 at full width), each junction through the
CUDA kernels on the card (forward, backward-data and backward-weights) and
through their plain versions on the CPU. The JAX trainer's device mesh,
DiLoCo outer loop, checkpointing, metrics registry and profiler hooks are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..nn.common import resolve_device
from ..optim import adam


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    opt: adam.AdamWConfig = dataclasses.field(
        default_factory=adam.AdamWConfig)
    grad_accum: int = 1
    log_every: int = 10


class Trainer:
    """Trains ``model`` (an ``LM``) on ``device``: the card unless the
    caller names another; raises where there is no card."""

    def __init__(self, model, cfg: Optional[TrainerConfig] = None, *,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg or TrainerConfig()

    def init_state(self) -> Tuple[Dict[str, torch.Tensor], dict]:
        """(params, opt): the model's parameters by name, and zero AdamW
        state for them."""
        params = dict(self.model.named_parameters())
        return params, adam.init(params)

    def to_device(self, batch: dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     torch.long)
                for k, v in batch.items()}

    def train_step(self, params: Dict[str, torch.Tensor], opt: dict,
                   batch: Dict[str, torch.Tensor]):
        """Loss and gradients over ``grad_accum`` micro-batches (the
        gradients summed, then divided by their count), then one AdamW
        update in place. Returns (params, opt, metrics) with 0-d tensors as
        metric values."""
        accum = self.cfg.grad_accum
        for p in params.values():
            p.grad = None
        n = next(iter(batch.values())).shape[0]
        if n % accum:
            raise ValueError(f"batch {n} does not split into {accum} "
                             f"micro-batches")
        mb = n // accum
        loss_sum = None
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, metrics = self.model.loss(micro)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = {name: p.grad for name, p in params.items()}
        if accum > 1:
            for g in grads.values():
                g.div_(accum)
        params, opt, opt_metrics = adam.update(self.cfg.opt, grads, opt,
                                               params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics, loss=loss_sum / accum)
        return params, opt, metrics

    def fit(self, data_iter: Iterator[dict], steps: int,
            on_step: Optional[Callable[[int, dict], None]] = None,
            params=None, opt=None):
        """Run ``steps`` optimizer steps on batches from ``data_iter``
        (dicts of numpy arrays). Every ``log_every`` steps and after the
        last, the metrics (and tokens/s over the window since the last log)
        go to ``on_step(step, metrics)`` or are printed. Returns (params,
        opt, history)."""
        if params is None:
            params, opt = self.init_state()
        history = []
        win_t0, win_tokens = time.perf_counter(), 0
        for step in range(steps):
            batch = self.to_device(next(data_iter))
            params, opt, metrics = self.train_step(params, opt, batch)
            win_tokens += batch["labels"].numel()
            if (step + 1) % self.cfg.log_every == 0 or step == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()  # float() above synced the device
                m["tokens_per_s"] = win_tokens / max(now - win_t0, 1e-9)
                win_t0, win_tokens = now, 0
                history.append({"step": step + 1, **m})
                if on_step:
                    on_step(step + 1, m)
                else:
                    print(f"step {step + 1:>6d}  loss {m['loss']:.4f}  "
                          f"tok/s {m['tokens_per_s']:,.0f}  "
                          f"grad_norm {m['grad_norm']:.3f}", flush=True)
        return params, opt, history
