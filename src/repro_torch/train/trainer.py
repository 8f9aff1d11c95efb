"""The training engine (port of ``repro.train.trainer``): one optimizer step
per batch, with gradient accumulation over micro-batches and the AdamW
update written by hand, a DiLoCo outer loop with int8 error-feedback
compression, checkpoint-resume and the obs registry.

The model's parameters stay in their parameter dtype (f32) and the forward
runs in the compute dtype (bf16 at full width), each junction through the
CUDA kernels on the card (forward, backward-data and backward-weights) and
through their plain versions on the CPU. ``fit`` restores the latest
committed checkpoint into the live parameters and AdamW state, saves every
``checkpoint_every`` steps without waiting for the write and at the end,
runs the DiLoCo sync every ``diloco_period`` steps, and records each step
into the registry under ``span("train/step")`` (host-side: the step's
launches are the same with metrics on or off, and ``train_step`` makes no
host sync), all inside ``profile_trace(profile_dir)``. The JAX trainer's
device mesh (sharded state, the cross-pod DiLoCo mean) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..nn.common import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..optim import adam
from ..optim.compression import dequantize_int8, quantize_int8
from .checkpoint import CheckpointManager


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    opt: adam.AdamWConfig = dataclasses.field(
        default_factory=adam.AdamWConfig)
    grad_accum: int = 1
    diloco_period: int = 0       # 0 = no outer loop
    diloco_outer_lr: float = 0.7
    diloco_outer_momentum: float = 0.9
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    checkpoint_keep: int = 3
    log_every: int = 10
    # ``metrics`` routes per-step timing, loss and gradient norm through
    # the process obs registry (host-side only); ``profile_dir`` captures a
    # torch.profiler Chrome trace of the whole fit() into that directory
    metrics: bool = True
    profile_dir: Optional[str] = None


class Trainer:
    """Trains ``model`` (an ``LM``) on ``device``: the card unless the
    caller names another; raises where there is no card."""

    def __init__(self, model, cfg: Optional[TrainerConfig] = None, *,
                 device=None, registry: Optional[obs_metrics.Registry] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg = cfg or TrainerConfig()
        self.obs = obs_metrics.resolve(registry, enabled=cfg.metrics)
        self._m_steps = self.obs.counter(
            "train_steps_total", "optimizer steps taken")
        self._m_tokens = self.obs.counter(
            "train_tokens_total", "tokens consumed (batch * seq)")
        self._m_step_s = self.obs.histogram(
            "train_step_seconds",
            "per-step wall clock (first step includes compile)")
        self._m_loss = self.obs.gauge("train_loss", "last logged loss")
        self._m_gnorm = self.obs.gauge(
            "train_grad_norm", "last logged global gradient norm")
        self._m_tps = self.obs.gauge(
            "train_tokens_per_s",
            "throughput over the last log window")
        self._m_micro = self.obs.gauge(
            "train_microbatches", "grad-accum microbatches per step")
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      cfg.checkpoint_keep) \
            if cfg.checkpoint_dir else None

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

    # -- DiLoCo outer sync ---------------------------------------------------

    def make_diloco_state(self, params: Dict[str, torch.Tensor]) -> dict:
        """f32 anchor (a copy of the parameters: never their storage), outer
        momentum and error-feedback buffers, keyed like ``params``."""
        with torch.no_grad():
            return {"anchor": {n: p.detach().to(torch.float32, copy=True)
                               for n, p in params.items()},
                    "outer_m": {n: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                                for n, p in params.items()},
                    "err": {n: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                            for n, p in params.items()}}

    @torch.no_grad()
    def diloco_sync(self, params: Dict[str, torch.Tensor], dstate: dict,
                    axis_name: Optional[str] = None):
        """Outer step, parameter by parameter and in place: the delta
        ``anchor - p`` compressed to int8 with error feedback, its mean
        (local: no process group), the outer momentum ``m = mu m + mean``,
        ``anchor -= lr m``, then ``p`` takes the anchor's values. The device
        holds the three state copies and one parameter's temporaries, never
        a second tree. Returns (params, dstate)."""
        if axis_name is not None:
            raise NotImplementedError(
                "DiLoCo across pods needs the multi-device slice")
        cfg = self.cfg
        for name, p in params.items():
            anchor = dstate["anchor"][name]
            outer_m, err = dstate["outer_m"][name], dstate["err"][name]
            target = torch.sub(anchor, p).add_(err)     # delta + err, f32
            q, scale = quantize_int8(target)
            mean = dequantize_int8(q, scale)
            del q
            torch.sub(target, mean, out=err)
            outer_m.mul_(cfg.diloco_outer_momentum).add_(mean)
            del mean
            # lr * m rounded before the subtraction, as the reference's
            # (``sub_(alpha=)`` would fuse the two into one rounding)
            anchor.sub_(torch.mul(outer_m, cfg.diloco_outer_lr, out=target))
            del target
            p.copy_(anchor)
        return params, dstate

    # -- the loop -------------------------------------------------------------

    def fit(self, data_iter: Iterator[dict], steps: int,
            on_step: Optional[Callable[[int, dict], None]] = None,
            params=None, opt=None, resume: bool = True):
        """Run optimizer steps ``start + 1 .. steps`` on batches from
        ``data_iter`` (dicts of numpy arrays), ``start`` being the latest
        committed checkpoint's step (restored in place into ``params`` and
        ``opt``) with ``resume`` and a checkpoint directory, else 0. Every
        ``log_every`` steps and after the last, the metrics (and tokens/s
        over the window since the last log) go to ``on_step(step,
        metrics)`` or are printed. Returns (params, opt, history)."""
        cfg = self.cfg
        if params is None:
            params, opt = self.init_state()
        start = 0
        if resume and self.ckpt is not None and self.ckpt.latest_step():
            start = self.ckpt.latest_step()
            state, _ = self.ckpt.restore(start, {"params": params,
                                                 "opt": opt})
            opt = state["opt"]
        dstate = self.make_diloco_state(params) \
            if cfg.diloco_period else None
        history = []
        saved = None
        self._m_micro.set(cfg.grad_accum)
        win_t0, win_tokens = time.perf_counter(), 0
        with obs_trace.profile_trace(cfg.profile_dir):
            for step in range(start, steps):
                batch = self.to_device(next(data_iter))
                t0 = time.perf_counter()
                with obs_trace.span("train/step", registry=self.obs):
                    params, opt, metrics = self.train_step(params, opt,
                                                           batch)
                # launch wall clock: once the queue fills it follows the
                # device's step time
                self._m_step_s.observe(time.perf_counter() - t0)
                n_tok = batch["labels"].numel()
                win_tokens += n_tok
                self._m_steps.inc()
                self._m_tokens.inc(n_tok)
                if cfg.diloco_period and (step + 1) % cfg.diloco_period == 0:
                    params, dstate = self.diloco_sync(params, dstate)
                if (step + 1) % cfg.log_every == 0 or step == steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()  # float() synced the device
                    m["tokens_per_s"] = win_tokens / max(now - win_t0, 1e-9)
                    win_t0, win_tokens = now, 0
                    self._m_loss.set(m["loss"])
                    self._m_gnorm.set(m["grad_norm"])
                    self._m_tps.set(m["tokens_per_s"])
                    history.append({"step": step + 1, **m})
                    if on_step:
                        on_step(step + 1, m)
                    else:
                        print(f"step {step + 1:>6d}  loss {m['loss']:.4f}  "
                              f"tok/s {m['tokens_per_s']:,.0f}  "
                              f"grad_norm {m['grad_norm']:.3f}", flush=True)
                if self.ckpt and (step + 1) % cfg.checkpoint_every == 0:
                    self.ckpt.save(step + 1, {"params": params, "opt": opt},
                                   async_=True)
                    saved = step + 1
        if self.ckpt:
            if saved != steps:  # the last async save may already hold it
                self.ckpt.save(steps, {"params": params, "opt": opt})
            self.ckpt.wait()
        return params, opt, history
