"""The paper's own model: a pre-defined sparse MLP, eqs. (2)-(4) (port of
``repro.nn.mlp``).

The reproduction's settings (paper section IV-A): ReLU hidden activations,
softmax output, He weight init, bias init 0.1, Adam, an L2 penalty on the
weights scaled down with the density. Per-junction pattern method, density
and block cap are the knobs of Tables I/II and Figs. 6-12.

``mode='mask'`` trains a dense weight under a fixed 0/1 mask (the paper's
per-edge dynamics at dense-matmul speed); ``mode='gather'`` stores only the
|W_i| weights; ``mode='block_gather'``/``'block_scatter'`` lift the pattern
to blocks of at most ``block`` x ``block`` (shrunk per junction until they
divide both widths: 16 x 4, 4 x 4, 1 x 2 ... at the paper's widths) and run
the forward and the backward through ``kernels.ops.csd_matmul`` with the
hidden ReLU fused into its epilogue: on the card the small-block forms of
the junction kernels (``csrc/csd_spmm_small.cu``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.block_pattern import shrink_to_divisor
from ..core.sparse_linear import SparseLinear, SparseLinearSpec
from .common import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    n_net: Tuple[int, ...] = (800, 100, 10)
    # per-junction densities; None = fully connected
    rho: Optional[Tuple[float, ...]] = None
    method: str = "clashfree"          # clashfree | structured | random
    cf_type: int = 1
    dither: bool = False
    z: Optional[Tuple[int, ...]] = None  # degree of parallelism per junction
    mode: str = "mask"     # mask | gather | block_gather | block_scatter
    block: int = 16        # block size cap of the block modes (shrunk per
    #                        junction until it divides both widths)
    bias_init: float = 0.1
    seed: int = 0

    @property
    def n_junctions(self) -> int:
        return len(self.n_net) - 1

    def junction_rho(self, i: int) -> float:
        if self.rho is None:
            return 1.0
        return self.rho[i]


def junction_specs(cfg: MLPConfig):
    """The ``SparseLinearSpec`` of every junction, as the JAX package
    builds them: dense where rho >= 1, mask for random patterns, blocks of
    the cap shrunk to a divisor of each width."""
    specs = []
    for i in range(cfg.n_junctions):
        rho = cfg.junction_rho(i)
        mode = cfg.mode if rho < 1.0 else "dense"
        if cfg.method == "random" and rho < 1.0:
            mode = "mask"  # random patterns have no fixed degrees
        n_in, n_out = cfg.n_net[i], cfg.n_net[i + 1]
        specs.append(SparseLinearSpec(
            n_in=n_in, n_out=n_out, rho=rho, mode=mode, method=cfg.method,
            cf_type=cfg.cf_type, dither=cfg.dither, seed=cfg.seed * 1000 + i,
            block_in=shrink_to_divisor(n_in, cfg.block),
            block_out=shrink_to_divisor(n_out, cfg.block), use_bias=True))
    return specs


def mlp_patterns(n_net, rho) -> list:
    """The block patterns of a paper MLP's junctions in ``block_gather``
    mode (the 16 cap shrunk per junction), in order; None for a dense
    one."""
    return [s.block_pattern() if s.mode != "dense" else None
            for s in junction_specs(MLPConfig(n_net=n_net, rho=rho,
                                              mode="block_gather"))]


class SparseMLP(nn.Module):
    """The junctions ``layers[i]`` (``SparseLinear``), on ``device`` (the
    card unless the caller names another), initialised from ``generator``
    (default: one seeded with ``cfg.seed``) with every bias set to
    ``cfg.bias_init``."""

    def __init__(self, cfg: MLPConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(cfg.seed)
        self.layers = nn.ModuleList(
            SparseLinear(s, device=self.device, generator=generator)
            for s in junction_specs(cfg))
        with torch.no_grad():
            for layer in self.layers:
                layer.bias.fill_(cfg.bias_init)

    # -- parameters -------------------------------------------------------

    def init(self, generator) -> Dict[str, torch.Tensor]:
        """Fresh parameters by name (``layers.{i}.weight``/``.bias``): He
        scaling over each junction's in-degree, biases ``cfg.bias_init``.
        ``generator`` is a ``torch.Generator`` on the model's device or an
        int seed for one."""
        if isinstance(generator, int):
            generator = torch.Generator(self.device).manual_seed(generator)
        out = {}
        for i, layer in enumerate(self.layers):
            out[f"layers.{i}.weight"] = layer.init_weight(generator)
            out[f"layers.{i}.bias"] = torch.full_like(layer.bias,
                                                      self.cfg.bias_init)
        return out

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy ``params`` (every parameter by name) into the model."""
        own = dict(self.named_parameters())
        if set(params) != set(own):
            raise ValueError(f"parameter mismatch: {sorted(set(own))} vs "
                             f"{sorted(set(params))}")
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(torch.as_tensor(params[name]))

    def n_weights(self) -> int:
        """|W| summed over junctions (the paper's complexity measure)."""
        return sum(layer.n_weights for layer in self.layers)

    def density(self) -> float:
        den = sum(layer.spec.n_in * layer.spec.n_out for layer in self.layers)
        return self.n_weights() / den

    # -- forward / loss ---------------------------------------------------

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The hidden ReLU fused into each junction but the last (softmax
        in the loss)."""
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            h = layer(h, activation="relu" if i < last else None)
        return h

    def loss(self, x: torch.Tensor, y: torch.Tensor,
             l2: float = 0.0) -> torch.Tensor:
        logp = torch.log_softmax(self.logits(x), dim=-1)
        nll = -torch.mean(torch.gather(logp, 1, y.long()[:, None]))
        if l2 > 0.0:
            nll = nll + l2 * sum(torch.sum(layer.weight ** 2)
                                 for layer in self.layers)
        return nll

    def accuracy(self, x: torch.Tensor, y: torch.Tensor) -> float:
        with torch.no_grad():
            hit = torch.argmax(self.logits(x), -1) == y.long()
        return float(hit.float().mean())


def train_mlp(
    model: SparseMLP,
    data: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    *,
    epochs: int = 20,
    batch: int = 256,
    lr: float = 1e-3,
    l2: float = 1e-4,
    seed: int = 0,
    lr_decay: float = 1e-5,
    params: Optional[Dict[str, torch.Tensor]] = None,
    on_step=None,
) -> Tuple[Dict[str, torch.Tensor], float]:
    """The JAX package's Adam loop on ``model``'s device: parameters from
    ``params`` (by name; e.g. a JAX init moved over with
    ``convert.mlp_from_jax_params``) or fresh from ``seed``; batches in the
    order of ``np.random.default_rng(seed).permutation`` per epoch, whole
    batches only; step t at ``lr / (1 + lr_decay t)`` with bias-corrected
    moments (0.9, 0.999, 1e-8); L2 scaled by the density (the paper lowers
    the penalty for sparser nets, section IV-A). ``on_step(t, loss)`` sees
    each step's loss tensor. Returns (the final parameters by name, test
    accuracy)."""
    x_tr, y_tr, x_te, y_te = data
    dev = model.device
    model.load_params(model.init(seed) if params is None else params)
    l2_eff = l2 * model.density()
    named = list(model.named_parameters())
    opt_m = [torch.zeros_like(p) for _, p in named]
    opt_v = [torch.zeros_like(p) for _, p in named]
    b1, b2, eps = 0.9, 0.999, 1e-8
    xs = torch.as_tensor(x_tr, device=dev)
    ys = torch.as_tensor(y_tr, device=dev)
    n = x_tr.shape[0]
    rng = np.random.default_rng(seed)
    t = 0
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        for s in range(0, n - batch + 1, batch):
            idx = order[s:s + batch]
            model.zero_grad(set_to_none=True)
            loss = model.loss(xs[idx], ys[idx], l2_eff)
            loss.backward()
            if on_step is not None:
                on_step(t, loss.detach())
            lr_t = lr / (1.0 + lr_decay * t)
            c1, c2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
            with torch.no_grad():
                for (_, p), m, v in zip(named, opt_m, opt_v):
                    g = p.grad
                    m.mul_(b1).add_(g, alpha=1.0 - b1)
                    v.mul_(b2).add_(g * g, alpha=1.0 - b2)
                    p.sub_(lr_t * (m / c1) / (torch.sqrt(v / c2) + eps))
            t += 1
    model.zero_grad(set_to_none=True)
    acc = model.accuracy(torch.as_tensor(x_te, device=dev),
                         torch.as_tensor(y_te, device=dev))
    return {k: p.detach().clone() for k, p in named}, acc
