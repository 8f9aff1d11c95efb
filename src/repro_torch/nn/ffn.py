"""FFN and Mixture-of-Experts blocks (port of ``repro.nn.ffn``): the
junctions where the paper's pre-defined sparsity attaches.
``rho_ffn = (rho_up, rho_down)`` follows the paper's trend 3 (later
junctions denser).

``MoE`` ports the JAX package's local (single-device) dispatch: sorted-run
buffers of capacity C per expert, the expert FFN batched over all experts
at once, and a combine that sums each token's weighted expert rows in a
fixed order. With ``SparsityConfig.moe_sparsity`` every expert junction is
a block-sparse slab (E, n_rb, d_in_b, bL, bR) over one pattern shared by
all experts, run through the expert-batched ``csd_matmul`` in the forward
and in both backward operations. Gradients reach the router (through the
gates and the aux values), the expert slabs and the input. The
expert-parallel (shard_map / all-to-all) dispatch waits for the
multi-device slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..core.block_pattern import fit_block_pattern
from ..kernels.ops import apply_activation, csd_matmul
from .common import ModelConfig, param_dtype_of
from .layers import Linear, _normal, activation

# activation names the fused csd_matmul epilogue understands (the registry
# binds gelu and gelu_tanh to the same tanh-approximate function)
_FUSABLE = {"relu": "relu", "gelu": "gelu", "gelu_tanh": "gelu"}


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``n`` ids occurs (``bincount`` with ``minlength``
    and no larger id), without a host sync on any device: ``bincount``
    reads its output size back from the card, and ``one_hot`` checks its
    ids' range with ``.item()`` on the CPU (sparselint's SL201)."""
    return (ids[:, None] == torch.arange(n, device=ids.device)).sum(dim=0)


def _tokens_to_cells(x: torch.Tensor, buf_tok: torch.Tensor) -> torch.Tensor:
    """x (T, d) -> (E, C, d): each expert buffer cell's token row, zeros in
    the padding cells (token index T)."""
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
    return xp[buf_tok]


def _cells_to_tokens(cells: torch.Tensor, addr: torch.Tensor,
                     kept: torch.Tensor) -> torch.Tensor:
    """cells (E, C, d) -> (T, d): each token's kept cells (flat cells
    ``addr`` (T, k), in increasing expert order) summed in that order."""
    rows = cells.reshape(-1, cells.shape[-1])[torch.where(kept, addr, 0)]
    return torch.where(kept[..., None], rows, 0.0).sum(dim=1)


class _Dispatch(torch.autograd.Function):
    """x (T, d) -> (E, C, d), the gather into the expert buffers. Its
    backward sums each token's cells in a fixed order (``_cells_to_tokens``)
    instead of scatter-adding them: PyTorch's index backward adds
    duplicate indices one run at a time, and the padding row alone
    collects thousands of cells."""

    @staticmethod
    def forward(ctx, x, buf_tok, addr, kept):
        ctx.save_for_backward(addr, kept)
        return _tokens_to_cells(x, buf_tok)

    @staticmethod
    def backward(ctx, grad):
        addr, kept = ctx.saved_tensors
        return _cells_to_tokens(grad, addr, kept), None, None, None


class _Combine(torch.autograd.Function):
    """(E, C, d) -> (T, d), the fixed-order sum of each token's cells; its
    backward is the gather of ``_Dispatch``'s forward (each kept cell
    belongs to one token, a padding cell to none), so neither direction
    scatters."""

    @staticmethod
    def forward(ctx, cells, buf_tok, addr, kept):
        ctx.save_for_backward(buf_tok)
        return _cells_to_tokens(cells, addr, kept)

    @staticmethod
    def backward(ctx, grad):
        buf_tok, = ctx.saved_tensors
        return _tokens_to_cells(grad, buf_tok), None, None, None


class FFN(nn.Module):
    """(Gated) feed-forward junction pair, optionally pre-defined sparse.
    The junction seeds are the JAX package's (+11 up, +12 gate, +13 down):
    the seed picks each junction's sparsity pattern. ``d_in`` is the input
    width (d_model by default); the output is d_model wide."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None,
                 d_ff: Optional[int] = None, d_in: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        sp = cfg.sparsity
        rho_up, rho_down = sp.rho_ffn if sp.enabled else (1.0, 1.0)
        kw = dict(sp=sp, dtype=param_dtype_of(cfg), device=device,
                  generator=generator)
        d, d_ff = d_in or cfg.d_model, d_ff or cfg.d_ff
        self.up = Linear(d, d_ff, rho=rho_up, seed=seed + 11, **kw)
        self.gate = Linear(d, d_ff, rho=rho_up, seed=seed + 12, **kw) \
            if cfg.ffn_gated else None
        self.down = Linear(d_ff, cfg.d_model, rho=rho_down, seed=seed + 13,
                           **kw)
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


class MoE(nn.Module):
    """Routed experts (+ optional always-on shared experts).

    Parameters: ``router`` (d, E) and the stacked expert weights ``up``,
    ``gate`` (E, d -> d_e) and ``down`` (E, d_e -> d), each a slab (E, n_rb,
    d_in_b, bL, bR) when its junction has a pattern (its gather form in the
    int32 buffer ``<name>_idx`` and its scatter form, for the backward
    pass, in ``<name>_out_idx``/``<name>_out_slot``; seeds +31 up, +32
    gate, +33 down) and dense (E, n_in, n_out) otherwise.
    ``core.quant.quantize_model`` makes the slabs int8 with f32 scales
    ``<name>_scale`` (E, n_rb, d_in_b). A dtype cast of the module leaves
    the router and the scales in their dtype: routing runs in f32 from the
    f32 router, as in the JAX package, and rounding the scales would change
    every block's values."""

    _KEEP_DTYPE = ("router", "up_scale", "gate_scale", "down_scale")

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.moe is None:
            raise ValueError("MoE needs cfg.moe")
        self.cfg = cfg
        self.mc = mc = cfg.moe
        d, d_e, n_exp = cfg.d_model, mc.d_expert, mc.n_routed
        pd = param_dtype_of(cfg)
        sp = cfg.sparsity
        pats = (None, None, None)
        if sp.enabled and sp.moe_sparsity:
            rho_up, rho_down = sp.rho_ffn
            pats = (fit_block_pattern(d, d_e, rho_up, sp, seed=seed + 31),
                    fit_block_pattern(d, d_e, rho_up, sp, seed=seed + 32),
                    fit_block_pattern(d_e, d, rho_down, sp, seed=seed + 33))
        self.up_pat, self.gate_pat, self.down_pat = pats
        self.router = _normal((d, n_exp), math.sqrt(1.0 / d), generator,
                              device, pd)
        for name, pat, n_in, n_out in (("up", pats[0], d, d_e),
                                       ("gate", pats[1], d, d_e),
                                       ("down", pats[2], d_e, d)):
            if pat is not None:
                shape = (n_exp, pat.n_rb, pat.d_in_b, pat.block_in,
                         pat.block_out)
                std = math.sqrt(1.0 / (pat.d_in_b * pat.block_in))
            else:
                shape, std = (n_exp, n_in, n_out), math.sqrt(1.0 / n_in)
            setattr(self, name, _normal(shape, std, generator, device, pd))
            for buf, field in (("idx", "block_idx"), ("out_idx", "out_idx"),
                               ("out_slot", "out_slot")):
                self.register_buffer(f"{name}_{buf}", None if pat is None
                                     else torch.as_tensor(
                                         getattr(pat, field),
                                         dtype=torch.int32, device=device))
            self.register_buffer(f"{name}_scale", None)
        self.shared = FFN(cfg, seed=seed + 29, device=device,
                          generator=generator, d_ff=mc.n_shared * d_e) \
            if mc.n_shared else None
        self.act = activation(cfg.act)

    def _apply(self, fn, recurse=True):
        saved = {}
        for name in self._KEEP_DTYPE:
            t = getattr(self, name)
            if t is not None:
                saved[name] = t.data if isinstance(t, nn.Parameter) else t
        out = super()._apply(fn, recurse)
        for name, old in saved.items():
            new = getattr(self, name)
            if new.dtype != old.dtype:
                if isinstance(new, nn.Parameter):
                    new.data = old.to(new.device)
                else:
                    setattr(self, name, old.to(new.device))
        return out

    def capacity(self, t_local: int) -> int:
        mc = self.mc
        return max(math.ceil(t_local * mc.top_k / mc.n_routed
                             * mc.capacity_factor), 1)

    # -- routing -------------------------------------------------------------

    def _route(self, x2d: torch.Tensor):
        """x2d (T, d) -> gates (T, k) f32, expert ids (T, k), aux values
        (the Switch load-balance loss and the router z-loss)."""
        mc = self.mc
        logits = x2d.float() @ self.router.float()         # (T, E)
        probs = torch.softmax(logits, dim=-1)
        gates, ids = torch.topk(probs, mc.top_k, dim=-1)
        gates = gates / gates.sum(dim=-1, keepdim=True)
        # ce: the fraction of tokens whose top-1 lands on each expert
        ce = _counts(ids[:, 0], mc.n_routed).float() / ids.shape[0]
        me = probs.mean(dim=0)
        lb = mc.n_routed * torch.sum(me * ce)
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        return gates, ids, {"moe_lb": lb, "moe_z": mc.router_zloss * z}

    # -- local sort-based dispatch and combine -------------------------------

    def _dispatch_local(self, gates: torch.Tensor, ids: torch.Tensor,
                        capacity: int):
        """The (E, C) token-index and gate buffers of the JAX package's
        ``_dispatch_local``: after a stable sort by expert id, expert e's
        assignments are sorted rows [starts[e], starts[e] + counts[e]), and
        cell (e, c) takes row starts[e] + c; cells past an expert's count
        hold the padding row T with gate 0, and assignments past C are
        dropped. Also returns each assignment's flat cell e * C + c and
        whether it was kept, (T, k), each token's k in increasing expert
        order (the order in which ``jax.ops.segment_sum`` visits them)."""
        mc = self.mc
        t, k = ids.shape
        n_exp, cap = mc.n_routed, capacity
        flat_ids = ids.reshape(-1)
        order = torch.argsort(flat_ids, stable=True)
        stok = torch.div(order, k, rounding_mode="floor")
        sgate = gates.reshape(-1)[order]
        counts = _counts(flat_ids, n_exp)
        starts = torch.cumsum(counts, 0) - counts
        cells = torch.arange(cap, device=ids.device)
        gidx = torch.clamp(starts[:, None] + cells[None], 0, t * k - 1)
        valid = cells[None] < counts[:, None]
        buf_tok = torch.where(valid, stok[gidx], t)
        buf_gate = torch.where(valid, sgate[gidx], 0.0)
        # the sorted position of every assignment (order's inverse)
        pos = torch.empty_like(order).scatter_(
            0, order, torch.arange(t * k, device=ids.device))
        cell = pos - starts[flat_ids]
        by_expert = torch.argsort(ids, dim=1)
        addr = torch.gather((flat_ids * cap + cell).reshape(t, k), 1,
                            by_expert)
        kept = torch.gather((cell < cap).reshape(t, k), 1, by_expert)
        return buf_tok, buf_gate, addr, kept

    def _junction(self, xe: torch.Tensor, name: str,
                  act: Optional[str] = None) -> torch.Tensor:
        """One stacked expert junction: the expert-batched csd_matmul when
        it has a pattern (an int8 slab with its scales), a stacked einsum
        when it is dense."""
        w = getattr(self, name)
        idx = getattr(self, f"{name}_idx")
        if idx is None:
            y = torch.einsum("ecd,edf->ecf", xe, w.to(xe.dtype))
            return apply_activation(y, act)
        if w.dtype == torch.int8:
            scale = getattr(self, f"{name}_scale")
            if scale is None:
                raise ValueError(f"an int8 expert slab needs its "
                                 f"{name}_scale")
            return csd_matmul(xe, w, idx, activation=act, w_scale=scale)
        return csd_matmul(xe, w.to(xe.dtype), idx, activation=act,
                          out_idx=getattr(self, f"{name}_out_idx"),
                          out_slot=getattr(self, f"{name}_out_slot"))

    def _expert_ffn(self, xe: torch.Tensor) -> torch.Tensor:
        """xe (E, C, d) -> (E, C, d), all experts at once; a fusable
        activation rides the gate junction's epilogue, any other (silu)
        runs after it."""
        fused = _FUSABLE.get(self.cfg.act) if self.gate_pat is not None \
            else None
        h = self._junction(xe, "up")
        g = self._junction(xe, "gate", fused)
        if fused is None:
            g = self.act(g)
        return self._junction(g * h, "down")

    def _moe_local(self, x2d: torch.Tensor, capacity: int):
        """Route, dispatch, run the experts and combine. The combine
        weights the expert rows by their gates (cast to the rows' dtype
        first, as the JAX package does) and gives each token the sum of its
        kept rows in a fixed order: dispatch and combine are gathers in
        both directions, with no scatter-add, so neither the result nor
        its gradient depends on scheduling."""
        gates, ids, aux = self._route(x2d)
        buf_tok, buf_gate, addr, kept = self._dispatch_local(gates, ids,
                                                             capacity)
        ye = self._expert_ffn(_Dispatch.apply(x2d, buf_tok, addr, kept))
        yw = ye * buf_gate[..., None].to(ye.dtype)           # (E, C, d)
        return _Combine.apply(yw, buf_tok, addr, kept), aux

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B, S, d) -> (y (B, S, d), {"moe_lb", "moe_z"})."""
        b, s, d = x.shape
        y2d, aux = self._moe_local(x.reshape(b * s, d), self.capacity(b * s))
        y = y2d.reshape(b, s, d)
        if self.shared is not None:
            y = y + self.shared(x)
        return y.to(x.dtype), aux
