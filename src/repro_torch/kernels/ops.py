"""The differentiable junction primitive ``csd_matmul`` (port of
``repro.kernels.ops.csd_matmul`` with its custom VJP).

It flattens the leading dims of ``x`` to M and dispatches on the device of
the tensor: a CPU tensor runs the plain slot-wise sweeps, a CUDA tensor the
hand-written kernels, and any other device raises. When a gradient is
needed the call runs through ``CsdMatmul``, a ``torch.autograd.Function``
that wires the paper's three operations as the JAX package's Pallas branch
does (``_fwd_vjp``/``_bwd_vjp``): FF saves ``(x, w, b, aux)``, with aux the
output y for relu and the pre-activation z for gelu (``save_preact``); the
backward folds the activation's derivative into the cotangent once, from
aux, and hands that g to BP, dx over the transpose pattern, and to UP, dw
(and db). A 5-D slab (E, n_rb, d_in_b, bL, bR)
selects the expert-batched form (MoE): x (E, ..., n_in) keeps its leading
expert dim and flattens the rest to M, and FF, BP and UP run the
expert-batched kernels, db (E, n_out). With ``w_scale`` the slab is int8
(``core.quant``) and the call runs the int8 forward, 4-D or 5-D:
inference only, so a gradient request raises, as the JAX package's
quantized junction has no VJP.

Two options of the JAX package's ``csd_matmul`` are kept, without its
tuning or sharding:

* ``dataflow``: ``"gather"`` (each right block gathers its fan-in slots)
  or ``"scatter"`` (each left block pushes its partial products into the
  right blocks it feeds, over the scatter form ``out_idx``/``out_slot``;
  the JAX package's ``_xla_fwd_scatter`` and ``_xla_fwd_scatter_quant``).
  It changes the plain forward only: on the card both run the same
  kernels, as the JAX package's Pallas branch ignores it, and the
  backward is the same in both.
* ``backend``: ``"auto"`` (the kernels, or their plain versions on the
  CPU) or ``"dense"``: the slab densified through a slot map into an
  (n_in, n_out) weight with zeros off the pattern, and one
  ``torch.matmul``, on either device (the JAX package's ``_dense_map`` and
  ``_densify_slab``). It refuses patterns with duplicate (left, right)
  block pairs and int8 slabs; its gradients, through autograd, reach the
  pattern's blocks only. It is plain PyTorch on purpose: the JAX package
  computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import csd_spmm
from .csd_spmm import apply_activation


def _kernels(device: torch.device, batched: bool):
    """(fwd, dx, dw, mask) for tensors on ``device``, in the expert-batched
    form when ``batched`` (the mask is elementwise: one form). Looked up at
    each call, so that a caller can swap them."""
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"csd_matmul: no implementation for {device}")
    impl = "cuda" if device.type == "cuda" else "plain"
    form = "_batched" if batched else ""
    mask = "csd_mask_cotangent_cuda" if impl == "cuda" else "mask_cotangent"
    return tuple(getattr(csd_spmm, f"csd_spmm_{op}{form}_{impl}")
                 for op in ("fwd", "dx", "dw")) + (getattr(csd_spmm, mask),)


def _forward(device: torch.device, batched: bool, dataflow: str,
             out_idx: Optional[torch.Tensor],
             out_slot: Optional[torch.Tensor]):
    """The forward ``fwd(x, w, block_idx, **kw)`` for ``dataflow``: the
    kernels' (or on the CPU their plain versions'), or on the CPU with
    ``"scatter"`` the plain scatter sweep over ``out_idx``/``out_slot``."""
    fwd = _kernels(device, batched)[0]
    if dataflow == "scatter" and device.type == "cpu":
        return lambda x, w, block_idx, **kw: fwd_scatter_plain(
            x, w, out_idx, out_slot, **kw)
    return fwd


def fwd_scatter_plain(x: torch.Tensor, w: torch.Tensor,
                      out_idx: torch.Tensor, out_slot: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None,
                      save_preact: bool = False,
                      w_scale: Optional[torch.Tensor] = None):
    """The forward in the scatter dataflow, slot by slot (the JAX package's
    ``_xla_fwd_scatter``; with ``w_scale`` ``_xla_fwd_scatter_quant``):
    for each fan-out slot g every left block lb multiplies its input block
    by w[out_idx[lb, g], out_slot[lb, g]] (int8: times that block's scale)
    and adds the product into right block out_idx[lb, g]. x (M, n_in) with
    a 4-D slab, or (E, M, n_in) with a 5-D one, the pattern shared by every
    expert; bias, activation, ``save_preact`` and the result as
    ``csd_spmm.csd_spmm_fwd_plain`` / ``_batched_plain``, whose sums it
    equals up to f32 summation order."""
    csd_spmm._check_quant("fwd_scatter_plain", w, w_scale, save_preact)
    one = w.dim() == 4  # one junction: an expert dim of 1
    if one:
        x, w = x[None], w[None]
        bias, w_scale = (None if t is None else t[None]
                         for t in (bias, w_scale))
    e, m = x.shape[:2]
    _, n_rb, _, bl, br = w.shape
    xb = x.reshape(e, m, -1, bl).float()
    oidx = out_idx.to(device=x.device, dtype=torch.long)
    oslot = out_slot.to(device=x.device, dtype=torch.long)
    acc = torch.zeros((e, m, n_rb, br), dtype=torch.float32, device=x.device)
    for g in range(oidx.shape[1]):
        oi, os = oidx[:, g], oslot[:, g]
        part = torch.einsum("emli,elio->emlo", xb, w[:, oi, os].float())
        if w_scale is not None:
            part = part * w_scale[:, oi, os].float()[:, None, :, None]
        acc.index_add_(2, oi, part)
    z = acc.reshape(e, m, n_rb * br)
    if bias is not None:
        z = z + bias.float()[:, None, :]
    y = apply_activation(z, activation).to(x.dtype)
    if one:
        y, z = y[0], z[0]
    return (y, z.to(x.dtype)) if save_preact else y


def _dense_map(block_idx: torch.Tensor, n_lb: int) -> torch.Tensor:
    """The static flat map dense block (lb, rb) -> slab slot, with the
    sentinel n_rb d_in_b (the appended zero block) off the pattern, on the
    device of ``block_idx``. Raises on duplicate (left, right) pairs."""
    idx = block_idx.cpu().numpy().astype(np.int64)
    n_rb, d_in_b = idx.shape
    sentinel = n_rb * d_in_b
    slot_of = np.full((n_lb, n_rb), sentinel, np.int64)
    slot_of[idx.reshape(-1), np.repeat(np.arange(n_rb), d_in_b)] = \
        np.arange(n_rb * d_in_b)
    if int((slot_of != sentinel).sum()) != n_rb * d_in_b:
        raise ValueError(
            "backend='dense' requires distinct (left, right) block pairs "
            "per pattern (duplicate fan-in entry found)")
    return torch.as_tensor(slot_of.reshape(-1), device=block_idx.device)


def densify_slab(w: torch.Tensor, block_idx: torch.Tensor,
                 n_lb: int) -> torch.Tensor:
    """(..., n_rb, d_in_b, bL, bR) slab -> (..., n_lb bL, n_rb bR) dense
    weight with zeros at non-pattern blocks (a gather through
    ``_dense_map``, differentiable: the gradient of a slab block is its
    dense block's)."""
    lead = w.shape[:-4]
    n_rb, d_in_b, bl, br = w.shape[-4:]
    wf = torch.cat([w.reshape(lead + (n_rb * d_in_b, bl, br)),
                    w.new_zeros(lead + (1, bl, br))], dim=-3)
    dense = wf.index_select(-3, _dense_map(block_idx, n_lb))
    dense = dense.reshape(lead + (n_lb, n_rb, bl, br)).transpose(-3, -2)
    return dense.reshape(lead + (n_lb * bl, n_rb * br))


def _dense_matmul(x, w, block_idx, bias, activation):
    """``backend="dense"``: one ``torch.matmul`` against the densified slab
    in x's dtype (per expert for a 5-D slab), bias and activation after."""
    batched = w.dim() == 5
    n_in = x.shape[-1]
    wd = densify_slab(w, block_idx, n_in // w.shape[-2]).to(x.dtype)
    if batched:
        z = torch.matmul(x.reshape(x.shape[0], -1, n_in), wd)
        if bias is not None:
            z = z + bias.to(z.dtype)[:, None, :]
    else:
        z = torch.matmul(x, wd)
        if bias is not None:
            z = z + bias.to(z.dtype)
    y = apply_activation(z, activation)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))


class CsdMatmul(torch.autograd.Function):
    """y = act(x @ W_sparse + b) on 2-D x and a 4-D slab, or on 3-D x and
    a 5-D slab (expert-batched), with FF/BP/UP as the kernels (FF in the
    scatter dataflow on the CPU where asked)."""

    @staticmethod
    def forward(ctx, x, w, bias, block_idx, out_idx, out_slot, activation,
                dataflow="gather"):
        fwd = _forward(x.device, w.dim() == 5, dataflow, out_idx, out_slot)
        if activation == "gelu":
            y, aux = fwd(x, w, block_idx, bias=bias, activation=activation,
                         save_preact=True)
        else:
            y = fwd(x, w, block_idx, bias=bias, activation=activation)
            aux = y if activation == "relu" else None
        ctx.activation = activation
        ctx.save_for_backward(x, w, bias, aux, block_idx, out_idx, out_slot)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, aux, block_idx, out_idx, out_slot = ctx.saved_tensors
        act = ctx.activation
        _, dx_fn, dw_fn, mask_fn = _kernels(x.device, w.dim() == 5)
        # backward traffic stays in the compute dtype, as in the JAX package
        dy = dy.to(x.dtype).contiguous()
        # the activation's derivative, once for both products
        g = mask_fn(dy, aux, act)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = dx_fn(g, w, out_idx, out_slot)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            kw = dict(block_in=w.shape[-2], block_out=w.shape[-1])
            if bias is not None:
                dw, db = dw_fn(x, g, block_idx, want_db=True, **kw)
                db = db.to(bias.dtype)
            else:
                dw = dw_fn(x, g, block_idx, **kw)
            dw = dw.to(w.dtype)
        return dx, dw, db, None, None, None, None, None


def csd_matmul(x: torch.Tensor, w: torch.Tensor, block_idx: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               out_idx: Optional[torch.Tensor] = None,
               out_slot: Optional[torch.Tensor] = None,
               w_scale: Optional[torch.Tensor] = None,
               backend: str = "auto",
               dataflow: str = "gather") -> torch.Tensor:
    """(..., n_in) -> (..., n_out): ``activation(x @ W_sparse + bias)``
    with the epilogue fused, ``w`` the (n_rb, d_in_b, bL, bR) slab and
    ``block_idx`` its (n_rb, d_in_b) int32 pattern on the device of ``x``.
    A gradient also needs the scatter form ``out_idx``/``out_slot``
    (n_lb, d_out_b), int32 on the same device. ``w_scale`` (n_rb, d_in_b)
    f32 selects the int8 forward for an int8 ``w`` (inference only).

    Expert-batched form: ``w`` (E, n_rb, d_in_b, bL, bR) with ``x`` (E,
    ..., n_in), ``bias`` (E, n_out) and ``w_scale`` (E, n_rb, d_in_b) runs
    all E expert junctions over the one shared pattern and returns (E, ...,
    n_out).

    ``backend`` ``"auto"`` or ``"dense"`` and ``dataflow`` ``"gather"`` or
    ``"scatter"`` (which reads ``out_idx``/``out_slot``): see the module
    docstring."""
    if activation is not None and activation not in csd_spmm.ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation!r}")
    if dataflow not in ("gather", "scatter"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if backend not in ("auto", "dense"):
        raise ValueError(f"unknown backend {backend!r}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, bias))
    batched = w.dim() == 5
    if batched and (x.dim() < 2 or x.shape[0] != w.shape[0]):
        raise ValueError(f"csd_matmul: batched junction: x leading dim "
                         f"{tuple(x.shape)} must match the expert count "
                         f"E={w.shape[0]}")
    if backend == "dense":
        if w_scale is not None:
            raise ValueError("backend='dense' supports only the "
                             "plain/batched unquantized junction")
        return _dense_matmul(x, w, block_idx, bias, activation)
    if dataflow == "scatter" and (out_idx is None or out_slot is None):
        raise ValueError("csd_matmul: dataflow='scatter' needs "
                         "out_idx/out_slot")
    if batched:
        xf = x.reshape(x.shape[0], -1, x.shape[-1])
    else:
        xf = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        xf = xf.contiguous()
    fwd = _forward(x.device, batched, dataflow, out_idx, out_slot)
    if w_scale is not None:
        if needs_grad:
            raise ValueError("csd_matmul: the int8 junction (w_scale) is "
                             "inference only and has no gradient")
        y = fwd(xf, w, block_idx, bias=bias, activation=activation,
                w_scale=w_scale)
    elif needs_grad:
        if out_idx is None or out_slot is None:
            raise ValueError("csd_matmul: a gradient needs out_idx/out_slot")
        y = CsdMatmul.apply(xf, w, bias, block_idx, out_idx, out_slot,
                            activation, dataflow)
    else:
        y = fwd(xf, w, block_idx, bias=bias, activation=activation)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))
