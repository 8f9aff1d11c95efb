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
quantized junction has no VJP. There is no backend option, no tuning and
no sharding.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import csd_spmm
from .csd_spmm import apply_activation  # noqa: F401 — one definition for layers


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


class CsdMatmul(torch.autograd.Function):
    """y = act(x @ W_sparse + b) on 2-D x and a 4-D slab, or on 3-D x and
    a 5-D slab (expert-batched), with FF/BP/UP as the kernels."""

    @staticmethod
    def forward(ctx, x, w, bias, block_idx, out_idx, out_slot, activation):
        fwd = _kernels(x.device, w.dim() == 5)[0]
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
        return dx, dw, db, None, None, None, None


def csd_matmul(x: torch.Tensor, w: torch.Tensor, block_idx: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               out_idx: Optional[torch.Tensor] = None,
               out_slot: Optional[torch.Tensor] = None,
               w_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., n_in) -> (..., n_out): ``activation(x @ W_sparse + bias)``
    with the epilogue fused, ``w`` the (n_rb, d_in_b, bL, bR) slab and
    ``block_idx`` its (n_rb, d_in_b) int32 pattern on the device of ``x``.
    A gradient also needs the scatter form ``out_idx``/``out_slot``
    (n_lb, d_out_b), int32 on the same device. ``w_scale`` (n_rb, d_in_b)
    f32 selects the int8 forward for an int8 ``w`` (inference only).

    Expert-batched form: ``w`` (E, n_rb, d_in_b, bL, bR) with ``x`` (E,
    ..., n_in), ``bias`` (E, n_out) and ``w_scale`` (E, n_rb, d_in_b) runs
    all E expert junctions over the one shared pattern and returns (E, ...,
    n_out)."""
    if activation is not None and activation not in csd_spmm.ACTIVATIONS:
        raise ValueError(f"unsupported fused activation {activation!r}")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, bias))
    batched = w.dim() == 5
    if batched:
        if x.dim() < 2 or x.shape[0] != w.shape[0]:
            raise ValueError(f"csd_matmul: batched junction: x leading dim "
                             f"{tuple(x.shape)} must match the expert count "
                             f"E={w.shape[0]}")
        xf = x.reshape(x.shape[0], -1, x.shape[-1])
    else:
        xf = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        xf = xf.contiguous()
    if w_scale is not None:
        if needs_grad:
            raise ValueError("csd_matmul: the int8 junction (w_scale) is "
                             "inference only and has no gradient")
        y = _kernels(x.device, batched)[0](
            xf, w, block_idx, bias=bias, activation=activation,
            w_scale=w_scale)
    elif needs_grad:
        if out_idx is None or out_slot is None:
            raise ValueError("csd_matmul: a gradient needs out_idx/out_slot")
        y = CsdMatmul.apply(xf, w, bias, block_idx, out_idx, out_slot,
                            activation)
    else:
        y = _kernels(x.device, batched)[0](xf, w, block_idx, bias=bias,
                                           activation=activation)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))
