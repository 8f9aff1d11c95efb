"""CSD-SpMM: the pre-defined block-sparse junction's three operations (paper
eqs. (2a), (3b), (4b)) — port of ``repro.kernels.csd_spmm``.

With the weight slab ``w`` laid out ``(n_rb, d_in_b, bL, bR)`` (right-block
major, the paper's edge numbering) and the pattern's gather form
``block_idx`` (n_rb, d_in_b) and scatter form ``out_idx``/``out_slot``
(n_lb, d_out_b):

* FF  ``y[m, rb] = act(sum_f x[m, block_idx[rb, f]] @ w[rb, f] + b[rb])``,
  with ``save_preact`` also ``z = x @ W + b``;
* BP  ``dx[m, lb] = sum_g mask(dy)[m, out_idx[lb, g]]
  @ w[out_idx[lb, g], out_slot[lb, g]]^T``;
* UP  ``dw[rb, f] = x[m, block_idx[rb, f]]^T @ mask(dy)[m, rb]`` over all m,
  with ``want_db`` also ``db[rb] = sum_m mask(dy)[m, rb]`` in f32;

where ``mask`` (``mask_cotangent``) folds the fused activation's derivative
into the cotangent from the saved ``aux`` (y for relu, z for gelu). The
backward (``ops.CsdMatmul``) masks once and hands the masked cotangent g to
BP and UP without an activation; on the card the mask is its own kernel,
``csrc/csd_mask_cotangent.cu`` (``csd_mask_cotangent_cuda``).
Accumulation is in f32; y, z and dx come out in the dtype of their input,
dw in the dtype of x.

Two implementations of each operation live here:

* ``*_plain`` — slot-wise sweeps (one fan slot at a time, as the JAX
  package's ``_xla_fwd``/``_xla_dx``/``_xla_dw``) in plain PyTorch. They are
  what a CPU tensor runs and what the CUDA kernels are held against.
* ``*_cuda`` — the hand-written Hopper kernels under ``csrc/``. They take
  CUDA tensors only and raise on anything they do not take; they never fall
  back to the plain version. The full-width forward has two bodies, the
  persistent ``wgmma`` body (bf16 at the training and most prefill
  shapes) and the grid body, which ``launch.fwd_tile_n`` chooses between.
  Each counts its launches in
  ``.launches``, builds its launch plan (``launch.fwd_plan``,
  ``dx_plan``, ``dw_plan``, ``mask_plan``: split count, grid, shared
  memory, what each CTA reads and writes) and
  launches through ``launch.run``, the hook sparselint captures plans
  through.

Blocks whose bL or bR is not a multiple of 64 (the paper MLP's 16 x 4,
4 x 4, 1 x 2 and 2 x 1, the smoke configurations' 16 x 16) are below the
64-wide tiles of those bodies: ``launch.small_block`` sends them to the
small-block forms of ``csrc/csd_spmm_small.cu`` (the forward and dx)
and ``csrc/csd_spmm_small_dw.cu`` (dw) (CUDA cores, f32 accumulation, any
block shape, 4-D and expert-batched),
``csd_spmm_fwd_small_cuda``, ``csd_spmm_dx_small_cuda`` and
``csd_spmm_dw_small_cuda``, which the wrappers above call and which count
their own launches. The int8 forward's small-block form is the gather
kernel over an int8 slab (``csd_spmm_fwd_quant_small_cuda``, 4-D and
expert-batched), which the int8 wrappers below call for those blocks.

The forward also has an int8 form for serving (``w_scale``): the slab is
int8 with one f32 scale per (bL x bR) block (``core.quant``), each slot's
partial sum is scaled before it is accumulated, and no gradient exists.
Its kernel is ``csrc/csd_spmm_fwd_quant.cu`` (``csd_spmm_fwd_quant_cuda``,
which ``csd_spmm_fwd_cuda`` calls when given ``w_scale``), with three
bodies that ``launch.quant_body`` chooses between: in bf16 the
weight-streaming body for a few rows per expert (every decode call; one
launch, the fan-in split over a thread-block cluster) and the wgmma body
over int8 tiles for more; in f32 the grid body. Blocks that
``launch.small_block`` sends to the small-block forms run the gather
kernel's int8 form (``csd_spmm_fwd_quant_small_cuda``) instead.

And the forward has an expert-batched form for MoE (the JAX package's
``_csd_spmm_fwd_batched`` and ``_csd_spmm_fwd_quant_batched``): x (E, M,
n_in) against E slabs (E, n_rb, d_in_b, bL, bR) of one shared pattern,
bias (E, n_rb * bR), scales (E, n_rb, d_in_b) in the int8 form. Its
kernels are the same two sources with the expert index in the grid
(``csd_spmm_fwd_batched_cuda``, ``csd_spmm_fwd_quant_batched_cuda``). The
backward operations have the same expert-batched form for MoE training
(the JAX package's ``csd_spmm_dx``/``csd_spmm_dw`` on 5-D/3-D operands):
dy and aux (E, M, n_out), x (E, M, n_in), dx (E, M, n_in), dw (E, n_rb,
d_in_b, bL, bR), db (E, n_out), each expert summed over its own rows
(``csd_spmm_dx_batched_cuda``, ``csd_spmm_dw_batched_cuda``, with the
expert index in the grids of ``csrc/csd_spmm_dx.cu`` and
``csrc/csd_spmm_dw.cu``). Each single-junction plain version is its
batched form with one expert.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import build, launch

ACTIVATIONS = ("relu", "gelu")
_ACT_CODE = {None: 0, "relu": 1, "gelu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715


def apply_activation(z: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """Every fusable activation; "gelu" is the tanh approximation, the
    function the model's activation registry binds to gelu and gelu_tanh."""
    if activation is None:
        return z
    if activation == "relu":
        return torch.relu(z)
    if activation == "gelu":
        return F.gelu(z, approximate="tanh")
    raise ValueError(f"unsupported fused activation {activation!r}")


def mask_cotangent(dy: torch.Tensor, aux: Optional[torch.Tensor],
                   activation: Optional[str]) -> torch.Tensor:
    """Fold the fused activation's derivative into the cotangent: relu's
    mask is the sign of the saved output y, gelu's derivative is the
    analytic one of the tanh approximation at the saved pre-activation z,
    computed in f32. The result has the dtype of ``dy``."""
    if activation is None:
        return dy
    if activation == "relu":
        return dy * (aux > 0).to(dy.dtype)
    if activation == "gelu":
        z = aux.float()
        t = torch.tanh(_GELU_C * (z + _GELU_A * z * z * z))
        g = 0.5 * (1.0 + t) \
            + 0.5 * z * (1.0 - t * t) * _GELU_C * (1.0 + 3.0 * _GELU_A * z * z)
        return (dy.float() * g).to(dy.dtype)
    raise ValueError(f"unsupported fused activation {activation!r}")


def _check_quant(name: str, w: torch.Tensor,
                 w_scale: Optional[torch.Tensor], save_preact: bool) -> None:
    """The int8 forward's contract: inference only, an int8 slab."""
    if w_scale is None:
        if w.dtype == torch.int8:
            raise ValueError(f"{name}: an int8 slab needs its w_scale")
        return
    if save_preact:
        raise ValueError(f"{name}: save_preact is unsupported on the "
                         f"quantized path (inference only; training stays "
                         f"full width)")
    if w.dtype != torch.int8:
        raise ValueError(f"{name}: w_scale given but w.dtype={w.dtype}, "
                         f"expected int8")
    if tuple(w_scale.shape) != tuple(w.shape[:-2]):
        raise ValueError(f"{name}: w_scale {tuple(w_scale.shape)} must be "
                         f"{tuple(w.shape[:-2])}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _opt(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` with a leading expert dim of 1, or None."""
    return None if t is None else t[None]


def csd_spmm_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                       block_idx: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None,
                       save_preact: bool = False,
                       w_scale: Optional[torch.Tensor] = None):
    """x (M, n_in), w (n_rb, d_in_b, bL, bR), block_idx (n_rb, d_in_b)
    integer tensor, bias (n_rb * bR,) or None -> y (M, n_rb * bR), or
    (y, z) with ``save_preact``.

    ``w_scale`` (n_rb, d_in_b) f32 selects the int8 forward (inference
    only): ``w`` is int8, each slot's f32 partial sum of x @ q is
    multiplied by its block's scale before it is accumulated, as the JAX
    package's Pallas kernel ``_fwd_kernel_quant`` does. The expert-batched
    form with one expert."""
    _check_quant("csd_spmm_fwd", w, w_scale, save_preact)
    out = csd_spmm_fwd_batched_plain(
        x[None], w[None], block_idx, bias=_opt(bias), activation=activation,
        save_preact=save_preact, w_scale=_opt(w_scale))
    return (out[0][0], out[1][0]) if save_preact else out[0]


def csd_spmm_fwd_batched_plain(x: torch.Tensor, w: torch.Tensor,
                               block_idx: torch.Tensor, *,
                               bias: Optional[torch.Tensor] = None,
                               activation: Optional[str] = None,
                               save_preact: bool = False,
                               w_scale: Optional[torch.Tensor] = None):
    """The expert-batched forward: x (E, M, n_in), w (E, n_rb, d_in_b, bL,
    bR), block_idx (n_rb, d_in_b) shared by every expert, bias (E, n_rb *
    bR) or None -> y (E, M, n_rb * bR), or (y, z) with ``save_preact``,
    expert e computed as ``csd_spmm_fwd_plain(x[e], w[e], block_idx,
    bias=bias[e], ...)`` (the JAX package's ``_xla_fwd_batched``).
    ``w_scale`` (E, n_rb, d_in_b) f32 selects the int8 form
    (``_xla_fwd_quant_batched``)."""
    _check_quant("csd_spmm_fwd_batched", w, w_scale, save_preact)
    e, m = x.shape[:2]
    _, n_rb, d_in_b, bl, br = w.shape
    xb = x.reshape(e, m, -1, bl)
    idx = block_idx.to(device=x.device, dtype=torch.long)
    acc = torch.zeros((e, m, n_rb, br), dtype=torch.float32, device=x.device)
    for f in range(d_in_b):
        lhs = xb[:, :, idx[:, f], :].float()  # (E, M, n_rb, bL)
        part = torch.einsum("emri,erio->emro", lhs, w[:, :, f].float())
        if w_scale is not None:
            part = part * w_scale[:, :, f].float()[:, None, :, None]
        acc += part
    z = acc.reshape(e, m, n_rb * br)
    if bias is not None:
        z = z + bias.float()[:, None, :]
    y = apply_activation(z, activation).to(x.dtype)
    return (y, z.to(x.dtype)) if save_preact else y


def csd_spmm_dx_plain(dy: torch.Tensor, w: torch.Tensor,
                      out_idx: torch.Tensor, out_slot: torch.Tensor, *,
                      aux: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None) -> torch.Tensor:
    """dy (M, n_rb * bR), w (n_rb, d_in_b, bL, bR), out_idx/out_slot
    (n_lb, d_out_b) integer tensors, aux like dy when ``activation`` is
    given -> dx (M, n_lb * bL) in the dtype of dy. The expert-batched form
    with one expert."""
    return csd_spmm_dx_batched_plain(dy[None], w[None], out_idx, out_slot,
                                     aux=_opt(aux), activation=activation)[0]


def csd_spmm_dx_batched_plain(dy: torch.Tensor, w: torch.Tensor,
                              out_idx: torch.Tensor, out_slot: torch.Tensor,
                              *, aux: Optional[torch.Tensor] = None,
                              activation: Optional[str] = None
                              ) -> torch.Tensor:
    """The expert-batched backward-data: dy (E, M, n_rb * bR), w (E, n_rb,
    d_in_b, bL, bR), out_idx/out_slot (n_lb, d_out_b) shared by every
    expert, aux like dy when ``activation`` is given -> dx (E, M, n_lb *
    bL) in the dtype of dy, expert e computed as ``csd_spmm_dx_plain(dy[e],
    w[e], ...)`` (the JAX package's ``_xla_dx_batched``)."""
    e, m = dy.shape[:2]
    _, n_rb, _, bl, br = w.shape
    n_lb, d_out_b = out_idx.shape
    dyb = mask_cotangent(dy, aux, activation).reshape(e, m, n_rb, br)
    oidx = out_idx.to(device=dy.device, dtype=torch.long)
    oslot = out_slot.to(device=dy.device, dtype=torch.long)
    acc = torch.zeros((e, m, n_lb, bl), dtype=torch.float32, device=dy.device)
    for g in range(d_out_b):
        lhs = dyb[:, :, oidx[:, g], :].float()           # (E, M, n_lb, bR)
        w_g = w[:, oidx[:, g], oslot[:, g]].float()       # (E, n_lb, bL, bR)
        acc += torch.einsum("emlo,elio->emli", lhs, w_g)
    return acc.reshape(e, m, n_lb * bl).to(dy.dtype)


def csd_spmm_dw_plain(x: torch.Tensor, dy: torch.Tensor,
                      block_idx: torch.Tensor, *, block_in: int,
                      block_out: int, aux: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None,
                      want_db: bool = False):
    """x (M, n_in), dy (M, n_rb * bR) -> dw (n_rb, d_in_b, bL, bR) in the
    dtype of x, summed over M; with ``want_db`` returns (dw, db), db the f32
    column sum of the masked cotangent, (n_rb * bR,). The expert-batched
    form with one expert."""
    out = csd_spmm_dw_batched_plain(
        x[None], dy[None], block_idx, block_in=block_in, block_out=block_out,
        aux=_opt(aux), activation=activation, want_db=want_db)
    return (out[0][0], out[1][0]) if want_db else out[0]


def csd_spmm_dw_batched_plain(x: torch.Tensor, dy: torch.Tensor,
                              block_idx: torch.Tensor, *, block_in: int,
                              block_out: int,
                              aux: Optional[torch.Tensor] = None,
                              activation: Optional[str] = None,
                              want_db: bool = False):
    """The expert-batched backward-weights: x (E, M, n_in), dy (E, M, n_rb
    * bR) -> dw (E, n_rb, d_in_b, bL, bR) in the dtype of x, each expert
    summed over its own M rows (the JAX package's ``_xla_dw_batched``);
    with ``want_db`` returns (dw, db), db (E, n_rb * bR) f32."""
    e, m = x.shape[:2]
    n_rb, d_in_b = block_idx.shape
    dym = mask_cotangent(dy, aux, activation)
    xb = x.reshape(e, m, -1, block_in).float()
    dyb = dym.reshape(e, m, n_rb, block_out).float()
    idx = block_idx.to(device=x.device, dtype=torch.long)
    dw = torch.stack([torch.einsum("emri,emro->erio", xb[:, :, idx[:, f], :],
                                   dyb)
                      for f in range(d_in_b)], dim=2).to(x.dtype)
    if want_db:
        return dw, dym.float().sum(dim=1)
    return dw


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _bind(name: str, n_ptrs: int, n_ints: int, fn_name: str = ""):
    """The C entry point ``fn_name`` (default: ``name``) of the library of
    ``csrc/<name>.cu``, typed as n_ptrs pointers, n_ints ints and the
    stream."""
    fn = getattr(build.load(name), fn_name or name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_dtypes(name: str, floats, ints) -> None:
    """Float tensors of one dtype among float32/bfloat16; int32 pattern
    tensors."""
    dt = floats[0].dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt for t in floats) \
            or any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{name}: float operands must share one dtype of "
                         f"float32/bfloat16 and pattern tensors be int32")


def _check_act(name: str, activation, aux, like) -> None:
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {activation!r}")
    if activation is not None and (aux is None or aux.shape != like.shape):
        raise ValueError(f"{name}: activation {activation!r} needs aux of "
                         f"shape {tuple(like.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_fwd_shapes(name: str, x, w, block_idx, bias,
                      batched: bool, grid_body: bool = True) -> tuple:
    """(E, M, n_in, n_rb, d_in_b, bL, bR) of a launch of the full-width
    forward bodies (``csd_spmm_fwd.cu``, ``csd_spmm_fwd_quant.cu``): x (M,
    n_in) with w (n_rb, d_in_b, bL, bR) and bias (n_rb * bR,) as E = 1, or
    with ``batched`` x (E, M, n_in), w (E, n_rb, d_in_b, bL, bR) and bias
    (E, n_rb * bR). ``grid_body``: the launch runs ``csd_spmm_fwd.cuh``'s
    grid body, whose row tiles of all experts fill gridDim.y (at most
    65535). bL and bR must be multiples of 64: ``_launch_fwd`` and
    ``_launch_fwd_quant`` send other blocks to the small-block forms before
    this check."""
    if (x.dim(), w.dim()) != ((3, 5) if batched else (2, 4)):
        raise ValueError(f"{name}: x must be {3 if batched else 2}-D and w "
                         f"{5 if batched else 4}-D")
    e, m, n_in = x.shape if batched else (1,) + tuple(x.shape)
    n_rb, d_in_b, bl, br = w.shape[-4:]
    bias_shape = (e, n_rb * br) if batched else (n_rb * br,)
    if bl % 64 or br % 64 or n_in % bl \
            or (batched and w.shape[0] != e) \
            or tuple(block_idx.shape) != (n_rb, d_in_b) \
            or (bias is not None and tuple(bias.shape) != bias_shape) \
            or (grid_body and e * -(-m // launch.block_m(m)) > 65535):
        raise ValueError(
            f"{name}: shapes not taken: x {tuple(x.shape)}, "
            f"w {tuple(w.shape)} (bL and bR must be multiples of 64), "
            f"block_idx {tuple(block_idx.shape)}")
    return e, m, n_in, n_rb, d_in_b, bl, br


def _partial(plan, x, e: int, m: int, n_out: int):
    """The f32 partial-sum scratch of a split forward launch, or None."""
    if plan.n_splits == 1:
        return None
    return torch.empty((plan.n_splits, e * m, n_out), dtype=torch.float32,
                       device=x.device)


def _launch_fwd(name: str, x, w, block_idx, bias, activation, save_preact,
                batched: bool, n_splits: Optional[int] = None):
    """Check and launch ``csrc/csd_spmm_fwd.cu`` through its plan; (y, z or
    None, whether that kernel was launched). Blocks that
    ``launch.small_block`` sends to the small-block form run
    ``csd_spmm_fwd_small_cuda`` instead, which counts its own launch.
    ``n_splits`` forces the grid body's split count (a test's comparison;
    the wrappers leave it to the plan)."""
    if w.dim() >= 4 and launch.small_block(*w.shape[-2:]):
        if n_splits not in (None, 1):
            raise ValueError(f"{name}: the small-block form does not split "
                             f"the fan-in over launches")
        out = csd_spmm_fwd_small_cuda(x, w, block_idx, bias=bias,
                                      activation=activation,
                                      save_preact=save_preact,
                                      batched=batched)
        return (out if save_preact else (out, None)) + (False,)
    floats = (x, w) if bias is None else (x, w, bias)
    launch.check_device(name, floats + (block_idx,))
    _check_dtypes(name, floats, (block_idx,))
    e, m, n_in, n_rb, d_in_b, bl, br = _check_fwd_shapes(
        name, x, w, block_idx, bias, batched, grid_body=False)
    y = torch.empty(x.shape[:-1] + (n_rb * br,), dtype=x.dtype,
                    device=x.device)
    z = torch.empty_like(y) if save_preact else None
    if y.numel() == 0:
        return y, z, False
    n_sm = launch.sm_count(x.device)
    plan = launch.fwd_plan(
        e, m, n_in, n_rb, d_in_b, bl, br, _dtype(x), has_bias=bias is not None,
        save_preact=save_preact, quant=False, n_sm=n_sm,
        n_splits=n_splits).with_patterns(block_idx=block_idx)
    if plan.launches[0].kernel == "csd_spmm_fwd_kernel":
        _check_fwd_shapes(name, x, w, block_idx, bias, batched)
    partial = _partial(plan, x, e, m, n_rb * br)
    launch.run(plan, dict(x=x, w=w, block_idx=block_idx, bias=bias, y=y, z=z,
                          partial=partial),
               lambda: _bind("csd_spmm_fwd", 7, 12)(
                   x.data_ptr(), w.data_ptr(), block_idx.data_ptr(),
                   _ptr(bias), y.data_ptr(), _ptr(z), _ptr(partial),
                   e, m, n_in, n_rb, d_in_b, bl, br, plan.n_splits, n_sm,
                   plan.args["tile_n"], _DTYPE_CODE[x.dtype],
                   _ACT_CODE[activation], _stream()))
    return y, z, True


def _launch_fwd_quant(name: str, x, w, w_scale, block_idx, bias, activation,
                      batched: bool):
    """Check and launch ``csrc/csd_spmm_fwd_quant.cu`` through its plan;
    (y, whether that kernel was launched). Blocks that
    ``launch.small_block`` sends to the small-block form run
    ``csd_spmm_fwd_quant_small_cuda`` instead, which counts its own
    launch."""
    if w.dim() >= 4 and launch.small_block(*w.shape[-2:]):
        return csd_spmm_fwd_quant_small_cuda(
            x, w, w_scale, block_idx, bias=bias, activation=activation,
            batched=batched), False
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {activation!r}")
    _check_quant(name, w, w_scale, False)
    floats = (x,) if bias is None else (x, bias)
    launch.check_device(name, floats + (w, w_scale, block_idx))
    _check_dtypes(name, floats, (block_idx,))
    if w_scale.dtype != torch.float32:
        raise ValueError(f"{name}: w_scale must be float32")
    e, m, n_in, n_rb, d_in_b, bl, br = _check_fwd_shapes(
        name, x, w, block_idx, bias, batched, grid_body=False)
    y = torch.empty(x.shape[:-1] + (n_rb * br,), dtype=x.dtype,
                    device=x.device)
    if y.numel() == 0:
        return y, False
    n_sm = launch.sm_count(x.device)
    plan = launch.fwd_plan(
        e, m, n_in, n_rb, d_in_b, bl, br, _dtype(x), has_bias=bias is not None,
        save_preact=False, quant=True,
        n_sm=n_sm).with_patterns(block_idx=block_idx)
    if plan.args["body"] == launch.BODY_GRID:
        _check_fwd_shapes(name, x, w, block_idx, bias, batched)
    partial = _partial(plan, x, e, m, n_rb * br)
    a = plan.args
    launch.run(plan, dict(x=x, w=w, w_scale=w_scale, block_idx=block_idx,
                          bias=bias, y=y, partial=partial),
               lambda: _bind("csd_spmm_fwd_quant", 7, 15)(
                   x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
                   block_idx.data_ptr(), _ptr(bias), y.data_ptr(),
                   _ptr(partial), e, m, n_in, n_rb, d_in_b, bl, br,
                   plan.n_splits, n_sm, a["body"], a["tile_m"], a["tile_n"],
                   a["cluster"], _DTYPE_CODE[x.dtype], _ACT_CODE[activation],
                   _stream()))
    return y, True


def csd_spmm_fwd_cuda(x: torch.Tensor, w: torch.Tensor,
                      block_idx: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None,
                      save_preact: bool = False,
                      w_scale: Optional[torch.Tensor] = None):
    """Launch ``csrc/csd_spmm_fwd.cu`` on the current stream. Same contract
    as ``csd_spmm_fwd_plain``; ``block_idx`` must be an int32 tensor on the
    device of ``x``. With ``w_scale`` the int8 kernel runs instead
    (``csd_spmm_fwd_quant_cuda``). Raises on what the kernel does not
    take."""
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {activation!r}")
    _check_quant("csd_spmm_fwd_cuda", w, w_scale, save_preact)
    if w_scale is not None:
        return csd_spmm_fwd_quant_cuda(x, w, w_scale, block_idx, bias=bias,
                                       activation=activation)
    y, z, launched = _launch_fwd("csd_spmm_fwd_cuda", x, w, block_idx, bias,
                                 activation, save_preact, batched=False)
    if launched:
        csd_spmm_fwd_cuda.launches += 1
    return (y, z) if save_preact else y


def csd_spmm_fwd_quant_cuda(x: torch.Tensor, w: torch.Tensor,
                            w_scale: torch.Tensor, block_idx: torch.Tensor,
                            *, bias: Optional[torch.Tensor] = None,
                            activation: Optional[str] = None) -> torch.Tensor:
    """Launch ``csrc/csd_spmm_fwd_quant.cu`` on the current stream: the
    int8 forward, inference only. x (M, n_in) f32/bf16, w int8 (n_rb,
    d_in_b, bL, bR), w_scale f32 (n_rb, d_in_b), bias like x or None,
    block_idx int32, all on the device of x -> y (M, n_rb * bR) like x
    (blocks below 64: ``csd_spmm_fwd_quant_small_cuda``). Raises on what
    the kernel does not take."""
    y, launched = _launch_fwd_quant("csd_spmm_fwd_quant_cuda", x, w, w_scale,
                                    block_idx, bias, activation,
                                    batched=False)
    if launched:
        csd_spmm_fwd_quant_cuda.launches += 1
    return y


def csd_spmm_fwd_batched_cuda(x: torch.Tensor, w: torch.Tensor,
                              block_idx: torch.Tensor, *,
                              bias: Optional[torch.Tensor] = None,
                              activation: Optional[str] = None,
                              save_preact: bool = False,
                              w_scale: Optional[torch.Tensor] = None):
    """Launch ``csrc/csd_spmm_fwd.cu`` over E experts on the current stream.
    Same contract as ``csd_spmm_fwd_batched_plain``: x (E, M, n_in), w (E,
    n_rb, d_in_b, bL, bR), bias (E, n_rb * bR) or None, block_idx int32
    (n_rb, d_in_b), all on the device of x; (y, z) with ``save_preact``.
    With ``w_scale`` the int8 kernel runs instead
    (``csd_spmm_fwd_quant_batched_cuda``). Raises on what the kernel does
    not take."""
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {activation!r}")
    _check_quant("csd_spmm_fwd_batched_cuda", w, w_scale, save_preact)
    if w_scale is not None:
        return csd_spmm_fwd_quant_batched_cuda(
            x, w, w_scale, block_idx, bias=bias, activation=activation)
    y, z, launched = _launch_fwd("csd_spmm_fwd_batched_cuda", x, w,
                                 block_idx, bias, activation, save_preact,
                                 batched=True)
    if launched:
        csd_spmm_fwd_batched_cuda.launches += 1
    return (y, z) if save_preact else y


def csd_spmm_fwd_quant_batched_cuda(x: torch.Tensor, w: torch.Tensor,
                                    w_scale: torch.Tensor,
                                    block_idx: torch.Tensor, *,
                                    bias: Optional[torch.Tensor] = None,
                                    activation: Optional[str] = None
                                    ) -> torch.Tensor:
    """Launch ``csrc/csd_spmm_fwd_quant.cu`` over E experts on the current
    stream: the int8 expert-batched forward, inference only. x (E, M, n_in)
    f32/bf16, w int8 (E, n_rb, d_in_b, bL, bR), w_scale f32 (E, n_rb,
    d_in_b), bias (E, n_rb * bR) like x or None, block_idx int32 -> y (E,
    M, n_rb * bR) like x. Raises on what the kernel does not take."""
    y, launched = _launch_fwd_quant("csd_spmm_fwd_quant_batched_cuda", x, w,
                                    w_scale, block_idx, bias, activation,
                                    batched=True)
    if launched:
        csd_spmm_fwd_quant_batched_cuda.launches += 1
    return y


def csd_spmm_fwd_small_cuda(x: torch.Tensor, w: torch.Tensor,
                            block_idx: torch.Tensor, *,
                            bias: Optional[torch.Tensor] = None,
                            activation: Optional[str] = None,
                            save_preact: bool = False,
                            batched: Optional[bool] = None):
    """Launch the small-block forward of ``csrc/csd_spmm_small.cu`` on the
    current stream: the form ``csd_spmm_fwd_cuda`` and
    ``csd_spmm_fwd_batched_cuda`` run for blocks whose bL or bR is not a
    multiple of 64 (``launch.small_block``); it takes any block shape.
    Same contract as ``csd_spmm_fwd_plain`` (4-D w) or
    ``csd_spmm_fwd_batched_plain`` (5-D w, or ``batched``). Raises on what
    the kernel does not take."""
    name = "csd_spmm_fwd_small_cuda"
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {activation!r}")
    if batched is None:
        batched = w.dim() == 5
    floats = (x, w) if bias is None else (x, w, bias)
    launch.check_device(name, floats + (block_idx,))
    _check_dtypes(name, floats, (block_idx,))
    e, m, n_in, n_rb, d_in_b, bl, br = _check_small_fwd_shapes(
        name, x, w, block_idx, bias, batched)
    y = torch.empty(x.shape[:-1] + (n_rb * br,), dtype=x.dtype,
                    device=x.device)
    z = torch.empty_like(y) if save_preact else None
    if y.numel() > 0:
        plan = launch.fwd_small_plan(
            e, m, n_in, n_rb, d_in_b, bl, br, _dtype(x),
            has_bias=bias is not None, save_preact=save_preact,
            n_sm=launch.sm_count(x.device)) \
            .with_patterns(block_idx=block_idx)
        launch.run(plan, dict(x=x, w=w, block_idx=block_idx, bias=bias, y=y,
                              z=z),
                   lambda: _bind("csd_spmm_small", 6, 14,
                                 "csd_spmm_small_fwd")(
                       x.data_ptr(), w.data_ptr(), block_idx.data_ptr(),
                       _ptr(bias), y.data_ptr(), _ptr(z), e, m, n_in, n_rb,
                       d_in_b, bl, br, _DTYPE_CODE[x.dtype],
                       _ACT_CODE[activation], *_gather_args(plan),
                       _stream()))
        csd_spmm_fwd_small_cuda.launches += 1
    return (y, z) if save_preact else y


def _check_small_fwd_shapes(name: str, x, w, block_idx, bias,
                            batched: bool) -> tuple:
    """(E, M, n_in, n_rb, d_in_b, bL, bR) of a small-block forward launch
    (``csd_spmm_fwd_small_cuda``, ``csd_spmm_fwd_quant_small_cuda``): any
    block shape, 8 rows of x within the gather kernel's shared memory."""
    _rank(name, batched, (x, 2), (w, 4))
    e, m, n_in = x.shape if batched else (1,) + tuple(x.shape)
    n_rb, d_in_b, bl, br = w.shape[-4:]
    if n_in % bl or (batched and w.shape[0] != e) \
            or tuple(block_idx.shape) != (n_rb, d_in_b) \
            or (bias is not None
                and tuple(bias.shape) != x.shape[:-2] + (n_rb * br,)) \
            or e > 65535 or not launch.small_gather_fits(
                n_in, bl, x.element_size()):
        raise ValueError(
            f"{name}: shapes not taken: x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}, block_idx {tuple(block_idx.shape)} "
            f"(8 rows of x must fit the kernel's shared memory)")
    _check_slab_size(name, w, batched)
    return e, m, n_in, n_rb, d_in_b, bl, br


def csd_spmm_fwd_quant_small_cuda(x: torch.Tensor, w: torch.Tensor,
                                  w_scale: torch.Tensor,
                                  block_idx: torch.Tensor, *,
                                  bias: Optional[torch.Tensor] = None,
                                  activation: Optional[str] = None,
                                  batched: Optional[bool] = None
                                  ) -> torch.Tensor:
    """Launch the int8 small-block forward of ``csrc/csd_spmm_small.cu`` on
    the current stream: the form ``csd_spmm_fwd_quant_cuda`` and
    ``csd_spmm_fwd_quant_batched_cuda`` run for blocks whose bL or bR is
    not a multiple of 64 (``launch.small_block``); it takes any block
    shape. Same contract as ``csd_spmm_fwd_plain`` (4-D w) or
    ``csd_spmm_fwd_batched_plain`` (5-D w, or ``batched``) with
    ``w_scale``: w int8, w_scale f32 like w's leading dims, x and bias
    f32/bf16, block_idx int32, all on the device of x. Raises on what the
    kernel does not take."""
    name = "csd_spmm_fwd_quant_small_cuda"
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {activation!r}")
    if batched is None:
        batched = w.dim() == 5
    _check_quant(name, w, w_scale, False)
    floats = (x,) if bias is None else (x, bias)
    launch.check_device(name, floats + (w, w_scale, block_idx))
    _check_dtypes(name, floats, (block_idx,))
    if w_scale.dtype != torch.float32:
        raise ValueError(f"{name}: w_scale must be float32")
    e, m, n_in, n_rb, d_in_b, bl, br = _check_small_fwd_shapes(
        name, x, w, block_idx, bias, batched)
    y = torch.empty(x.shape[:-1] + (n_rb * br,), dtype=x.dtype,
                    device=x.device)
    if y.numel() > 0:
        plan = launch.fwd_small_plan(
            e, m, n_in, n_rb, d_in_b, bl, br, _dtype(x),
            has_bias=bias is not None, save_preact=False,
            n_sm=launch.sm_count(x.device), quant=True) \
            .with_patterns(block_idx=block_idx)
        launch.run(plan, dict(x=x, w=w, w_scale=w_scale, block_idx=block_idx,
                              bias=bias, y=y),
                   lambda: _bind("csd_spmm_small", 6, 14,
                                 "csd_spmm_small_fwd_quant")(
                       x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
                       block_idx.data_ptr(), _ptr(bias), y.data_ptr(), e, m,
                       n_in, n_rb, d_in_b, bl, br, _DTYPE_CODE[x.dtype],
                       _ACT_CODE[activation], *_gather_args(plan),
                       _stream()))
        csd_spmm_fwd_quant_small_cuda.launches += 1
    return y


def csd_mask_cotangent_cuda(dy: torch.Tensor, aux: Optional[torch.Tensor],
                            activation: Optional[str]) -> torch.Tensor:
    """Launch ``csrc/csd_mask_cotangent.cu`` on the current stream. Same
    contract as ``mask_cotangent``: dy and aux of one shape and dtype on the
    card -> g like dy; with no activation, dy itself and no launch."""
    name = "csd_mask_cotangent_cuda"
    if activation is None:
        return dy
    _check_act(name, activation, aux, dy)
    launch.check_device(name, (dy, aux))
    _check_dtypes(name, (dy, aux), ())
    if dy.dim() < 1:
        raise ValueError(f"{name}: shapes not taken: dy {tuple(dy.shape)}")
    g = torch.empty_like(dy)
    if g.numel() == 0:
        return g
    n_out = dy.shape[-1]
    rows = dy.numel() // n_out
    plan = launch.mask_plan(rows, n_out, _dtype(dy))
    launch.run(plan, dict(dy=dy, aux=aux, g=g),
               lambda: _bind("csd_mask_cotangent", 3, 4)(
                   dy.data_ptr(), aux.data_ptr(), g.data_ptr(), rows, n_out,
                   _DTYPE_CODE[dy.dtype], _ACT_CODE[activation], _stream()))
    csd_mask_cotangent_cuda.launches += 1
    return g


def _launch_dx(name: str, dy, w, out_idx, out_slot, aux, activation,
               batched: bool):
    """Check and launch ``csrc/csd_spmm_dx.cu`` through its plan, after the
    mask kernel when ``activation`` is given; (dx, whether the dx kernel was
    launched). dy (M, n_out) with w (n_rb, d_in_b, bL, bR) as E = 1, or
    with ``batched`` dy (E, M, n_out) and w (E, n_rb, d_in_b, bL, bR).
    Blocks that ``launch.small_block`` sends to the small-block form run
    ``csd_spmm_dx_small_cuda`` instead, which counts its own launch."""
    if w.dim() >= 4 and launch.small_block(*w.shape[-2:]):
        return csd_spmm_dx_small_cuda(dy, w, out_idx, out_slot, aux=aux,
                                      activation=activation,
                                      batched=batched), False
    _check_act(name, activation, aux, dy)
    floats = (dy, w)
    launch.check_device(name, floats + (out_idx, out_slot))
    _check_dtypes(name, floats, (out_idx, out_slot))
    if (dy.dim(), w.dim()) != ((3, 5) if batched else (2, 4)):
        raise ValueError(f"{name}: dy must be {3 if batched else 2}-D and w "
                         f"{5 if batched else 4}-D")
    e, m, n_out = dy.shape if batched else (1,) + tuple(dy.shape)
    n_rb, d_in_b, bl, br = w.shape[-4:]
    n_lb, d_out_b = out_idx.shape
    if bl % 64 or br % 64 or n_out != n_rb * br \
            or (batched and w.shape[0] != e) \
            or tuple(out_slot.shape) != (n_lb, d_out_b) \
            or n_lb * d_out_b != n_rb * d_in_b or e > 65535 \
            or -(-m // 64) > 65535:
        raise ValueError(
            f"{name}: shapes not taken: dy {tuple(dy.shape)}, "
            f"w {tuple(w.shape)} (bL and bR must be multiples of 64), "
            f"out_idx {tuple(out_idx.shape)}")
    dx = torch.empty(dy.shape[:-1] + (n_lb * bl,), dtype=dy.dtype,
                     device=dy.device)
    if dx.numel() == 0:
        return dx, False
    g = csd_mask_cotangent_cuda(dy, aux, activation)
    plan = launch.dx_plan(e, m, n_rb, d_in_b, bl, br, n_lb, d_out_b,
                          _dtype(dy), n_sm=launch.sm_count(dy.device)) \
        .with_patterns(out_idx=out_idx, out_slot=out_slot)
    launch.run(plan, dict(g=g, w=w, out_idx=out_idx, out_slot=out_slot,
                          dx=dx),
               lambda: _bind("csd_spmm_dx", 5, 10)(
                   g.data_ptr(), w.data_ptr(), out_idx.data_ptr(),
                   out_slot.data_ptr(), dx.data_ptr(), e, m, n_rb, d_in_b,
                   bl, br, n_lb, d_out_b, _DTYPE_CODE[dy.dtype],
                   plan.args["n_ctas"], _stream()))
    return dx, True


def _launch_dw(name: str, x, dy, block_idx, bl: int, br: int, aux,
               activation, want_db: bool, batched: bool):
    """Check and launch ``csrc/csd_spmm_dw.cu`` through its plan, after the
    mask kernel when ``activation`` is given; (dw, db or None, whether the
    dw kernel was launched). x (M, n_in) and dy (M, n_out) as E = 1, or
    with ``batched`` x (E, M, n_in) and dy (E, M, n_out). Blocks that
    ``launch.small_block`` sends to the small-block form run
    ``csd_spmm_dw_small_cuda`` instead, which counts its own launch."""
    if launch.small_block(bl, br):
        out = csd_spmm_dw_small_cuda(x, dy, block_idx, block_in=bl,
                                     block_out=br, aux=aux,
                                     activation=activation, want_db=want_db,
                                     batched=batched)
        return (out if want_db else (out, None)) + (False,)
    _check_act(name, activation, aux, dy)
    floats = (x, dy)
    launch.check_device(name, floats + (block_idx,))
    _check_dtypes(name, floats, (block_idx,))
    rank = 3 if batched else 2
    if x.dim() != rank or dy.dim() != rank or block_idx.dim() != 2:
        raise ValueError(f"{name}: x and dy must be {rank}-D and block_idx "
                         f"2-D")
    e, m, n_in = x.shape if batched else (1,) + tuple(x.shape)
    n_rb, d_in_b = block_idx.shape
    if bl % 64 or br % 64 or n_in % bl \
            or tuple(dy.shape) != x.shape[:-1] + (n_rb * br,) \
            or e * n_rb * d_in_b > 65535:
        raise ValueError(
            f"{name}: shapes not taken: x {tuple(x.shape)}, "
            f"dy {tuple(dy.shape)}, block ({bl}, {br}) (bL and bR must be "
            f"multiples of 64)")
    lead = (e,) if batched else ()
    dw = torch.empty(lead + (n_rb, d_in_b, bl, br), dtype=x.dtype,
                     device=x.device)
    db = torch.empty(lead + (n_rb * br,), dtype=torch.float32,
                     device=x.device) if want_db else None
    if m == 0 or e == 0:
        dw.zero_()
        if db is not None:
            db.zero_()
        return dw, db, False
    g = csd_mask_cotangent_cuda(dy, aux, activation)
    plan = launch.dw_plan(e, m, n_in, n_rb, d_in_b, bl, br, _dtype(x),
                          want_db=want_db) \
        .with_patterns(block_idx=block_idx)
    launch.run(plan, dict(x=x, g=g, block_idx=block_idx, dw=dw, db=db),
               lambda: _bind("csd_spmm_dw", 5, 8)(
                   x.data_ptr(), g.data_ptr(), block_idx.data_ptr(),
                   dw.data_ptr(), _ptr(db), e, m, n_in, n_rb, d_in_b, bl, br,
                   _DTYPE_CODE[x.dtype], _stream()))
    return dw, db, True


def _check_slab_size(name: str, w, batched: bool) -> None:
    """The small-block forward and dx index an expert's slab with 32-bit
    offsets."""
    per_expert = w.numel() // max(w.shape[0], 1) if batched else w.numel()
    if per_expert >= 2 ** 31:
        raise ValueError(f"{name}: shapes not taken: an expert's slab "
                         f"{tuple(w.shape[-4:])} holds 2^31 elements or "
                         f"more")


def _gather_args(plan) -> tuple:
    """The gather kernel's geometry from its plan, in the C entry points'
    order."""
    return tuple(plan.args[k] for k in ("R", "ncg", "ks", "stages", "Y"))


def _rank(name: str, batched: bool, *pairs) -> None:
    """Every (tensor, rank of the 4-D form) pair has that rank, one more
    when ``batched``."""
    if any(t.dim() != r + batched for t, r in pairs):
        raise ValueError(f"{name}: operands of ranks "
                         f"{[t.dim() for t, _ in pairs]}, expected "
                         f"{[r + batched for _, r in pairs]}")


def csd_spmm_dx_small_cuda(dy: torch.Tensor, w: torch.Tensor,
                           out_idx: torch.Tensor, out_slot: torch.Tensor, *,
                           aux: Optional[torch.Tensor] = None,
                           activation: Optional[str] = None,
                           batched: Optional[bool] = None) -> torch.Tensor:
    """Launch the small-block dx of ``csrc/csd_spmm_small.cu`` on the
    current stream, after ``csd_mask_cotangent_cuda`` when ``activation``
    is given: the form ``csd_spmm_dx_cuda`` and
    ``csd_spmm_dx_batched_cuda`` run for blocks whose bL or bR is not a
    multiple of 64; it takes any block shape. Same contract as
    ``csd_spmm_dx_plain`` (4-D w) or ``csd_spmm_dx_batched_plain`` (5-D
    w, or ``batched``)."""
    name = "csd_spmm_dx_small_cuda"
    if batched is None:
        batched = w.dim() == 5
    _check_act(name, activation, aux, dy)
    launch.check_device(name, (dy, w, out_idx, out_slot))
    _check_dtypes(name, (dy, w), (out_idx, out_slot))
    _rank(name, batched, (dy, 2), (w, 4))
    e, m, n_out = dy.shape if batched else (1,) + tuple(dy.shape)
    n_rb, d_in_b, bl, br = w.shape[-4:]
    n_lb, d_out_b = out_idx.shape
    if n_out != n_rb * br or (batched and w.shape[0] != e) \
            or tuple(out_slot.shape) != (n_lb, d_out_b) \
            or n_lb * d_out_b != n_rb * d_in_b or e > 65535 \
            or not launch.small_gather_fits(n_out, br, dy.element_size()):
        raise ValueError(
            f"{name}: shapes not taken: dy {tuple(dy.shape)}, "
            f"w {tuple(w.shape)}, out_idx {tuple(out_idx.shape)} (8 rows "
            f"of dy must fit the kernel's shared memory)")
    _check_slab_size(name, w, batched)
    dx = torch.empty(dy.shape[:-1] + (n_lb * bl,), dtype=dy.dtype,
                     device=dy.device)
    if dx.numel() == 0:
        return dx
    g = csd_mask_cotangent_cuda(dy, aux, activation)
    plan = launch.dx_small_plan(e, m, n_rb, d_in_b, bl, br, n_lb, d_out_b,
                                _dtype(dy), n_sm=launch.sm_count(dy.device)) \
        .with_patterns(out_idx=out_idx, out_slot=out_slot)
    launch.run(plan, dict(g=g, w=w, out_idx=out_idx, out_slot=out_slot,
                          dx=dx),
               lambda: _bind("csd_spmm_small", 5, 14, "csd_spmm_small_dx")(
                   g.data_ptr(), w.data_ptr(), out_idx.data_ptr(),
                   out_slot.data_ptr(), dx.data_ptr(), e, m, n_rb, d_in_b,
                   bl, br, n_lb, d_out_b, _DTYPE_CODE[dy.dtype],
                   *_gather_args(plan), _stream()))
    csd_spmm_dx_small_cuda.launches += 1
    return dx


def csd_spmm_dw_small_cuda(x: torch.Tensor, dy: torch.Tensor,
                           block_idx: torch.Tensor, *, block_in: int,
                           block_out: int, aux: Optional[torch.Tensor] = None,
                           activation: Optional[str] = None,
                           want_db: bool = False,
                           batched: Optional[bool] = None):
    """Launch the small-block dw (and db) of ``csrc/csd_spmm_small_dw.cu`` on
    the current stream, after ``csd_mask_cotangent_cuda`` when
    ``activation`` is given: the form ``csd_spmm_dw_cuda`` and
    ``csd_spmm_dw_batched_cuda`` run for blocks whose bL or bR is not a
    multiple of 64; it takes any block shape. Same contract as
    ``csd_spmm_dw_plain`` (2-D x) or ``csd_spmm_dw_batched_plain`` (3-D x,
    or ``batched``)."""
    name = "csd_spmm_dw_small_cuda"
    if batched is None:
        batched = x.dim() == 3
    bl, br = block_in, block_out
    _check_act(name, activation, aux, dy)
    launch.check_device(name, (x, dy, block_idx))
    _check_dtypes(name, (x, dy), (block_idx,))
    _rank(name, batched, (x, 2), (dy, 2))
    if block_idx.dim() != 2:
        raise ValueError(f"{name}: block_idx must be 2-D")
    e, m, n_in = x.shape if batched else (1,) + tuple(x.shape)
    n_rb, d_in_b = block_idx.shape
    if n_in % bl or tuple(dy.shape) != x.shape[:-1] + (n_rb * br,) \
            or e > 65535 or n_in // bl > 65535 \
            or not launch.small_dw_fits(bl, br, x.element_size()):
        raise ValueError(
            f"{name}: shapes not taken: x {tuple(x.shape)}, "
            f"dy {tuple(dy.shape)}, block ({bl}, {br})")
    lead = (e,) if batched else ()
    dw = torch.empty(lead + (n_rb, d_in_b, bl, br), dtype=x.dtype,
                     device=x.device)
    db = torch.empty(lead + (n_rb * br,), dtype=torch.float32,
                     device=x.device) if want_db else None
    if m == 0 or dw.numel() == 0:
        dw.zero_()
        if db is not None:
            db.zero_()
        return (dw, db) if want_db else dw
    g = csd_mask_cotangent_cuda(dy, aux, activation)
    plan = launch.dw_small_plan(e, m, n_in, n_rb, d_in_b, bl, br, _dtype(x),
                                want_db=want_db,
                                n_sm=launch.sm_count(x.device)) \
        .with_patterns(block_idx=block_idx)
    launch.run(plan, dict(x=x, g=g, block_idx=block_idx, dw=dw, db=db),
               lambda: _bind("csd_spmm_small_dw", 5, 9)(
                   x.data_ptr(), g.data_ptr(), block_idx.data_ptr(),
                   dw.data_ptr(), _ptr(db), e, m, n_in, n_rb, d_in_b, bl, br,
                   _DTYPE_CODE[x.dtype], plan.args["cluster"], _stream()))
    csd_spmm_dw_small_cuda.launches += 1
    return (dw, db) if want_db else dw


def csd_spmm_dx_cuda(dy: torch.Tensor, w: torch.Tensor,
                     out_idx: torch.Tensor, out_slot: torch.Tensor, *,
                     aux: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None) -> torch.Tensor:
    """Launch ``csrc/csd_spmm_dx.cu`` on the current stream, after
    ``csd_mask_cotangent_cuda`` when ``activation`` is given. Same contract
    as ``csd_spmm_dx_plain``; out_idx/out_slot int32 on the device of dy."""
    dx, launched = _launch_dx("csd_spmm_dx_cuda", dy, w, out_idx, out_slot,
                              aux, activation, batched=False)
    if launched:
        csd_spmm_dx_cuda.launches += 1
    return dx


def csd_spmm_dx_batched_cuda(dy: torch.Tensor, w: torch.Tensor,
                             out_idx: torch.Tensor, out_slot: torch.Tensor,
                             *, aux: Optional[torch.Tensor] = None,
                             activation: Optional[str] = None
                             ) -> torch.Tensor:
    """Launch ``csrc/csd_spmm_dx.cu`` over E experts on the current stream,
    after ``csd_mask_cotangent_cuda`` when ``activation`` is given. Same
    contract as ``csd_spmm_dx_batched_plain``; out_idx/out_slot int32 on the
    device of dy."""
    dx, launched = _launch_dx("csd_spmm_dx_batched_cuda", dy, w, out_idx,
                              out_slot, aux, activation, batched=True)
    if launched:
        csd_spmm_dx_batched_cuda.launches += 1
    return dx


def csd_spmm_dw_cuda(x: torch.Tensor, dy: torch.Tensor,
                     block_idx: torch.Tensor, *, block_in: int,
                     block_out: int, aux: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None,
                     want_db: bool = False):
    """Launch ``csrc/csd_spmm_dw.cu`` on the current stream, after
    ``csd_mask_cotangent_cuda`` when ``activation`` is given. Same contract
    as ``csd_spmm_dw_plain``; block_idx int32 on the device of x."""
    dw, db, launched = _launch_dw("csd_spmm_dw_cuda", x, dy, block_idx,
                                  block_in, block_out, aux, activation,
                                  want_db, batched=False)
    if launched:
        csd_spmm_dw_cuda.launches += 1
    return (dw, db) if want_db else dw


def csd_spmm_dw_batched_cuda(x: torch.Tensor, dy: torch.Tensor,
                             block_idx: torch.Tensor, *, block_in: int,
                             block_out: int,
                             aux: Optional[torch.Tensor] = None,
                             activation: Optional[str] = None,
                             want_db: bool = False):
    """Launch ``csrc/csd_spmm_dw.cu`` over E experts on the current stream,
    after ``csd_mask_cotangent_cuda`` when ``activation`` is given. Same
    contract as ``csd_spmm_dw_batched_plain``; block_idx int32 on the
    device of x."""
    dw, db, launched = _launch_dw("csd_spmm_dw_batched_cuda", x, dy,
                                  block_idx, block_in, block_out, aux,
                                  activation, want_db, batched=True)
    if launched:
        csd_spmm_dw_batched_cuda.launches += 1
    return (dw, db) if want_db else dw


csd_spmm_fwd_cuda.launches = 0
csd_spmm_fwd_quant_cuda.launches = 0
csd_spmm_fwd_batched_cuda.launches = 0
csd_spmm_fwd_quant_batched_cuda.launches = 0
csd_spmm_dx_cuda.launches = 0
csd_spmm_dx_batched_cuda.launches = 0
csd_spmm_dw_cuda.launches = 0
csd_spmm_dw_batched_cuda.launches = 0
csd_mask_cotangent_cuda.launches = 0
csd_spmm_fwd_small_cuda.launches = 0
csd_spmm_fwd_quant_small_cuda.launches = 0
csd_spmm_dx_small_cuda.launches = 0
csd_spmm_dw_small_cuda.launches = 0
