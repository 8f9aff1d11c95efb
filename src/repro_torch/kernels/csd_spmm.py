"""CSD-SpMM forward: the pre-defined block-sparse junction (paper eq. (2a)).

``y[m, rb] = act(sum_f x[m, block_idx[rb, f]] @ w[rb, f] + b[rb])`` with the
weight slab ``w`` laid out ``(n_rb, d_in_b, bL, bR)`` (right-block major,
the paper's edge numbering), accumulation in f32 and the output in the
dtype of ``x``.

Two implementations of the one function live here:

* ``csd_spmm_fwd_plain`` — the slot-wise gather sweep (one fan-in slot at
  a time, as ``repro.kernels.ops._xla_fwd``), then bias and activation. It
  is what a CPU tensor runs and what the CUDA kernel is held against.
* ``csd_spmm_fwd_cuda`` — the hand-written Hopper kernel
  ``csrc/csd_spmm_fwd.cu``. It takes CUDA tensors only and raises on
  anything it does not take; it never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

ACTIVATIONS = ("relu", "gelu")
_ACT_CODE = {None: 0, "relu": 1, "gelu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def csd_spmm_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                       block_idx: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None) -> torch.Tensor:
    """x (M, n_in), w (n_rb, d_in_b, bL, bR), block_idx (n_rb, d_in_b)
    integer tensor, bias (n_rb * bR,) or None -> y (M, n_rb * bR)."""
    m = x.shape[0]
    n_rb, d_in_b, bl, br = w.shape
    xb = x.reshape(m, -1, bl)
    idx = block_idx.to(device=x.device, dtype=torch.long)
    acc = torch.zeros((m, n_rb, br), dtype=torch.float32, device=x.device)
    for f in range(d_in_b):
        lhs = xb[:, idx[:, f], :].float()  # (M, n_rb, bL)
        acc += torch.einsum("mri,rio->mro", lhs, w[:, f].float())
    z = acc.reshape(m, n_rb * br)
    if bias is not None:
        z = z + bias.float()
    return apply_activation(z, activation).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_count(m: int, n_out: int, d_in_b: int, n_sm: int) -> int:
    """How many CTAs share one output tile's fan-in slots: 1 when the
    (BM x 64) output tiles alone give about twice as many CTAs as SMs,
    else enough splits to get there, every split owning at least one
    slot (the kernel's BM is 16 for M <= 16, else 64)."""
    tiles = (n_out // 64) * -(-m // (16 if m <= 16 else 64))
    want = -(-2 * n_sm // tiles)
    if want <= 1:
        return 1
    per_split = -(-d_in_b // want)
    return -(-d_in_b // per_split)


def _bind() -> ctypes.CDLL:
    lib = build.load("csd_spmm_fwd")
    fn = lib.csd_spmm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def csd_spmm_fwd_cuda(x: torch.Tensor, w: torch.Tensor,
                      block_idx: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None,
                      save_preact: bool = False) -> torch.Tensor:
    """Launch ``csrc/csd_spmm_fwd.cu`` on the current stream. Same contract
    as ``csd_spmm_fwd_plain``; ``block_idx`` must be an int32 tensor on the
    device of ``x``. Raises on what the kernel does not take."""
    if save_preact:
        raise NotImplementedError(
            "save_preact is a training output; the serving kernel has none")
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {activation!r}")
    tensors = (x, w, block_idx) if bias is None else (x, w, block_idx, bias)
    if not x.is_cuda or any(t.device != x.device for t in tensors) \
            or x.device.index != torch.cuda.current_device():
        raise ValueError("csd_spmm_fwd_cuda: x, w, block_idx and bias must "
                         "be CUDA tensors on the current device")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype \
            or (bias is not None and bias.dtype != x.dtype) \
            or block_idx.dtype != torch.int32:
        raise ValueError("csd_spmm_fwd_cuda: x, w and bias must share one "
                         "dtype of float32/bfloat16, block_idx be int32")
    if x.dim() != 2 or w.dim() != 4:
        raise ValueError("csd_spmm_fwd_cuda: x must be 2-D and w 4-D")
    m, n_in = x.shape
    n_rb, d_in_b, bl, br = w.shape
    if bl % 64 or br % 64 or n_in % bl \
            or tuple(block_idx.shape) != (n_rb, d_in_b) \
            or (bias is not None and tuple(bias.shape) != (n_rb * br,)):
        raise ValueError(
            f"csd_spmm_fwd_cuda: shapes not taken: x {tuple(x.shape)}, "
            f"w {tuple(w.shape)} (bL and bR must be multiples of 64), "
            f"block_idx {tuple(block_idx.shape)}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("csd_spmm_fwd_cuda: tensors must be contiguous and "
                         "16-byte aligned")
    y = torch.empty((m, n_rb * br), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    n_splits = split_count(m, n_rb * br, d_in_b, _sm_count(x.device))
    partial = torch.empty((n_splits, m, n_rb * br), dtype=torch.float32,
                          device=x.device) if n_splits > 1 else None
    rc = _bind()(x.data_ptr(), w.data_ptr(), block_idx.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 m, n_in, n_rb, d_in_b, bl, br, n_splits,
                 _DTYPE_CODE[x.dtype], _ACT_CODE[activation],
                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csd_spmm_fwd launch failed: CUDA error {rc}")
    csd_spmm_fwd_cuda.launches += 1
    return y


csd_spmm_fwd_cuda.launches = 0
