"""The CUDA kernels against their plain versions, on the card.

These tests carry the ``cuda`` marker and skip where there is no card; they
import neither JAX nor the JAX package, so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.block_pattern import make_block_pattern
from repro_torch.kernels import csd_spmm, flash_attention


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _junction(seed, m, n_in, n_out, bl, br, rho=0.5):
    rng = np.random.default_rng(seed)
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br,
                            seed=seed)
    x = rng.normal(size=(m, n_in)).astype(np.float32)
    w = (rng.normal(size=(bp.n_rb, bp.d_in_b, bl, br))
         / np.sqrt(bp.d_in_b * bl)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32)
    return bp, x, w, b


def _paged_case(seed=0, b=4, hkv=2, g=3, dh=64, page=16, n_pages=13,
                total=40):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, dh)).astype(np.float32)
    k_pages = rng.normal(size=(total, page, hkv, dh)).astype(np.float32)
    v_pages = rng.normal(size=(total, page, hkv, dh)).astype(np.float32)
    # rows of different lengths (one empty, two spanning several 64-key
    # tiles, so the split-and-merge path runs); unmapped entries are -1
    lengths = np.minimum(np.asarray([3, 200, 0, 117], np.int32)[:b],
                         n_pages * page)
    table = np.full((b, n_pages), -1, np.int32)
    perm = rng.permutation(total - 1)
    k = 0
    for i in range(b):
        for pg in range(-(-int(lengths[i]) // page)):
            table[i, pg] = perm[k]
            k += 1
    return q, k_pages, v_pages, table, lengths


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 16, 100])
@pytest.mark.parametrize("activation", [None, "gelu"])
def test_csd_spmm_cuda_matches_plain(cuda_device, activation, m, dtype, tol):
    bp, x, w, b = _junction(4, m, n_in=2048, n_out=1024, bl=256, br=512)
    args = [_t(a).to(cuda_device, dtype) for a in (x, w)]
    idx = _t(bp.block_idx).to(cuda_device).int()
    bias = _t(b).to(cuda_device, dtype)
    got = csd_spmm.csd_spmm_fwd_cuda(*args, idx, bias=bias,
                                     activation=activation)
    ref = csd_spmm.csd_spmm_fwd_plain(*args, idx, bias=bias,
                                      activation=activation)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu(), ref.float().cpu(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, 30.0),
                                            (70, None)])
def test_paged_decode_cuda_matches_plain(cuda_device, window, softcap,
                                         dtype, tol):
    case = _paged_case()
    q, kp, vp = (_t(a).to(cuda_device, dtype) for a in case[:3])
    table, lengths = (_t(a).to(cuda_device) for a in case[3:])
    kw = dict(window=window, softcap=softcap)
    got = flash_attention.paged_decode_attention_cuda(q, kp, vp, table,
                                                      lengths, **kw)
    ref = flash_attention.paged_decode_attention_plain(q, kp, vp, table,
                                                       lengths, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu(), ref.float().cpu(),
                               atol=tol, rtol=tol)
