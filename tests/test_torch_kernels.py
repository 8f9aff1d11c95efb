"""The port's kernel modules against the JAX package.

On the CPU each dispatcher runs its plain version; these tests hold that
version to the JAX package's Pallas kernel (interpret mode) and to its XLA
lowering, in f32. The CUDA kernels themselves are compared with the plain
versions by ``tests/test_torch_cuda.py`` (on a card) and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.block_pattern import make_block_pattern
from repro.kernels import csd_spmm as jcsd
from repro.kernels import ops as jops
from repro.kernels.flash_attention import paged_decode_attention as jpaged
from repro_torch.kernels import csd_spmm, flash_attention, ops

TOL_SPMM = 1e-5    # f32: same products, different summation order
TOL_PAGED = 2e-5   # f32 online softmax vs one-shot softmax


def _junction(seed, m, n_in=64, n_out=96, bl=16, br=32, rho=0.5):
    rng = np.random.default_rng(seed)
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br,
                            seed=seed)
    x = rng.normal(size=(m, n_in)).astype(np.float32)
    w = rng.normal(size=(bp.n_rb, bp.d_in_b, bl, br)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32)
    return bp, x, w, b


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_plain_matches_pallas_and_xla(activation, with_bias):
    m = 40  # not a multiple of 128 (the JAX package's default block_m)
    bp, x, w, b = _junction(1, m)
    bias = b if with_bias else None
    got = csd_spmm.csd_spmm_fwd_plain(
        _t(x), _t(w), _t(bp.block_idx),
        bias=None if bias is None else _t(bias), activation=activation)
    pallas = jcsd.csd_spmm_fwd(
        jnp.asarray(x), jnp.asarray(w), bp.block_idx,
        bias=None if bias is None else jnp.asarray(bias),
        activation=activation, block_m=8, interpret=True)
    xla = jops.csd_matmul(
        jnp.asarray(x), jnp.asarray(w), bp,
        bias=None if bias is None else jnp.asarray(bias),
        activation=activation, backend="xla")
    for ref in (pallas, xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=TOL_SPMM, rtol=TOL_SPMM)


def test_csd_matmul_flattens_leading_dims():
    bp, x, w, b = _junction(2, 30)
    x3 = x.reshape(3, 10, -1)
    got = ops.csd_matmul(_t(x3), _t(w), _t(bp.block_idx).int(), bias=_t(b),
                         activation="gelu")
    ref = jops.csd_matmul(jnp.asarray(x3), jnp.asarray(w), bp,
                          bias=jnp.asarray(b), activation="gelu",
                          backend="xla")
    assert got.shape == (3, 10, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=TOL_SPMM, rtol=TOL_SPMM)


def _paged_case(seed=0, b=4, hkv=2, g=3, dh=16, page=4, n_pages=5, total=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, dh)).astype(np.float32)
    k_pages = rng.normal(size=(total, page, hkv, dh)).astype(np.float32)
    v_pages = rng.normal(size=(total, page, hkv, dh)).astype(np.float32)
    # rows of different lengths, one of them empty; unmapped entries are -1
    lengths = np.minimum(np.asarray([3, 11, 0, 17], np.int32)[:b],
                         n_pages * page)
    table = np.full((b, n_pages), -1, np.int32)
    perm = rng.permutation(total - 1)  # page `total-1` plays trash
    k = 0
    for i in range(b):
        for pg in range(-(-int(lengths[i]) // page)):
            table[i, pg] = perm[k]
            k += 1
    return q, k_pages, v_pages, table, lengths


@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 30.0), (6, 30.0)])
def test_paged_decode_plain_matches_pallas_and_xla(window, softcap):
    q, kp, vp, table, lengths = _paged_case()
    got = flash_attention.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(table), _t(lengths), window=window,
        softcap=softcap)
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lengths))
    for kw in (dict(backend="xla"), dict(backend="pallas", interpret=True)):
        ref = jpaged(*args, window=window, softcap=softcap, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=TOL_PAGED, rtol=TOL_PAGED)
    assert (got.numpy()[2] == 0).all()  # the empty row


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: it never runs the plain
    version in its place."""
    bp, x, w, _ = _junction(3, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_fwd_cuda(_t(x), _t(w), _t(bp.block_idx).int())
    q, kp, vp, table, lengths = _paged_case()
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.paged_decode_attention_cuda(
            _t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    assert csd_spmm.csd_spmm_fwd_cuda.launches == 0
    assert flash_attention.paged_decode_attention_cuda.launches == 0
