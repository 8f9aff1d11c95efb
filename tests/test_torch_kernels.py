"""The port's kernel modules against the JAX package.

On the CPU each dispatcher runs its plain version; these tests hold that
version to the JAX package's Pallas kernel (interpret mode) and to its XLA
lowering, in f32 (and for the backward kernels also in bf16), and the
autograd ``csd_matmul`` to ``jax.vjp`` of the JAX junction. The CUDA
kernels themselves are compared with the plain versions by
``tests/test_torch_cuda.py`` (on a card) and ``chip_smoke.py``.
"""
import jax
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
# backward kernels, max |port - JAX| over max |JAX|: f32 sums in another
# order; bf16 one rounding of each output plus the XLA form's bf16 running
# sum over the (at most 4) fan slots
TOL_BWD = {"float32": 1e-5, "bfloat16": 2e-2}


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


# ---------------------------------------------------------------------------
# the training operations: mask, backward-data, backward-weights, autograd
# ---------------------------------------------------------------------------

DTYPES = ["float32", "bfloat16"]


def _bwd_case(seed, m, dtype):
    """A junction of 8 left blocks with fan-in 4 and fan-out 2, its
    cotangent and aux, in ``dtype`` as arrays for JAX and tensors for the
    port."""
    bp, x, w, _ = _junction(seed, m, n_in=128, n_out=128)
    rng = np.random.default_rng(seed + 100)
    dy = rng.normal(size=(m, bp.n_out)).astype(np.float32)
    aux = rng.normal(size=(m, bp.n_out)).astype(np.float32)
    arrs = [jnp.asarray(a, dtype) for a in (x, w, dy, aux)]
    tens = [_t(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
            for a in arrs]
    return bp, arrs, tens


def _close_rel(got, ref, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_mask_cotangent_matches_reference(activation, dtype):
    _, (_, _, dy, aux), (_, _, tdy, taux) = _bwd_case(5, 24, dtype)
    got = csd_spmm.mask_cotangent(tdy, taux, activation)
    ref = jcsd.mask_cotangent(dy, aux, activation)
    assert got.dtype == tdy.dtype
    # bf16: the f32 products round to bf16 the same way, one ulp at a tie
    _close_rel(got, ref, 1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_dx_plain_matches_pallas_and_xla(activation, dtype):
    bp, (_, w, dy, aux), (_, tw, tdy, taux) = _bwd_case(6, 40, dtype)
    assert bp.out_idx.shape[1] > 1  # several slots per left block
    got = csd_spmm.csd_spmm_dx_plain(tdy, tw, _t(bp.out_idx),
                                     _t(bp.out_slot), aux=taux,
                                     activation=activation)
    pallas = jcsd.csd_spmm_dx(dy, w, bp.out_idx, bp.out_slot, aux=aux,
                              activation=activation, block_m=8,
                              interpret=True)
    xla = jops._xla_dx(jops._mask_dy_xla(dy, aux, activation), w,
                       bp.out_idx, bp.out_slot)
    assert got.dtype == tdy.dtype and got.shape == (40, bp.n_in)
    for ref in (pallas, xla):
        _close_rel(got, ref, TOL_BWD[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("want_db", [False, True], ids=["nodb", "db"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_dw_plain_matches_pallas_and_xla(activation, want_db,
                                                  dtype):
    bp, (x, _, dy, aux), (tx, _, tdy, taux) = _bwd_case(7, 40, dtype)
    kw = dict(block_in=bp.block_in, block_out=bp.block_out,
              activation=activation, want_db=want_db)
    got = csd_spmm.csd_spmm_dw_plain(tx, tdy, _t(bp.block_idx), aux=taux,
                                     **kw)
    pallas = jcsd.csd_spmm_dw(x, dy, bp.block_idx, aux=aux, block_m=8,
                              interpret=True, **kw)
    mdy = jops._mask_dy_xla(dy, aux, activation)
    xla = jops._xla_dw(x, mdy, bp.block_idx, bp.block_in, bp.block_out)
    if want_db:
        (got, db), (pallas, pallas_db) = got, pallas
        assert db.dtype == torch.float32
        for ref in (pallas_db, jnp.sum(mdy.astype(jnp.float32), axis=0)):
            _close_rel(db, ref, TOL_BWD["float32"])
    assert got.dtype == tx.dtype
    for ref in (pallas, xla):
        _close_rel(got, ref, TOL_BWD[dtype])


@pytest.mark.parametrize("activation", [None, "gelu"])
def test_csd_spmm_fwd_plain_save_preact_matches_pallas(activation):
    bp, x, w, b = _junction(8, 24)
    y, z = csd_spmm.csd_spmm_fwd_plain(
        _t(x), _t(w), _t(bp.block_idx), bias=_t(b), activation=activation,
        save_preact=True)
    ry, rz = jcsd.csd_spmm_fwd(
        jnp.asarray(x), jnp.asarray(w), bp.block_idx, bias=jnp.asarray(b),
        activation=activation, save_preact=True, block_m=8, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=TOL_SPMM,
                               rtol=TOL_SPMM)
    np.testing.assert_allclose(z.numpy(), np.asarray(rz), atol=TOL_SPMM,
                               rtol=TOL_SPMM)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_matmul_gradients_match_jax_vjp(activation, with_bias, backend):
    m = 24
    bp, x, w, b = _junction(9, m)
    dy = np.random.default_rng(10).normal(size=(2, m // 2, bp.n_out)) \
        .astype(np.float32)
    x3 = x.reshape(2, m // 2, -1)
    kw = dict(activation=activation, backend=backend)
    if backend == "pallas":
        kw.update(interpret=True, block_m=8)

    def jfn(x_, w_, b_):
        return jops.csd_matmul(x_, w_, bp, bias=b_ if with_bias else None,
                               **kw)

    ref, vjp = jax.vjp(jfn, jnp.asarray(x3), jnp.asarray(w), jnp.asarray(b))
    rdx, rdw, rdb = vjp(jnp.asarray(dy))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x3, w, b))
    got = ops.csd_matmul(tx, tw, _t(bp.block_idx).int(),
                         bias=tb if with_bias else None,
                         activation=activation, out_idx=_t(bp.out_idx).int(),
                         out_slot=_t(bp.out_slot).int())
    got.backward(_t(dy))
    _close_rel(got.detach(), ref, TOL_BWD["float32"])
    _close_rel(tx.grad, rdx, TOL_BWD["float32"])
    _close_rel(tw.grad, rdw, TOL_BWD["float32"])
    if with_bias:
        _close_rel(tb.grad, rdb, TOL_BWD["float32"])
    else:
        assert tb.grad is None


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_csd_matmul_backward_masks_once(activation, with_bias, monkeypatch):
    """``CsdMatmul.backward`` folds the activation's derivative into the
    cotangent once and hands that one masked cotangent to dx and dw (here
    the plain versions, on the card the mask kernel and the products), and
    dx, dw and db still match the JAX package's csd_matmul VJP."""
    calls = []
    real = csd_spmm.mask_cotangent

    def counting(dy, aux, act):
        if act is not None:
            calls.append(act)
        return real(dy, aux, act)

    monkeypatch.setattr(csd_spmm, "mask_cotangent", counting)
    m = 24
    bp, x, w, b = _junction(19, m)
    dy = np.random.default_rng(20).normal(size=(m, bp.n_out)) \
        .astype(np.float32)

    def jfn(x_, w_, b_):
        return jops.csd_matmul(x_, w_, bp, bias=b_ if with_bias else None,
                               activation=activation, backend="xla")

    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    rdx, rdw, rdb = vjp(jnp.asarray(dy))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    got = ops.csd_matmul(tx, tw, _t(bp.block_idx).int(),
                         bias=tb if with_bias else None,
                         activation=activation, out_idx=_t(bp.out_idx).int(),
                         out_slot=_t(bp.out_slot).int())
    assert calls == []  # the forward masks nothing
    got.backward(_t(dy))
    assert calls == [activation]
    _close_rel(tx.grad, rdx, TOL_BWD["float32"])
    _close_rel(tw.grad, rdw, TOL_BWD["float32"])
    if with_bias:
        _close_rel(tb.grad, rdb, TOL_BWD["float32"])


def test_training_cuda_wrappers_refuse_cpu_tensors():
    """The backward wrappers launch their kernels or raise, like the
    forward one: a CPU tensor never runs the plain version through them."""
    bp, (_, _, _, _), (tx, tw, tdy, taux) = _bwd_case(11, 8, "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_dx_cuda(tdy, tw, _t(bp.out_idx).int(),
                                  _t(bp.out_slot).int())
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_dw_cuda(tx, tdy, _t(bp.block_idx).int(),
                                  block_in=bp.block_in,
                                  block_out=bp.block_out)
    with pytest.raises(ValueError, match="needs aux"):
        csd_spmm.csd_spmm_dx_cuda(tdy, tw, _t(bp.out_idx).int(),
                                  _t(bp.out_slot).int(), activation="gelu")
    assert csd_spmm.csd_spmm_dx_cuda.launches == 0
    assert csd_spmm.csd_spmm_dw_cuda.launches == 0
