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


# the junction of the training kernels: 8 left blocks of 128, 4 right blocks
# of 192 (bR not a power of two), fan-in 4 and fan-out 2
TRAIN_JUNCTION = dict(n_in=1024, n_out=768, bl=128, br=192)
# max |kernel - plain| over max |plain|: f32 sums taken in another order;
# bf16 one rounding of each output (2^-8 relative) on top of that
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DB_TOL = 1e-4  # db is an f32 column sum in both versions


def _train_case(device, dtype, m, seed=5):
    bp, x, w, b = _junction(seed, m, **TRAIN_JUNCTION)
    rng = np.random.default_rng(seed + 1)
    dy = rng.normal(size=(m, bp.n_out)).astype(np.float32)
    aux = rng.normal(size=(m, bp.n_out)).astype(np.float32)
    to = lambda a: _t(a).to(device, dtype)  # noqa: E731
    pat = {k: _t(getattr(bp, k)).to(device).int()
           for k in ("block_idx", "out_idx", "out_slot")}
    return bp, to(x), to(w), to(b), to(dy), to(aux), pat


def _close(got, ref, tol):
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [64, 100, 4096])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_fwd_save_preact_cuda_matches_plain(cuda_device, activation,
                                                     m, dtype):
    bp, x, w, b, _, _, pat = _train_case(cuda_device, dtype, m)
    kw = dict(bias=b, activation=activation, save_preact=True)
    y, z = csd_spmm.csd_spmm_fwd_cuda(x, w, pat["block_idx"], **kw)
    y_ref, z_ref = csd_spmm.csd_spmm_fwd_plain(x, w, pat["block_idx"], **kw)
    torch.cuda.synchronize()
    _close(y, y_ref, TRAIN_TOL[dtype])
    _close(z, z_ref, TRAIN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [64, 100, 4096])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_dx_cuda_matches_plain(cuda_device, activation, m, dtype):
    bp, _, w, _, dy, aux, pat = _train_case(cuda_device, dtype, m)
    kw = dict(aux=aux, activation=activation)
    got = csd_spmm.csd_spmm_dx_cuda(dy, w, pat["out_idx"], pat["out_slot"],
                                    **kw)
    ref = csd_spmm.csd_spmm_dx_plain(dy, w, pat["out_idx"], pat["out_slot"],
                                     **kw)
    torch.cuda.synchronize()
    assert got.shape == (m, bp.n_in) and got.dtype == dtype
    _close(got, ref, TRAIN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [64, 100, 4096])
@pytest.mark.parametrize("want_db", [False, True], ids=["nodb", "db"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_dw_cuda_matches_plain(cuda_device, activation, want_db, m,
                                        dtype):
    bp, x, _, _, dy, aux, pat = _train_case(cuda_device, dtype, m)
    kw = dict(block_in=bp.block_in, block_out=bp.block_out, aux=aux,
              activation=activation, want_db=want_db)
    got = csd_spmm.csd_spmm_dw_cuda(x, dy, pat["block_idx"], **kw)
    ref = csd_spmm.csd_spmm_dw_plain(x, dy, pat["block_idx"], **kw)
    torch.cuda.synchronize()
    if want_db:
        (got, db), (ref, db_ref) = got, ref
        assert db.dtype == torch.float32
        _close(db, db_ref, DB_TOL)
    assert got.shape == (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
    assert got.dtype == dtype
    _close(got, ref, TRAIN_TOL[dtype])


# ---------------------------------------------------------------------------
# the int8 serving kernels
# ---------------------------------------------------------------------------


def _quantize(w):
    """Per-block symmetric int8 slab and f32 scales (core.quant)."""
    from repro_torch.core.quant import quantize_slab
    return quantize_slab(_t(w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 16, 100])
@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_csd_spmm_quant_cuda_matches_plain(cuda_device, with_bias,
                                           activation, m, dtype, tol):
    bp, x, w, b = _junction(6, m, n_in=2048, n_out=1024, bl=256, br=512)
    q, s = (t.to(cuda_device) for t in _quantize(w))
    xd = _t(x).to(cuda_device, dtype)
    idx = _t(bp.block_idx).to(cuda_device).int()
    bias = _t(b).to(cuda_device, dtype) if with_bias else None
    kw = dict(bias=bias, activation=activation, w_scale=s)
    n0 = csd_spmm.csd_spmm_fwd_quant_cuda.launches
    got = csd_spmm.csd_spmm_fwd_cuda(xd, q, idx, **kw)
    ref = csd_spmm.csd_spmm_fwd_plain(xd, q, idx, **kw)
    torch.cuda.synchronize()
    assert csd_spmm.csd_spmm_fwd_quant_cuda.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (m, bp.n_out)
    np.testing.assert_allclose(got.float().cpu(), ref.float().cpu(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, 30.0),
                                            (70, None)])
@pytest.mark.parametrize("dh", [64, 256])
def test_paged_decode_quant_cuda_matches_plain(cuda_device, dh, window,
                                               softcap, dtype, tol):
    from repro_torch.serving.kv_cache import quantize_kv
    case = _paged_case(dh=dh)
    q = _t(case[0]).to(cuda_device, dtype)
    # int8 pages with per-token scales, as write_kv_quant stores them
    k8, ks = quantize_kv(_t(case[1]))
    v8, vs = quantize_kv(_t(case[2]))
    k8, v8, ks, vs = (t.to(cuda_device) for t in (k8, v8, ks, vs))
    table, lengths = (_t(a).to(cuda_device) for a in case[3:])
    kw = dict(window=window, softcap=softcap, k_scale=ks, v_scale=vs)
    n0 = flash_attention.paged_decode_attention_quant_cuda.launches
    got = flash_attention.paged_decode_attention_cuda(q, k8, v8, table,
                                                      lengths, **kw)
    ref = flash_attention.paged_decode_attention_plain(q, k8, v8, table,
                                                       lengths, **kw)
    torch.cuda.synchronize()
    assert flash_attention.paged_decode_attention_quant_cuda.launches \
        == n0 + 1
    np.testing.assert_allclose(got.float().cpu(), ref.float().cpu(),
                               atol=tol, rtol=tol)
    assert (got[2] == 0).all()  # the empty row


# ---------------------------------------------------------------------------
# the expert-batched (MoE) forward kernels, full width and int8
# ---------------------------------------------------------------------------


def _batched_junction(seed, e, m, n_in, n_out, bl, br, rho=0.5):
    rng = np.random.default_rng(seed)
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br,
                            seed=seed)
    x = rng.normal(size=(e, m, n_in)).astype(np.float32)
    w = (rng.normal(size=(e, bp.n_rb, bp.d_in_b, bl, br))
         / np.sqrt(bp.d_in_b * bl)).astype(np.float32)
    b = rng.normal(size=(e, n_out)).astype(np.float32)
    return bp, x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 16, 100])
@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-slab", "int8"])
def test_csd_spmm_batched_cuda_matches_plain(cuda_device, quant, activation,
                                             m, dtype, tol):
    """Granite's down junction shape (128 x 256 blocks, fan-in 3) at 6
    experts, with bias; on 132 SMs the fan-in slots split over 3, 3 and 2
    CTAs at m = 3, 16 and 100, so the second pass runs with an expert
    stride in the bias."""
    bp, x, w, b = _batched_junction(7, 6, m, n_in=512, n_out=1024, bl=128,
                                    br=256, rho=0.75)
    xd = _t(x).to(cuda_device, dtype)
    idx = _t(bp.block_idx).to(cuda_device).int()
    bias = _t(b).to(cuda_device, dtype)
    if quant:
        q, s = (t.to(cuda_device) for t in _quantize(w))
        wd, kw = q, dict(w_scale=s)
        counter = csd_spmm.csd_spmm_fwd_quant_batched_cuda
    else:
        wd, kw = _t(w).to(cuda_device, dtype), {}
        counter = csd_spmm.csd_spmm_fwd_batched_cuda
    kw.update(bias=bias, activation=activation)
    n0 = counter.launches
    got = csd_spmm.csd_spmm_fwd_batched_cuda(xd, wd, idx, **kw)
    ref = csd_spmm.csd_spmm_fwd_batched_plain(xd, wd, idx, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (6, m, bp.n_out)
    np.testing.assert_allclose(got.float().cpu(), ref.float().cpu(),
                               atol=tol, rtol=tol)
    # expert e is the single junction over x[e], w[e], bias[e]
    e = 4
    one = csd_spmm.csd_spmm_fwd_cuda(
        xd[e].contiguous(), wd[e].contiguous(), idx, bias=bias[e].contiguous(),
        activation=activation,
        w_scale=kw["w_scale"][e].contiguous() if quant else None)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[e].float().cpu(), one.float().cpu(),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the expert-batched (MoE) training kernels
# ---------------------------------------------------------------------------


def _batched_train_case(device, dtype, e, m, seed=9):
    bp, x, w, b = _batched_junction(seed, e, m, **TRAIN_JUNCTION)
    rng = np.random.default_rng(seed + 1)
    dy = rng.normal(size=(e, m, bp.n_out)).astype(np.float32)
    aux = rng.normal(size=(e, m, bp.n_out)).astype(np.float32)
    to = lambda a: _t(a).to(device, dtype)  # noqa: E731
    pat = {k: _t(getattr(bp, k)).to(device).int()
           for k in ("block_idx", "out_idx", "out_slot")}
    return bp, to(x), to(w), to(b), to(dy), to(aux), pat


N_EXPERTS = 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 100, 1280])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_fwd_batched_save_preact_cuda_matches_plain(
        cuda_device, activation, m, dtype):
    bp, x, w, b, _, _, pat = _batched_train_case(cuda_device, dtype,
                                                 N_EXPERTS, m)
    kw = dict(bias=b, activation=activation, save_preact=True)
    n0 = csd_spmm.csd_spmm_fwd_batched_cuda.launches
    y, z = csd_spmm.csd_spmm_fwd_batched_cuda(x, w, pat["block_idx"], **kw)
    y_ref, z_ref = csd_spmm.csd_spmm_fwd_batched_plain(x, w,
                                                       pat["block_idx"], **kw)
    torch.cuda.synchronize()
    assert csd_spmm.csd_spmm_fwd_batched_cuda.launches == n0 + 1
    assert y.shape == z.shape == (N_EXPERTS, m, bp.n_out)
    _close(y, y_ref, TRAIN_TOL[dtype])
    _close(z, z_ref, TRAIN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 100, 1280])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_dx_batched_cuda_matches_plain(cuda_device, activation, m,
                                                dtype):
    bp, _, w, _, dy, aux, pat = _batched_train_case(cuda_device, dtype,
                                                    N_EXPERTS, m)
    kw = dict(aux=aux, activation=activation)
    oidx, oslot = pat["out_idx"], pat["out_slot"]
    n0 = csd_spmm.csd_spmm_dx_batched_cuda.launches
    got = csd_spmm.csd_spmm_dx_batched_cuda(dy, w, oidx, oslot, **kw)
    ref = csd_spmm.csd_spmm_dx_batched_plain(dy, w, oidx, oslot, **kw)
    torch.cuda.synchronize()
    assert csd_spmm.csd_spmm_dx_batched_cuda.launches == n0 + 1
    assert got.shape == (N_EXPERTS, m, bp.n_in) and got.dtype == dtype
    _close(got, ref, TRAIN_TOL[dtype])
    # expert e is the single junction on expert e's operands, bit for bit
    e = 3
    one = csd_spmm.csd_spmm_dx_cuda(
        dy[e].contiguous(), w[e].contiguous(), oidx, oslot,
        aux=aux[e].contiguous(), activation=activation)
    torch.cuda.synchronize()
    assert torch.equal(got[e], one)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [3, 100, 1280])
@pytest.mark.parametrize("want_db", [False, True], ids=["nodb", "db"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_csd_spmm_dw_batched_cuda_matches_plain(cuda_device, activation,
                                                want_db, m, dtype):
    bp, x, _, _, dy, aux, pat = _batched_train_case(cuda_device, dtype,
                                                    N_EXPERTS, m)
    kw = dict(block_in=bp.block_in, block_out=bp.block_out, aux=aux,
              activation=activation, want_db=want_db)
    n0 = csd_spmm.csd_spmm_dw_batched_cuda.launches
    got = csd_spmm.csd_spmm_dw_batched_cuda(x, dy, pat["block_idx"], **kw)
    ref = csd_spmm.csd_spmm_dw_batched_plain(x, dy, pat["block_idx"], **kw)
    e = 3
    kw1 = dict(kw, aux=aux[e].contiguous())
    one = csd_spmm.csd_spmm_dw_cuda(x[e].contiguous(), dy[e].contiguous(),
                                    pat["block_idx"], **kw1)
    torch.cuda.synchronize()
    assert csd_spmm.csd_spmm_dw_batched_cuda.launches == n0 + 1
    if want_db:
        (got, db), (ref, db_ref), (one, db_one) = got, ref, one
        assert db.dtype == torch.float32
        assert db.shape == (N_EXPERTS, bp.n_out)
        _close(db, db_ref, DB_TOL)
        assert torch.equal(db[e], db_one)
    assert got.shape == (N_EXPERTS, bp.n_rb, bp.d_in_b, bp.block_in,
                         bp.block_out)
    assert got.dtype == dtype
    _close(got, ref, TRAIN_TOL[dtype])
    # expert e is the single junction on expert e's operands, bit for bit
    assert torch.equal(got[e], one)
