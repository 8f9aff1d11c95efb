"""The CUDA kernels against their plain versions, on the card.

These tests carry the ``cuda`` marker and skip where there is no card; they
import neither JAX nor the JAX package, so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import contextlib

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


# (G, Dh, page size) of the paged cases: every group form of the kernel (1,
# 2, 4 by G 3, 8 by G 7 and 8), every head-dim bucket (Dh 16 and 64 in the
# 64 bucket, 128, 256), page sizes 8, 16 and 32 (one TMA load per page),
# and 12 (not a multiple of 8: copied with cp.async instead)
PAGED_GEOMETRIES = [(3, 64, 16), (1, 16, 8), (2, 64, 16), (7, 128, 32),
                    (8, 256, 16), (2, 256, 8), (1, 128, 16), (8, 16, 32),
                    (7, 64, 8), (2, 256, 32), (2, 64, 12), (3, 256, 12)]
# keys a row's table holds: one launch (the serving rows' short tables) or
# splits and the merge (the split rule cuts tables past 512 keys)
PAGED_TABLE_KEYS = [208, 1040]


def _paged_case(seed=0, b=4, hkv=2, g=3, dh=64, page=16, table_keys=208,
                window=None):
    rng = np.random.default_rng(seed)
    n_pages = table_keys // page
    q = rng.normal(size=(b, hkv, g, dh)).astype(np.float32)
    # rows of different lengths (one empty, one of 3 keys, two spanning
    # several tiles); unmapped entries are -1: the table tail and, with a
    # window, the leading pages every query has left
    lengths = np.minimum(np.asarray([3, 600, 0, 317], np.int32)[:b],
                         n_pages * page)
    total = sum(-(-int(n) // page) for n in lengths) + 1
    k_pages = rng.normal(size=(total, page, hkv, dh)).astype(np.float32)
    v_pages = rng.normal(size=(total, page, hkv, dh)).astype(np.float32)
    table = np.full((b, n_pages), -1, np.int32)
    perm = rng.permutation(total - 1)
    k = 0
    for i in range(b):
        n = int(lengths[i])
        for pg in range(-(-n // page)):
            if window is None or (pg + 1) * page > n - window:
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
@pytest.mark.parametrize("table_keys", PAGED_TABLE_KEYS)
@pytest.mark.parametrize("g,dh,page", PAGED_GEOMETRIES)
def test_paged_decode_cuda_matches_plain(cuda_device, g, dh, page,
                                         table_keys, window, softcap,
                                         dtype, tol):
    case = _paged_case(g=g, dh=dh, page=page, table_keys=table_keys,
                       window=window)
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
@pytest.mark.parametrize("table_keys", PAGED_TABLE_KEYS)
@pytest.mark.parametrize("g,dh,page", PAGED_GEOMETRIES)
def test_paged_decode_quant_cuda_matches_plain(cuda_device, g, dh, page,
                                               table_keys, window, softcap,
                                               dtype, tol):
    from repro_torch.serving.kv_cache import quantize_kv
    case = _paged_case(g=g, dh=dh, page=page, table_keys=table_keys,
                       window=window)
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


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("dh", [64, 256])
def test_paged_decode_split_nan_filled_repeatable(cuda_device, dh, quant,
                                                  nan_outputs):
    """At a shape the split rule cuts (a 1040-key table, the split kernel
    then the merge), into NaN-filled outputs and partials: every element
    written, within the plain version's tolerance, two runs bit-equal."""
    from repro_torch.analysis.capture import capture_launch
    from repro_torch.serving.kv_cache import quantize_kv
    q, kp, vp, table, lengths = _paged_case(g=2, dh=dh, table_keys=1040,
                                            window=300)
    q = _t(q).to(cuda_device, torch.bfloat16)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(_t(kp)), quantize_kv(_t(vp))
        kw = dict(k_scale=ks.to(cuda_device), v_scale=vs.to(cuda_device))
        kp, vp = kp.to(cuda_device), vp.to(cuda_device)
    else:
        kw = {}
        kp, vp = (_t(a).to(cuda_device, torch.bfloat16) for a in (kp, vp))
    table, lengths = (_t(a).to(cuda_device) for a in (table, lengths))
    kw.update(window=300, softcap=30.0)
    args = (q, kp, vp, table, lengths)
    plan = capture_launch(flash_attention.paged_decode_attention_cuda,
                          *args, **kw)
    assert plan.n_splits > 1 and len(plan.launches) == 2
    first, second = (flash_attention.paged_decode_attention_cuda(*args, **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    ref = flash_attention.paged_decode_attention_plain(*args, **kw)
    assert not bool(torch.isnan(first).any())
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))
    np.testing.assert_allclose(first.float().cpu(), ref.float().cpu(),
                               atol=1e-2, rtol=1e-2)
    assert (first[2] == 0).all()


# (G, Dh, page size) of the grouped form (groups above 8 query heads, one
# CTA per chunk of 8): granite-34b's 48 at Dh 128, a group of 12 (a last
# chunk of 4), 9 (a last chunk of one head) at Dh 64 and 256; at Dh 16 a
# merge CTA's 256 output elements span more than 8 heads
GROUPED_GEOMETRIES = [(48, 128, 16), (12, 128, 16), (9, 64, 8),
                      (12, 256, 32), (9, 16, 8), (48, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("window,softcap", [(None, None), (70, 50.0)])
@pytest.mark.parametrize("table_keys", PAGED_TABLE_KEYS)
@pytest.mark.parametrize("g,dh,page", GROUPED_GEOMETRIES)
def test_paged_decode_grouped_cuda_matches_plain(cuda_device, g, dh, page,
                                                 table_keys, window,
                                                 softcap, quant, dtype, tol):
    """The grouped form through ``paged_decode_attention_cuda`` (it routes
    G above 8 there, one launch counted on the grouped wrapper), in one
    launch and in splits, against the plain version."""
    from repro_torch.serving.kv_cache import quantize_kv
    case = _paged_case(b=4, hkv=1 if g == 48 else 2, g=g, dh=dh, page=page,
                       table_keys=table_keys, window=window)
    q = _t(case[0]).to(cuda_device, dtype)
    kw = dict(window=window, softcap=softcap)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(_t(case[1])), quantize_kv(
            _t(case[2]))
        kp, vp = kp.to(cuda_device), vp.to(cuda_device)
        kw.update(k_scale=ks.to(cuda_device), v_scale=vs.to(cuda_device))
        counter = flash_attention.paged_decode_attention_quant_grouped_cuda
    else:
        kp, vp = (_t(a).to(cuda_device, dtype) for a in case[1:3])
        counter = flash_attention.paged_decode_attention_grouped_cuda
    table, lengths = (_t(a).to(cuda_device) for a in case[3:])
    n0 = counter.launches
    got = flash_attention.paged_decode_attention_cuda(q, kp, vp, table,
                                                      lengths, **kw)
    ref = flash_attention.paged_decode_attention_plain(q, kp, vp, table,
                                                       lengths, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    np.testing.assert_allclose(got.float().cpu(), ref.float().cpu(),
                               atol=tol, rtol=tol)
    assert (got[2] == 0).all()  # the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g", [12, 48])
def test_paged_decode_grouped_nan_filled_repeatable(cuda_device, g, quant,
                                                    nan_outputs):
    """The grouped form at a shape the split rule cuts, into NaN-filled
    outputs and partials: every element written by its chunk's CTA,
    within tolerance of plain, two runs bit-equal."""
    from repro_torch.analysis.capture import capture_launch
    from repro_torch.kernels import launch
    from repro_torch.serving.kv_cache import quantize_kv
    q, kp, vp, table, lengths = _paged_case(hkv=1, g=g, dh=128,
                                            table_keys=1040, window=300)
    q = _t(q).to(cuda_device, torch.bfloat16)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(_t(kp)), quantize_kv(_t(vp))
        kw = dict(k_scale=ks.to(cuda_device), v_scale=vs.to(cuda_device))
        kp, vp = kp.to(cuda_device), vp.to(cuda_device)
    else:
        kw = {}
        kp, vp = (_t(a).to(cuda_device, torch.bfloat16) for a in (kp, vp))
    table, lengths = (_t(a).to(cuda_device) for a in (table, lengths))
    kw.update(window=300, softcap=50.0)
    args = (q, kp, vp, table, lengths)
    # the chunked form (f32's, and bf16's where the tensor-core form does
    # not take the case), forced over these bf16 q
    with launch.forced_paged_form("cores"):
        plan = capture_launch(flash_attention.paged_decode_attention_cuda,
                              *args, **kw)
        assert plan.n_splits > 1 and plan.launches[0].grid[1] == -(-g // 8)
        first, second = (flash_attention.paged_decode_attention_cuda(
            *args, **kw) for _ in range(2))
    torch.cuda.synchronize()
    ref = flash_attention.paged_decode_attention_plain(*args, **kw)
    assert not bool(torch.isnan(first).any())
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))
    np.testing.assert_allclose(first.float().cpu(), ref.float().cpu(),
                               atol=1e-2, rtol=1e-2)
    assert (first[2] == 0).all()


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
                                             m, dtype, tol, force_body):
    """Granite's down junction shape (128 x 256 blocks, fan-in 3) at 6
    experts, with bias; on 132 SMs the fan-in slots split over 3, 3 and 2
    CTAs at m = 3, 16 and 100, so the second pass runs with an expert
    stride in the bias (the grid body, forced: in bf16 the rule takes the
    wgmma body for these 96 64-wide tiles)."""
    force_body(0)
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


# ---------------------------------------------------------------------------
# the backward's pieces: the mask once, dx and dw on the masked cotangent
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("shape", [(100, 768), (5, 77, 1024)],
                         ids=["2d", "3d"])
def test_csd_mask_cotangent_cuda_equals_plain(cuda_device, shape, activation,
                                              dtype):
    """The mask kernel does the plain version's f32 arithmetic in its order
    and rounds once to the dtype of dy: equal element for element."""
    rng = np.random.default_rng(13)
    dy, aux = (_t(rng.normal(size=shape).astype(np.float32) * 3)
               .to(cuda_device, dtype) for _ in range(2))
    n0 = csd_spmm.csd_mask_cotangent_cuda.launches
    got = csd_spmm.csd_mask_cotangent_cuda(dy, aux, activation)
    ref = csd_spmm.mask_cotangent(dy, aux, activation)
    torch.cuda.synchronize()
    assert csd_spmm.csd_mask_cotangent_cuda.launches == n0 + 1
    assert got.dtype == dtype and got.shape == dy.shape
    assert torch.equal(got, ref)


@pytest.fixture
def nan_outputs(monkeypatch):
    """Every launch's outputs filled with NaN just before the kernel runs,
    so that an element a kernel leaves unwritten shows."""
    from repro_torch.kernels import launch
    real = launch.run

    def run(plan, buffers, call):
        for k, t in buffers.items():
            if t is not None and plan.buffers[k].role != "in":
                t.fill_(float("nan"))
        return real(plan, buffers, call)

    monkeypatch.setattr(launch, "run", run)


# (experts or None, M, n_in, n_out, bL, bR): ragged M against the 128-row
# bf16 tile, a single row, 64 x 64 blocks (the 64-wide tiles), three experts
# with a ragged M
BWD_CASES = {
    "m1": (None, 1, 1024, 768, 128, 192),
    "m77": (None, 77, 1024, 768, 128, 192),
    "m1000": (None, 1000, 1024, 768, 128, 192),
    "bl64_m77": (None, 77, 256, 384, 64, 64),
    "e3_m77": (3, 77, 1024, 768, 128, 192),
    "e3_m1000": (3, 1000, 512, 1024, 128, 256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_csd_spmm_bwd_cuda_ragged_nan_filled_repeatable(cuda_device, case,
                                                        dtype, nan_outputs):
    """The gelu backward as ``CsdMatmul`` runs it (the mask once, then dx
    and dw with db on g) into NaN-filled outputs: every element written,
    within the plain versions' tolerance, and two runs bit-equal."""
    e, m, n_in, n_out, bl, br = BWD_CASES[case]
    lead = () if e is None else (e,)
    bp = make_block_pattern(n_in, n_out, 0.5, block_in=bl, block_out=br,
                            seed=3)
    rng = np.random.default_rng(4)
    to = lambda a: _t(a.astype(np.float32)).to(cuda_device, dtype)  # noqa
    x = to(rng.normal(size=lead + (m, n_in)))
    w = to(rng.normal(size=lead + (bp.n_rb, bp.d_in_b, bl, br))
           / np.sqrt(bp.d_in_b * bl))
    dy, aux = (to(rng.normal(size=lead + (m, n_out))) for _ in range(2))
    pat = {k: _t(getattr(bp, k)).to(cuda_device).int()
           for k in ("block_idx", "out_idx", "out_slot")}
    form = "" if e is None else "_batched"
    dx_fn = getattr(csd_spmm, f"csd_spmm_dx{form}_cuda")
    dw_fn = getattr(csd_spmm, f"csd_spmm_dw{form}_cuda")
    kw = dict(block_in=bl, block_out=br, want_db=True)

    def run():
        g = csd_spmm.csd_mask_cotangent_cuda(dy, aux, "gelu")
        dx = dx_fn(g, w, pat["out_idx"], pat["out_slot"])
        dw, db = dw_fn(x, g, pat["block_idx"], **kw)
        torch.cuda.synchronize()
        return g, dx, dw, db

    first, second = run(), run()
    g_ref = csd_spmm.mask_cotangent(dy, aux, "gelu")
    refs = (g_ref,
            getattr(csd_spmm, f"csd_spmm_dx{form}_plain")(
                g_ref, w, pat["out_idx"], pat["out_slot"]),
            *getattr(csd_spmm, f"csd_spmm_dw{form}_plain")(
                x, g_ref, pat["block_idx"], **kw))
    for got, again in zip(first, second):
        assert not bool(torch.isnan(got).any())
        assert torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    assert torch.equal(first[0], refs[0])
    for got, ref, tol in zip(first[1:], refs[1:],
                             (TRAIN_TOL[dtype], TRAIN_TOL[dtype], DB_TOL)):
        _close(got, ref, tol)


# ---------------------------------------------------------------------------
# the forward's wgmma body (csd_spmm_fwd_wgmma_kernel)
# ---------------------------------------------------------------------------

# three experts of a ragged M (three 128-row tiles, the last of 44 rows)
# over 128 x 256 blocks, so that every tile width (64, 128, 256) divides bR
WGMMA_E, WGMMA_M = 3, 300
WGMMA_JUNCTION = dict(n_in=512, n_out=1024, bl=128, br=256, rho=0.5)


@pytest.fixture
def force_body():
    """``force_body(t)``: the forward's plans take the body of tile width
    ``t`` (0 the grid body) whatever ``launch.fwd_tile_n``'s rule picks,
    for the rest of the test (``launch.forced_body``)."""
    from repro_torch.kernels import launch
    with contextlib.ExitStack() as stack:
        yield lambda tile_n: stack.enter_context(launch.forced_body(
            launch.body_of_tile_n(tile_n), quant=False))


def _wgmma_fwd(x, w, idx, **kw):
    """The forward through its wrapper (with ``force_body`` the wgmma body
    at a forced width: the rule would pick another for so few tiles)."""
    fn = csd_spmm.csd_spmm_fwd_batched_cuda if x.dim() == 3 \
        else csd_spmm.csd_spmm_fwd_cuda
    return fn(x, w, idx, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [64, 128, 256])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("save_preact", [False, True])
def test_csd_spmm_fwd_wgmma_matches_plain(cuda_device, save_preact,
                                          with_bias, activation, tile_n,
                                          nan_outputs, force_body):
    """The wgmma body at each tile width against the plain version, three
    experts of a ragged M, into NaN-filled outputs: every element written,
    y and z within the training tolerance."""
    bp, x, w, b = _batched_junction(13, WGMMA_E, WGMMA_M, **WGMMA_JUNCTION)
    to = lambda a: _t(a).to(cuda_device, torch.bfloat16)  # noqa: E731
    x, w = to(x), to(w)
    idx = _t(bp.block_idx).to(cuda_device).int()
    kw = dict(bias=to(b) if with_bias else None, activation=activation,
              save_preact=save_preact)
    force_body(tile_n)
    got = _wgmma_fwd(x, w, idx, **kw)
    ref = csd_spmm.csd_spmm_fwd_batched_plain(x, w, idx, **kw)
    torch.cuda.synchronize()
    got, ref = (o if save_preact else (o,) for o in (got, ref))
    for g, r in zip(got, ref):
        assert g.shape == (WGMMA_E, WGMMA_M, bp.n_out)
        assert not bool(torch.isnan(g).any())
        _close(g, r, TRAIN_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [64, 256])
def test_csd_spmm_fwd_wgmma_4d_is_bit_identical(cuda_device, tile_n,
                                                force_body):
    """The single junction (E = 1) through the wgmma body, twice: the
    fan-in stays inside each CTA, so the two runs agree bit for bit, and
    both agree with the plain version."""
    bp, x, w, b = _junction(14, 1000, 512, 1024, 128, 256)
    to = lambda a: _t(a).to(cuda_device, torch.bfloat16)  # noqa: E731
    x, w, b = to(x), to(w), to(b)
    idx = _t(bp.block_idx).to(cuda_device).int()
    kw = dict(bias=b, activation="gelu", save_preact=True)
    force_body(tile_n)
    (y1, z1), (y2, z2) = (_wgmma_fwd(x, w, idx, **kw) for _ in range(2))
    y_ref, z_ref = csd_spmm.csd_spmm_fwd_plain(x, w, idx, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(z1, z2)
    _close(y1, y_ref, TRAIN_TOL[torch.bfloat16])
    _close(z1, z_ref, TRAIN_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("n_sm", [5, 7])
def test_csd_spmm_fwd_wgmma_halved_last_round(cuda_device, n_sm,
                                              monkeypatch, nan_outputs,
                                              force_body):
    """Few persistent CTAs (the plan's SM count lowered to 5 or 7): the 36
    tiles of 256 columns leave one tile for a last round, which runs as two
    128-column halves on two CTAs; every element written, within the
    training tolerance, two runs bit-equal."""
    from repro_torch.kernels import launch
    monkeypatch.setattr(launch, "sm_count", lambda device: n_sm)
    assert launch.fwd_full_tiles(36, n_sm, 256) == 35
    bp, x, w, b = _batched_junction(16, WGMMA_E, WGMMA_M, **WGMMA_JUNCTION)
    to = lambda a: _t(a).to(cuda_device, torch.bfloat16)  # noqa: E731
    x, w, b = to(x), to(w), to(b)
    idx = _t(bp.block_idx).to(cuda_device).int()
    kw = dict(bias=b, activation="gelu", save_preact=True)
    force_body(256)
    (y1, z1), (y2, z2) = (_wgmma_fwd(x, w, idx, **kw) for _ in range(2))
    y_ref, z_ref = csd_spmm.csd_spmm_fwd_batched_plain(x, w, idx, **kw)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(y1).any() or torch.isnan(z1).any())
    assert torch.equal(y1, y2) and torch.equal(z1, z2)
    _close(y1, y_ref, TRAIN_TOL[torch.bfloat16])
    _close(z1, z_ref, TRAIN_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("e,m", [(32, 4), (3, 1), (1, 17), (1, 64)])
def test_csd_spmm_fwd_wgmma_few_rows(cuda_device, e, m, nan_outputs,
                                     force_body):
    """The wgmma body where a 128-row tile holds only 1-64 rows of each
    expert (the rule sends granite-moe's decode and gemma3-4b's serving
    prefill there): the rows past M read as zeros and are not stored; into
    NaN-filled outputs, within the training tolerance."""
    bp, x, w, b = _batched_junction(17, e, m, **WGMMA_JUNCTION)
    to = lambda a: _t(a).to(cuda_device, torch.bfloat16)  # noqa: E731
    x, w, b = to(x), to(w), to(b)
    if e == 1:
        x, w, b = x[0], w[0], b[0]
    idx = _t(bp.block_idx).to(cuda_device).int()
    kw = dict(bias=b, activation="gelu", save_preact=True)
    force_body(128)
    y, z = _wgmma_fwd(x, w, idx, **kw)
    plain = csd_spmm.csd_spmm_fwd_batched_plain if e > 1 \
        else csd_spmm.csd_spmm_fwd_plain
    y_ref, z_ref = plain(x, w, idx, **kw)
    torch.cuda.synchronize()
    for got, ref in ((y, y_ref), (z, z_ref)):
        assert not bool(torch.isnan(got).any())
        _close(got, ref, TRAIN_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_csd_spmm_fwd_rule_runs_wgmma_at_training_shapes(cuda_device):
    """At a training shape the wrapper itself takes the wgmma body on this
    card's SMs, counts one launch and agrees with the plain version; the
    single junction's decode keeps the grid body."""
    from repro_torch.kernels import launch
    n_sm = launch.sm_count(cuda_device)
    bp, x, w, b = _batched_junction(15, 32, 1280, **WGMMA_JUNCTION)
    assert launch.fwd_tile_n("bfloat16", 32, 1280, bp.n_rb, 256, n_sm) == 256
    assert launch.fwd_tile_n("bfloat16", 1, 4, bp.n_rb, 256, n_sm) == 0
    to = lambda a: _t(a).to(cuda_device, torch.bfloat16)  # noqa: E731
    x, w, b = to(x), to(w), to(b)
    idx = _t(bp.block_idx).to(cuda_device).int()
    n0 = csd_spmm.csd_spmm_fwd_batched_cuda.launches
    got = csd_spmm.csd_spmm_fwd_batched_cuda(x, w, idx, bias=b,
                                             activation="relu")
    ref = csd_spmm.csd_spmm_fwd_batched_plain(x, w, idx, bias=b,
                                              activation="relu")
    torch.cuda.synchronize()
    assert csd_spmm.csd_spmm_fwd_batched_cuda.launches == n0 + 1
    _close(got, ref, TRAIN_TOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# full-sequence attention (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

# (forward, backward) limits of the relative Frobenius error of each block of
# FLASH_ROWS consecutive rows of one (batch, head) of o, dq, dk, dv, and of
# the absolute error of lse: f32 sums in another order; bf16 the rounding of
# P to bf16 for P.V (and of dS for dq, dk) and of each output. Per block:
# a limit scaled by max |plain| would be set by the first causal rows, whose
# |o| is far above a late row's; not per row, because a row with one
# visible key has dq = 0 up to rounding noise.
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
FLASH_ROWS = 64
# (B, Sq, Skv, Hq, Hkv, causal, window, softcap, q_offset): S 200 is not a
# multiple of either CTA tile (64 rows, 32/64 streamed)
FLASH_CASES = {
    "causal_g2": (2, 200, 200, 4, 2, True, None, None, 0),
    "window_g4": (1, 200, 200, 8, 2, True, 50, None, 0),
    "softcap_g1": (2, 130, 130, 2, 2, True, None, 30.0, 0),
    "offset": (1, 70, 150, 4, 2, True, None, None, 13),
    "not_causal": (1, 100, 77, 4, 1, False, None, 50.0, 0),
    # queries 56.. see none of the 40 keys: empty rows give 0
    "empty_rows": (1, 100, 40, 2, 1, True, 16, None, 0),
}


def _block_close(got, ref, tol):
    """Every block of FLASH_ROWS rows of one (batch, head) of (B, S, H, Dh)
    within ``tol`` in relative Frobenius error; a zero block stays zero."""
    e2 = (got.float() - ref.float()).square().sum(-1)          # (B, S, H)
    r2 = ref.float().square().sum(-1)
    pad = (-e2.shape[1]) % FLASH_ROWS
    e2, r2 = (torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
        t.shape[0], -1, FLASH_ROWS, t.shape[2]).sum(2) for t in (e2, r2))
    assert bool((e2[r2 == 0] == 0).all())
    err = float((e2[r2 > 0] / r2[r2 > 0]).sqrt().max())
    assert err <= tol, err


def _flash_case(device, dtype, dh, case, seed=11):
    b, sq, skv, hq, hkv, causal, window, softcap, off = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (_t(rng.normal(size=(b, s, h, dh)).astype(np.float32))
               .to(device, dtype)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    do = _t(rng.normal(size=(b, sq, hq, dh)).astype(np.float32)) \
        .to(device, dtype)
    kw = dict(causal=causal, window=window, logit_softcap=softcap,
              q_offset=off)
    return q, k, v, do, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dh", [16, 64, 128, 256])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_cuda_matches_plain(cuda_device, case, dh, dtype):
    q, k, v, do, kw = _flash_case(cuda_device, dtype, dh, case)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    n = flash_attention.flash_attention_cuda.launches
    o, lse = flash_attention.flash_attention_cuda(q, k, v, return_lse=True,
                                                  **kw)
    o_ref, lse_ref = flash_attention.flash_attention_plain(
        q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_cuda.launches == n + 1
    _block_close(o, o_ref, fwd_tol)
    seen = lse_ref > -1e29
    assert torch.equal(lse > -1e29, seen)
    assert float((lse[seen] - lse_ref[seen]).abs().max()) <= fwd_tol
    if case == "empty_rows":
        assert not seen.all() and (o.float()[:, 56:] == 0).all()
    # the backward from the same (o, lse), kernel against plain
    n = flash_attention.flash_attention_bwd_cuda.launches
    got = flash_attention.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     **kw)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bwd_cuda.launches == n + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        _block_close(g, w, bwd_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_bwd_cuda_is_bit_identical(cuda_device, dtype):
    q, k, v, do, kw = _flash_case(cuda_device, dtype, 64, "window_g4")
    o, lse = flash_attention.flash_attention_cuda(q, k, v, return_lse=True,
                                                  **kw)
    first = flash_attention.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                     **kw)
    second = flash_attention.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                      **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# chip_smoke.py phase 6c's bf16 training attention: (B, S, Hq, Hkv, Dh,
# window) of gemma3-4b's global and local layers and of granite-moe's
FLASH_TRAIN = {
    "gemma3_global": (2, 2048, 8, 4, 256, None),
    "gemma3_local": (2, 2048, 8, 4, 256, 1024),
    "granite": (2, 2048, 16, 8, 64, None),
}


def _flash_train_inputs(device, shape, seed=5):
    b, s, hq, hkv, dh, window = FLASH_TRAIN[shape]
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=gen, device=device) \
            .to(torch.bfloat16)
    return (randn(b, s, hq, dh), randn(b, s, hkv, dh), randn(b, s, hkv, dh),
            randn(b, s, hq, dh), dict(window=window))


def _into_nan(fn, *args, **kw):
    """``fn``'s result with every output and scratch buffer of its launch
    filled with NaN before the kernels run."""
    from unittest import mock

    from repro_torch.kernels import launch
    real = launch.run

    def nan_run(plan, buffers, call):
        for name, t in buffers.items():
            if t is not None and plan.buffers[name].role != "in":
                t.fill_(float("nan"))
        real(plan, buffers, call)
    with mock.patch.object(launch, "run", nan_run):
        return fn(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(FLASH_TRAIN))
def test_flash_attention_cuda_bf16_at_training_shapes(cuda_device, shape):
    """The bf16 forward and backward at full training width, launched into
    NaN-filled outputs, held per 64-row block against the plain versions."""
    q, k, v, do, kw = _flash_train_inputs(cuda_device, shape)
    fwd_tol, bwd_tol = FLASH_TOL[torch.bfloat16]
    o, lse = _into_nan(flash_attention.flash_attention_cuda, q, k, v,
                       return_lse=True, **kw)
    o_ref, lse_ref = flash_attention.flash_attention_plain(
        q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(o).any() or torch.isnan(lse).any())
    _block_close(o, o_ref, fwd_tol)
    assert float((lse - lse_ref).abs().max()) <= fwd_tol
    del o_ref, lse_ref
    got = _into_nan(flash_attention.flash_attention_bwd_cuda, q, k, v, o, lse,
                    do, **kw)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert not bool(torch.isnan(g).any())
        _block_close(g, w, bwd_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(FLASH_TRAIN))
def test_flash_attention_cuda_bf16_is_bit_identical_at_training_shapes(
        cuda_device, shape):
    q, k, v, do, kw = _flash_train_inputs(cuda_device, shape)
    first = flash_attention.flash_attention_cuda(q, k, v, return_lse=True,
                                                 **kw)
    second = flash_attention.flash_attention_cuda(q, k, v, return_lse=True,
                                                  **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    o, lse = first
    first = flash_attention.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                     **kw)
    second = flash_attention.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                      **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_attention_cuda_refuses_dh_8(cuda_device):
    q, k, v, do, kw = _flash_case(cuda_device, torch.bfloat16, 8,
                                  "causal_g2")
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention.flash_attention_cuda(q, k, v, **kw)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1],
                      device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention.flash_attention_bwd_cuda(q, k, v, q, lse, do, **kw)


@pytest.mark.cuda
def test_attention_forward_runs_the_flash_kernels(cuda_device):
    """On the card the training attention goes through the forward and
    backward kernels, never chunked_attention."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.nn import attention
    cfg = get_config("gemma3_4b", smoke=True).with_(
        head_dim=64, sparsity=get_config("gemma3_4b").sparsity)
    layer = attention.Attention(cfg, window=16, device=cuda_device,
                                generator=torch.Generator(
                                    device=cuda_device).manual_seed(0))
    x = torch.randn((2, 100, cfg.d_model), device=cuda_device,
                    requires_grad=True)
    pos = torch.arange(100, device=cuda_device)[None].expand(2, 100)
    n = (flash_attention.flash_attention_cuda.launches,
         flash_attention.flash_attention_bwd_cuda.launches)
    with mock.patch.object(attention, "chunked_attention",
                           side_effect=AssertionError("chunked ran")):
        layer(x, pos).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.flash_attention_cuda.launches,
            flash_attention.flash_attention_bwd_cuda.launches) \
        == (n[0] + 1, n[1] + 1)
    assert bool(torch.isfinite(x.grad).all())


# (arch, window, logit softcap, qk-norm, KV heads): gemma3-4b's local and
# global layers (G 2), and granite-moe's with G 4
LAYER_CASES = {
    "gemma3_window": ("gemma3_4b", 16, None, True, 2),
    "gemma3_global_softcap": ("gemma3_4b", None, 30.0, True, 2),
    "granite_g4": ("granite_moe_1b_a400m", None, None, False, 1),
}


def attention_layer_against_chunked(device, case):
    """Output, x gradient and every parameter gradient of an ``Attention``
    layer, f32, (B 2, S 100), against the same layer with its attention
    computed by ``chunked_attention`` (the JAX training path's form) from
    the case's own window, softcap and head grouping; returns the largest
    relative Frobenius error."""
    from repro_torch.configs import get_config
    from repro_torch.nn import attention
    arch, window, softcap, qk_norm, n_kv = LAYER_CASES[case]
    cfg = get_config(arch, smoke=True).with_(
        head_dim=64, n_kv_heads=n_kv, logit_softcap=softcap,
        sparsity=get_config(arch).sparsity)
    layer = attention.Attention(
        cfg, window=window, qk_norm=qk_norm, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(5)
    b, s = 2, 100
    x, dy = (_t(rng.normal(size=(b, s, cfg.d_model)).astype(np.float32))
             .to(device) for _ in range(2))
    pos = torch.arange(s, device=device)[None].expand(b, s)

    def chunked(xs):
        q, k, v = layer._qkv(xs, pos)
        qg = q.reshape(b, s, n_kv, cfg.n_heads // n_kv, cfg.head_dim)
        o = attention.chunked_attention(
            qg, k, v, causal=True, window=window, softcap=softcap,
            chunk=16, scale=cfg.head_dim ** -0.5)
        return layer.wo(o.reshape(b, s, -1))

    def run(forward):
        xs = x.clone().requires_grad_()
        layer.zero_grad(set_to_none=True)
        y = forward(xs)
        y.backward(dy)
        return [y.detach(), xs.grad] + [p.grad.clone()
                                        for p in layer.parameters()]

    got = run(lambda xs: layer(xs, pos))
    want = run(chunked)
    assert len(got) > 2 + 3
    return max(float(torch.linalg.vector_norm(g - w)
                     / torch.linalg.vector_norm(w))
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_attention_forward_matches_chunked_attention(cuda_device, case):
    """The model's call of the kernels (window, scale, softcap, head
    grouping) against a reference that does not share that call."""
    n = (flash_attention.flash_attention_cuda.launches,
         flash_attention.flash_attention_bwd_cuda.launches)
    err = attention_layer_against_chunked(cuda_device, case)
    assert (flash_attention.flash_attention_cuda.launches,
            flash_attention.flash_attention_bwd_cuda.launches) \
        == (n[0] + 1, n[1] + 1)
    assert err <= 1e-4, err


# ---------------------------------------------------------------------------
# the int8 forward's bodies (csrc/csd_spmm_fwd_quant.cu)
# ---------------------------------------------------------------------------

# (experts or None, M, n_in, n_out, bL, bR): the stream body at decode M
# (a deep fan-in split over a cluster; three experts of 4 rows) and at
# prefill chunks of 16-64 rows (each row tile), the wgmma body at 200 and
# 300 rows (ragged against its 128-row tile) with 128- and 64-wide tiles
QUANT_BODY_CASES = {
    "stream_m4": (None, 4, 4096, 1024, 256, 512),
    "stream_m13": (None, 13, 2048, 1024, 256, 256),
    "stream_m30": (None, 30, 2048, 1024, 256, 512),
    "stream_m64": (None, 64, 1024, 2048, 256, 1024),
    "stream_e3_m4": (3, 4, 1024, 512, 128, 256),
    "stream_e3_m40": (3, 40, 512, 1024, 128, 256),
    "wgmma_m200": (None, 200, 2048, 1024, 256, 512),
    "wgmma_e3_m300": (3, 300, 512, 1024, 128, 256),
    "wgmma64_e3_m300": (3, 300, 256, 384, 64, 64),
}
QUANT_TOL_F32 = 1e-4  # of max |plain|: f32 sums in another order
SPMM_TOL_BF16 = (1e-2, 1e-2)  # atol, rtol: + one bf16 rounding of y


def _quant_case(device, case, dtype, with_bias, seed=21):
    e, m, n_in, n_out, bl, br = QUANT_BODY_CASES[case]
    lead = () if e is None else (e,)
    bp = make_block_pattern(n_in, n_out, 0.5, block_in=bl, block_out=br,
                            seed=seed)
    rng = np.random.default_rng(seed)
    x = _t(rng.normal(size=lead + (m, n_in)).astype(np.float32))
    w = (rng.normal(size=lead + (bp.n_rb, bp.d_in_b, bl, br))
         / np.sqrt(bp.d_in_b * bl)).astype(np.float32)
    q, s = (t.to(device) for t in _quantize(w))
    b = _t(rng.normal(size=lead + (n_out,)).astype(np.float32))
    idx = _t(bp.block_idx).to(device).int()
    bias = b.to(device, dtype) if with_bias else None
    return bp, x.to(device, dtype), q, s, idx, bias


def _quant_close(got, ref, dtype):
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        assert float((got - ref).abs().max()) \
            <= QUANT_TOL_F32 * float(ref.abs().max())
    else:
        np.testing.assert_allclose(got.cpu(), ref.cpu(),
                                   atol=SPMM_TOL_BF16[0],
                                   rtol=SPMM_TOL_BF16[1])


@pytest.mark.cuda
@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", list(QUANT_BODY_CASES))
def test_csd_spmm_quant_bodies_nan_filled_repeatable(cuda_device, case,
                                                     with_bias, activation,
                                                     nan_outputs):
    """Each bf16 body of the int8 forward the rule picks, 4-D and 5-D, into
    NaN-filled outputs twice: one launch per call, every element written,
    within the bf16 tolerance of the plain version, two runs bit-equal."""
    from repro_torch.analysis.capture import capture_launch
    from repro_torch.kernels import launch
    bp, x, q, s, idx, bias = _quant_case(cuda_device, case, torch.bfloat16,
                                         with_bias)
    batched = x.dim() == 3
    fn = csd_spmm.csd_spmm_fwd_batched_cuda if batched \
        else csd_spmm.csd_spmm_fwd_cuda
    counter = csd_spmm.csd_spmm_fwd_quant_batched_cuda if batched \
        else csd_spmm.csd_spmm_fwd_quant_cuda
    kw = dict(bias=bias, activation=activation, w_scale=s)
    plan = capture_launch(fn, x, q, idx.cpu(), n_sm=launch.sm_count(x.device),
                          **kw)
    (ln,) = plan.launches
    want = "wgmma" if case.startswith("wgmma") else "stream"
    assert want in ln.kernel, (case, ln.kernel)
    n0 = counter.launches
    first, second = fn(x, q, idx, **kw), fn(x, q, idx, **kw)
    ref = (csd_spmm.csd_spmm_fwd_batched_plain if batched
           else csd_spmm.csd_spmm_fwd_plain)(x, q, idx, **kw)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert first.shape == x.shape[:-1] + (bp.n_out,)
    assert not bool(torch.isnan(first).any())
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))
    _quant_close(first, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("case", ["stream_m4", "stream_e3_m4"])
def test_csd_spmm_quant_stream_cluster_sizes(cuda_device, case, cluster,
                                             nan_outputs):
    """The stream body with its cluster forced to 1, 2, 3 or 8 CTAs (no
    larger than the fan-in): rank 0 adds the ranks' sums, every element is
    written, within the bf16 tolerance, two runs bit-equal."""
    from repro_torch.kernels import launch
    bp, x, q, s, idx, bias = _quant_case(cuda_device, case, torch.bfloat16,
                                         True)
    cluster = min(cluster, bp.d_in_b)
    e = x.shape[0] if x.dim() == 3 else 1
    rule = launch.quant_body("bfloat16", e, x.shape[-2], bp.n_rb, bp.d_in_b,
                             bp.block_out, launch.sm_count(x.device))
    fn = csd_spmm.csd_spmm_fwd_batched_cuda if x.dim() == 3 \
        else csd_spmm.csd_spmm_fwd_cuda
    kw = dict(bias=bias, activation="gelu", w_scale=s)
    with launch.forced_body(rule[:3] + (cluster,)):
        first, second = fn(x, q, idx, **kw), fn(x, q, idx, **kw)
    ref = (csd_spmm.csd_spmm_fwd_batched_plain if x.dim() == 3
           else csd_spmm.csd_spmm_fwd_plain)(x, q, idx, **kw)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(first).any())
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))
    _quant_close(first, ref, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stream_m4", "wgmma_e3_m300"])
def test_csd_spmm_quant_f32_grid_body_matches_plain(cuda_device, case):
    """f32 x keeps the grid body: within 1e-4 of max |plain|."""
    bp, x, q, s, idx, bias = _quant_case(cuda_device, case, torch.float32,
                                         True)
    fn = csd_spmm.csd_spmm_fwd_batched_cuda if x.dim() == 3 \
        else csd_spmm.csd_spmm_fwd_cuda
    kw = dict(bias=bias, activation="gelu", w_scale=s)
    got = fn(x, q, idx, **kw)
    ref = (csd_spmm.csd_spmm_fwd_batched_plain if x.dim() == 3
           else csd_spmm.csd_spmm_fwd_plain)(x, q, idx, **kw)
    torch.cuda.synchronize()
    _quant_close(got, ref, torch.float32)


# (G, Dh, page size) of the tensor-core form (bf16 q over bf16 or int8
# pages, G 5 to 48): qwen2-7b's 7, a group of 12 and granite-34b's 48 at Dh
# 128 with 16-key pages (TMA), 12-key pages (cp.async) and 32-key ones; G
# 48 also at Dh 256 (two slices of the output's head dims)
MMA_GEOMETRIES = [(7, 128, 16), (12, 128, 16), (48, 128, 16),
                  (7, 128, 12), (48, 128, 12), (12, 128, 32),
                  (48, 256, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window,softcap", [(None, None), (70, 50.0)])
@pytest.mark.parametrize("table_keys", PAGED_TABLE_KEYS)
@pytest.mark.parametrize("g,dh,page", MMA_GEOMETRIES)
def test_paged_decode_mma_cuda_matches_plain(cuda_device, g, dh, page,
                                             table_keys, window, softcap,
                                             quant):
    """The tensor-core form (``paged_decode_mma_kernel``, picked by the
    rule) through ``paged_decode_attention_cuda`` in one launch and in
    splits, bf16 q over bf16 or int8 pages, against the plain version at
    the bf16 gate; the same call on the CUDA-core form forced agrees too."""
    from repro_torch.kernels import launch
    from repro_torch.serving.kv_cache import quantize_kv
    case = _paged_case(b=4, hkv=1 if g == 48 else 2, g=g, dh=dh, page=page,
                       table_keys=table_keys, window=window)
    q = _t(case[0]).to(cuda_device, torch.bfloat16)
    kw = dict(window=window, softcap=softcap)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(_t(case[1])), quantize_kv(
            _t(case[2]))
        kp, vp = kp.to(cuda_device), vp.to(cuda_device)
        kw.update(k_scale=ks.to(cuda_device), v_scale=vs.to(cuda_device))
    else:
        kp, vp = (_t(a).to(cuda_device, torch.bfloat16) for a in case[1:3])
    table, lengths = (_t(a).to(cuda_device) for a in case[3:])
    forms = flash_attention.PAGED_FORM_LAUNCHES
    n0 = forms["paged_decode_mma_kernel"]
    got = flash_attention.paged_decode_attention_cuda(q, kp, vp, table,
                                                      lengths, **kw)
    with launch.forced_paged_form("cores"):
        cores = flash_attention.paged_decode_attention_cuda(
            q, kp, vp, table, lengths, **kw)
    ref = flash_attention.paged_decode_attention_plain(q, kp, vp, table,
                                                       lengths, **kw)
    torch.cuda.synchronize()
    assert forms["paged_decode_mma_kernel"] == n0 + 1
    for out in (got, cores):
        np.testing.assert_allclose(out.float().cpu(), ref.float().cpu(),
                                   atol=1e-2, rtol=1e-2)
    assert (got[2] == 0).all()  # the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g", [7, 12, 48])
def test_paged_decode_mma_nan_filled_repeatable(cuda_device, g, quant,
                                                nan_outputs):
    """The tensor-core form at a shape the split rule cuts, into NaN-filled
    outputs and partials: one CTA per (split, KV head, row) for the whole
    group, every element written, within tolerance of plain, two runs
    bit-equal."""
    from repro_torch.analysis.capture import capture_launch
    from repro_torch.serving.kv_cache import quantize_kv
    q, kp, vp, table, lengths = _paged_case(hkv=2, g=g, dh=128,
                                            table_keys=1040, window=300)
    q = _t(q).to(cuda_device, torch.bfloat16)
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(_t(kp)), quantize_kv(_t(vp))
        kw = dict(k_scale=ks.to(cuda_device), v_scale=vs.to(cuda_device))
        kp, vp = kp.to(cuda_device), vp.to(cuda_device)
    else:
        kw = {}
        kp, vp = (_t(a).to(cuda_device, torch.bfloat16) for a in (kp, vp))
    table, lengths = (_t(a).to(cuda_device) for a in (table, lengths))
    kw.update(window=300, softcap=50.0)
    args = (q, kp, vp, table, lengths)
    plan = capture_launch(flash_attention.paged_decode_attention_cuda,
                          *args, **kw)
    split = plan.launches[0]
    assert plan.n_splits > 1 and split.kernel == "paged_decode_mma_kernel"
    assert split.grid == (plan.n_splits, 2, 4)
    first, second = (flash_attention.paged_decode_attention_cuda(*args, **kw)
                     for _ in range(2))
    torch.cuda.synchronize()
    ref = flash_attention.paged_decode_attention_plain(*args, **kw)
    assert not bool(torch.isnan(first).any())
    assert torch.equal(first.view(torch.uint8), second.view(torch.uint8))
    np.testing.assert_allclose(first.float().cpu(), ref.float().cpu(),
                               atol=1e-2, rtol=1e-2)
    assert (first[2] == 0).all()


@pytest.mark.cuda
def test_verify_step_on_the_card_matches_plain(cuda_device):
    """One speculative verify step at the gemma3 smoke shape (4 slots, a
    chunk of 1 + 4 positions, rows with n_new 5, 3, 1 and 0) on the card
    against the same step on the CPU (the plain versions) from the same
    weights and cache: the logits at every valid position within 1e-4 of
    max |plain| (f32), exactly 3 launches of the small-block forward a
    layer and no paged decode."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.nn.model import LM
    cfg = get_config("gemma3_4b", smoke=True)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    b, page, c = 4, 16, 5
    table = torch.arange(b * 3, dtype=torch.int32).reshape(b, 3)
    lens = torch.tensor([20, 11, 17, 0], dtype=torch.int32)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 20)))
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, c)))
    n_new = torch.tensor([5, 3, 1, 0], dtype=torch.int32)
    cache = model.init_paged_cache(b * 3, page, torch.float32, "cpu")
    model.paged_step(prompt, torch.zeros(b, dtype=torch.int32), lens, cache,
                     table)
    dev_model = copy.deepcopy(model).to(cuda_device)
    dev_cache = [{k: v.to(cuda_device) for k, v in cc.items()}
                 for cc in cache]
    ref = model.paged_step(chunk, lens, n_new, cache, table, all_logits=True)
    fwd = csd_spmm.csd_spmm_fwd_small_cuda
    paged = flash_attention.paged_decode_attention_cuda
    fwd.launches = paged.launches = 0
    got = dev_model.paged_step(chunk.to(cuda_device), lens.to(cuda_device),
                               n_new.to(cuda_device), dev_cache,
                               table.to(cuda_device), all_logits=True)
    torch.cuda.synchronize()
    assert (fwd.launches, paged.launches) == (3 * cfg.n_layers, 0)
    assert got.shape == ref.shape == (b, c, cfg.vocab_size)
    valid = torch.arange(c)[None] < n_new[:, None]
    err = (got.cpu()[valid] - ref[valid]).abs().max()
    assert err <= 1e-4 * ref[valid].abs().max()
