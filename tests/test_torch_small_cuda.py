"""The small-block forms of the junction kernels (``csrc/csd_spmm_small.cu``:
the forward, the int8 forward and dx) and the mask kernel's tail against
their plain versions, on the card.

These tests carry the ``cuda`` marker and skip where there is no card; they
import neither JAX nor the JAX package, so they run on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_small_cuda.py

Tolerances: f32 1e-4 and bf16 1e-2 of max |plain| (sums in another order;
bf16 one rounding of each output on top; the int8 gates are the same), the
mask equal element for element.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.block_pattern import make_block_pattern
from repro_torch.core.quant import quantize_slab
from repro_torch.kernels import csd_spmm, launch
from repro_torch.kernels.ops import csd_matmul

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (n_in, n_out, bL, bR, rho): the paper MLP's junctions (Table I's 16 x 4,
# Table II's 4 x 4, TIMIT's 1 x 2 and 2 x 1), a 4 x 10 block, the smoke
# configurations' 16 x 16, and blocks wider than 64 that are not multiples
# of it (64-column chunks)
SMALL_JUNCTIONS = [(800, 100, 16, 4, 0.2), (100, 100, 4, 4, 0.8),
                   (39, 390, 1, 2, 0.2), (390, 39, 2, 1, 0.2),
                   (100, 40, 4, 10, 0.5), (64, 256, 16, 16, 0.5),
                   (128, 300, 32, 100, 0.5), (300, 128, 100, 32, 0.5)]
IDS = [f"{j[2]}x{j[3]}" for j in SMALL_JUNCTIONS]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(junction, m, experts, seed=0):
    n_in, n_out, bl, br, rho = junction
    rng = np.random.default_rng(seed)
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br)
    lead = () if experts is None else (experts,)
    x = rng.normal(size=lead + (m, n_in)).astype(np.float32)
    w = (rng.normal(size=lead + (bp.n_rb, bp.d_in_b, bl, br))
         / np.sqrt(bp.d_in_b * bl)).astype(np.float32)
    b = rng.normal(size=lead + (n_out,)).astype(np.float32)
    dy = rng.normal(size=lead + (m, n_out)).astype(np.float32)
    return bp, x, w, b, dy


def _to(dev, dtype, *arrays):
    return [torch.as_tensor(a).to(dev, dtype) for a in arrays]


def _pat(bp, dev):
    return {k: torch.as_tensor(getattr(bp, k), dtype=torch.int32, device=dev)
            for k in ("block_idx", "out_idx", "out_slot")}


def _close(got, ref, dtype):
    if isinstance(got, tuple):
        got = torch.cat([t.float().reshape(-1) for t in got])
        ref = torch.cat([t.float().reshape(-1) for t in ref])
    err = float((got.float() - ref.float()).abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= TOL[dtype] * float(ref.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("experts", [None, 3], ids=["4d", "5d"])
@pytest.mark.parametrize("junction", SMALL_JUNCTIONS, ids=IDS)
def test_small_forms_match_plain(cuda_device, junction, experts, dtype):
    """The forward (relu with bias; gelu with ``save_preact``), dx and dw
    (with db, on the masked cotangent) through the shipped wrappers, which
    send these blocks to the small-block forms; each launch counted on the
    small form's wrapper and not on the full-width one's."""
    bp, *arrays = _case(junction, 77, experts)
    x, w, b, dy = _to(cuda_device, dtype, *arrays)
    pat = _pat(bp, cuda_device)
    form = "" if experts is None else "_batched"
    fwd = getattr(csd_spmm, f"csd_spmm_fwd{form}_cuda")
    fwd_p = getattr(csd_spmm, f"csd_spmm_fwd{form}_plain")
    dx = getattr(csd_spmm, f"csd_spmm_dx{form}_cuda")
    dx_p = getattr(csd_spmm, f"csd_spmm_dx{form}_plain")
    dw = getattr(csd_spmm, f"csd_spmm_dw{form}_cuda")
    dw_p = getattr(csd_spmm, f"csd_spmm_dw{form}_plain")
    small = [csd_spmm.csd_spmm_fwd_small_cuda, csd_spmm.csd_spmm_dx_small_cuda,
             csd_spmm.csd_spmm_dw_small_cuda]
    n0 = [k.launches for k in small] + [fwd.launches, dx.launches,
                                        dw.launches]
    kb = dict(block_in=bp.block_in, block_out=bp.block_out)
    for kw in (dict(bias=b, activation="relu"),
               dict(bias=b, activation="gelu", save_preact=True)):
        _close(fwd(x, w, pat["block_idx"], **kw),
               fwd_p(x, w, pat["block_idx"], **kw), dtype)
    aux = fwd_p(x, w, pat["block_idx"], bias=b, activation="relu")
    _close(dx(dy, w, pat["out_idx"], pat["out_slot"], aux=aux,
              activation="relu"),
           dx_p(dy, w, pat["out_idx"], pat["out_slot"], aux=aux,
                activation="relu"), dtype)
    _close(dw(x, dy, pat["block_idx"], aux=aux, activation="relu",
              want_db=True, **kb),
           dw_p(x, dy, pat["block_idx"], aux=aux, activation="relu",
                want_db=True, **kb), dtype)
    torch.cuda.synchronize()
    assert [k.launches for k in small] == [n0[0] + 2, n0[1] + 1, n0[2] + 1]
    assert [fwd.launches, dx.launches, dw.launches] == n0[3:]


# forced splits: the gather kernel's fan-in over ranks of the CTA and the dw
# kernel's M over a cluster of CTAs (None: the rules' own picks)
SPLITS = [None, (4, 4), (8, 8)]
SPLIT_IDS = ["rule", "split4", "split8"]


@pytest.mark.cuda
@pytest.mark.parametrize("split", SPLITS, ids=SPLIT_IDS)
@pytest.mark.parametrize("m", [1, 33, 8000, 8001])
def test_small_forms_ragged_and_long_m(cuda_device, m, split):
    """Table I's junction at 1 row, 33 rows (a partial tile) and the
    full-set evaluation's 8000 rows (tall tiles, the ring, dw's M split
    over a cluster by the rule) and 8001 (the last tile and the last rank's
    rows ragged), f32; also with the fan-in forced over 4 and 8 ranks and
    M over clusters of 4 and 8."""
    bp, *arrays = _case(SMALL_JUNCTIONS[0], m, None, seed=m)
    x, w, b, dy = _to(cuda_device, torch.float32, *arrays)
    pat = _pat(bp, cuda_device)
    kb = dict(block_in=bp.block_in, block_out=bp.block_out)
    gather, dw = split or (None, None)
    with launch.forced_small_split(gather=gather, dw=dw):
        got = (csd_spmm.csd_spmm_fwd_small_cuda(x, w, pat["block_idx"],
                                                bias=b, activation="relu"),
               csd_spmm.csd_spmm_dx_small_cuda(dy, w, pat["out_idx"],
                                               pat["out_slot"]),
               csd_spmm.csd_spmm_dw_small_cuda(x, dy, pat["block_idx"],
                                               want_db=True, **kb))
    _close(got[0], csd_spmm.csd_spmm_fwd_plain(x, w, pat["block_idx"],
                                               bias=b, activation="relu"),
           torch.float32)
    _close(got[1], csd_spmm.csd_spmm_dx_plain(dy, w, pat["out_idx"],
                                              pat["out_slot"]),
           torch.float32)
    _close(got[2], csd_spmm.csd_spmm_dw_plain(x, dy, pat["block_idx"],
                                              want_db=True, **kb),
           torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("split", SPLITS, ids=SPLIT_IDS)
@pytest.mark.parametrize("junction", SMALL_JUNCTIONS[:4], ids=IDS[:4])
def test_small_forms_nan_filled_repeatable(cuda_device, junction, split,
                                           monkeypatch):
    """Outputs filled with NaN before each launch: every element written
    (no hole in a plan's tiling), and two runs bit-equal (fixed summation
    orders, no atomics), with the rules' splits and with the fan-in forced
    over 4 and 8 ranks and M over clusters of 4 and 8."""
    real = launch.run

    def nan_run(plan, buffers, call):
        for k, t in buffers.items():
            if t is not None and plan.buffers[k].role != "in":
                t.fill_(float("nan"))
        return real(plan, buffers, call)

    monkeypatch.setattr(launch, "run", nan_run)
    bp, *arrays = _case(junction, 70, 2)
    x, w, b, dy = _to(cuda_device, torch.bfloat16, *arrays)
    pat = _pat(bp, cuda_device)
    kb = dict(block_in=bp.block_in, block_out=bp.block_out)

    def once():
        y, z = csd_spmm.csd_spmm_fwd_small_cuda(
            x, w, pat["block_idx"], bias=b, activation="gelu",
            save_preact=True)
        dxv = csd_spmm.csd_spmm_dx_small_cuda(dy, w, pat["out_idx"],
                                              pat["out_slot"])
        dwv, db = csd_spmm.csd_spmm_dw_small_cuda(x, dy, pat["block_idx"],
                                                  want_db=True, **kb)
        return y, z, dxv, dwv, db

    gather, dw = split or (None, None)
    with launch.forced_small_split(gather=gather, dw=dw):
        a, c = once(), once()
    torch.cuda.synchronize()
    for u, v in zip(a, c):
        assert not bool(torch.isnan(u.float()).any())
        assert torch.equal(u.view(torch.uint8), v.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 100), (77, 390), (33, 39),
                                   (3, 5, 13)],
                         ids=["100", "390", "39", "3d"])
def test_mask_tail_equals_plain(cuda_device, shape, dtype):
    """The mask kernel at element counts that are not a multiple of its
    16-byte chunk: equal element for element."""
    rng = np.random.default_rng(7)
    dy, aux = (torch.as_tensor(rng.normal(size=shape).astype(np.float32) * 3)
               .to(cuda_device, dtype) for _ in range(2))
    for act in ("relu", "gelu"):
        got = csd_spmm.csd_mask_cotangent_cuda(dy, aux, act)
        assert torch.equal(got, csd_spmm.mask_cotangent(dy, aux, act))


@pytest.mark.cuda
@pytest.mark.parametrize("junction", SMALL_JUNCTIONS[:5], ids=IDS[:5])
def test_csd_matmul_gradients_small_blocks(cuda_device, junction):
    """``csd_matmul`` forward and all three gradients on the card against
    the same call on the CPU (the plain versions), f32."""
    bp, x, w, b, dy = _case(junction, 64, None, seed=3)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        xt, wt, bt = (torch.as_tensor(a, device=dev).requires_grad_()
                      for a in (x, w, b))
        pat = _pat(bp, dev)
        y = csd_matmul(xt, wt, pat["block_idx"], bias=bt, activation="relu",
                       out_idx=pat["out_idx"], out_slot=pat["out_slot"])
        y.backward(torch.as_tensor(dy, device=dev))
        outs.append([t.detach().cpu() for t in (y, xt.grad, wt.grad,
                                                 bt.grad)])
    for got, ref in zip(*outs):
        _close(got, ref, torch.float32)


def _nan_filled(monkeypatch):
    """Fill every output of each launch with NaN first."""
    real = launch.run

    def nan_run(plan, buffers, call):
        for k, t in buffers.items():
            if t is not None and plan.buffers[k].role != "in":
                t.fill_(float("nan"))
        return real(plan, buffers, call)

    monkeypatch.setattr(launch, "run", nan_run)


def _never_the_width_check(monkeypatch):
    """Fail if the full-width forward's shape check, which refuses blocks
    below 64, is reached."""
    def refuse(*a, **kw):
        raise AssertionError("_check_fwd_shapes reached")

    monkeypatch.setattr(csd_spmm, "_check_fwd_shapes", refuse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("experts", [None, 3], ids=["4d", "5d"])
@pytest.mark.parametrize("junction", SMALL_JUNCTIONS, ids=IDS)
def test_quant_small_matches_plain(cuda_device, junction, experts, dtype,
                                   monkeypatch):
    """The int8 small-block forward through the shipped int8 wrappers
    (``csd_spmm_fwd_cuda`` / ``_batched_cuda`` with ``w_scale``), with and
    without bias, relu and gelu: into NaN-filled outputs, two runs
    bit-equal, within the int8 gate of the plain version; each launch
    counted on ``csd_spmm_fwd_quant_small_cuda`` and none on the full-width
    int8 wrappers, and ``_check_fwd_shapes``'s refusal never reached."""
    _nan_filled(monkeypatch)
    _never_the_width_check(monkeypatch)
    bp, x, w, b, _ = _case(junction, 77, experts, seed=5)
    q, s = quantize_slab(torch.as_tensor(w))
    x, b = _to(cuda_device, dtype, x, b)
    q, s = q.to(cuda_device), s.to(cuda_device)
    idx = _pat(bp, cuda_device)["block_idx"]
    form = "" if experts is None else "_batched"
    fwd = getattr(csd_spmm, f"csd_spmm_fwd{form}_cuda")
    plain = getattr(csd_spmm, f"csd_spmm_fwd{form}_plain")
    full = getattr(csd_spmm, f"csd_spmm_fwd_quant{form}_cuda")
    small = csd_spmm.csd_spmm_fwd_quant_small_cuda
    n0 = (small.launches, full.launches)
    combos = (dict(bias=b, activation="relu"), dict(activation="gelu"),
              dict(bias=b))
    for kw in combos:
        a, c = (fwd(x, q, idx, w_scale=s, **kw) for _ in range(2))
        torch.cuda.synchronize()
        assert not bool(torch.isnan(a.float()).any())
        assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))
        _close(a, plain(x, q, idx, w_scale=s, **kw), dtype)
    assert (small.launches, full.launches) == (n0[0] + 2 * len(combos),
                                               n0[1])


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 4], ids=["rule", "split4"])
@pytest.mark.parametrize("m", [1, 33, 8000])
def test_quant_small_ragged_and_long_m(cuda_device, m, split, monkeypatch):
    """Table I's and CIFAR_MLP's int8 junctions (16 x 4; CIFAR's 4000-wide
    rows take the one-CTA register-resident form) at 1 row, a partial tile
    and the training set's 8000 rows, f32, with the rule's fan-in split and
    with it forced over 4 ranks."""
    _never_the_width_check(monkeypatch)
    for junction in (SMALL_JUNCTIONS[0], (4000, 500, 16, 4, 0.2)):
        bp, x, w, b, _ = _case(junction, m, None, seed=m)
        q, s = quantize_slab(torch.as_tensor(w))
        x, b = _to(cuda_device, torch.float32, x, b)
        q, s = q.to(cuda_device), s.to(cuda_device)
        idx = _pat(bp, cuda_device)["block_idx"]
        with launch.forced_small_split(gather=split):
            got = csd_spmm.csd_spmm_fwd_cuda(x, q, idx, w_scale=s, bias=b,
                                             activation="relu")
        _close(got, csd_spmm.csd_spmm_fwd_plain(
            x, q, idx, w_scale=s, bias=b, activation="relu"), torch.float32)
