"""The int8 forward's launch plans (``kernels/launch.py``: ``fwd_plan`` with
``quant``, its weight-streaming body ``_fwd_quant_stream_launch``, the
wgmma body over int8 tiles, and the rules ``quant_body`` and
``stream_cluster``), captured from the real wrappers on the CPU and
certified by the port's sparselint grid pass: one writer per output
element and no hole (SL101), tiles that divide their extents or are masked
and clusters that tile their grid (SL102), the epilogue after every fan-in
slot (SL103), shared memory within the H100's 227 KiB opt-in (SL104) and
every read inside its buffer (SL105), at gemma3-4b's and
granite-moe-1b-a400m's decode and prefill shapes, at ragged M, three
experts and bL / bR of 64, 128 and 256."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import grid_pass
from repro_torch.analysis.capture import capture_launch
from repro_torch.configs import get_config, granite_moe_1b_a400m
from repro_torch.kernels import csd_spmm, launch

BF16, F32 = torch.bfloat16, torch.float32
STREAM = "csd_spmm_fwd_quant_stream_kernel"
WGMMA = "csd_spmm_fwd_wgmma_kernel"
GRID = "csd_spmm_fwd_quant_kernel"


def _gemma3():
    gp = grid_pass._layer0_patterns(get_config("gemma3_4b"))
    return gp["ffn.gate.pattern"], gp["ffn.down.pattern"]


def _granite():
    cfg = granite_moe_1b_a400m.card_config()
    rp = grid_pass._layer0_patterns(cfg)
    return cfg.moe.n_routed, rp["ffn.up_pat"], rp["ffn.down_pat"]


def _model_cases():
    gate, down = _gemma3()
    e, up, edown = _granite()
    fwd = grid_pass._fwd_case
    out = []
    for m in (4, 16, 32, 64, 128, 256):
        out += [fwd(f"gemma3/gate_gelu_m{m}", gate, m, BF16,
                    activation="gelu", quant=True),
                fwd(f"gemma3/down_m{m}", down, m, BF16, quant=True),
                fwd(f"granite/up_c{m}", up, m, BF16, experts=e, quant=True),
                fwd(f"granite/down_c{m}", edown, m, BF16, experts=e,
                    quant=True)]
    return out


def _small_cases():
    fwd = grid_pass._fwd_case
    out = []
    for bl, br in ((64, 64), (128, 128), (128, 256), (256, 128),
                   (256, 256), (64, 256)):
        bp = grid_pass._demo_pattern(block_in=bl, block_out=br)
        for m in (1, 5, 33, 77, 300):
            out.append(fwd(f"bl{bl}_br{br}/m{m}", bp, m, BF16,
                           activation="gelu", bias=True, quant=True))
        out.append(fwd(f"bl{bl}_br{br}/e3_m40", bp, 40, BF16, experts=3,
                       activation="relu", bias=True, quant=True))
        out.append(fwd(f"bl{bl}_br{br}/e3_m300", bp, 300, BF16, experts=3,
                       bias=True, quant=True))
    bp = grid_pass._demo_pattern()
    out += [fwd(f"f32/m{m}", bp, m, F32, bias=True, quant=True)
            for m in (1, 77, 300)]
    return out


CASES = {c.name: c for c in _model_cases() + _small_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_quant_plan_is_certified_clean(name):
    plan = CASES[name].build()
    findings, cost = grid_pass.analyze_plan(plan, name)
    assert findings == [], [f.message for f in findings]
    assert all(ln.smem <= launch.SMEM_OPTIN for ln in plan.launches)
    assert sum(cost["ctas"]) == sum(ln.n_ctas for ln in plan.launches) > 0


@pytest.mark.parametrize("name", [c.name for c in _model_cases()
                                  if c.name.endswith(("m4", "c4"))])
def test_decode_is_one_launch_of_the_stream_body(name):
    """Every decode call of the two models is one launch of the stream
    body: no split partial sums, no second pass."""
    plan = CASES[name].build()
    (ln,) = plan.launches
    assert ln.kernel == STREAM and plan.n_splits == 1
    assert "partial" not in plan.buffers
    assert plan.args["body"] == launch.BODY_STREAM
    assert ln.cluster == (plan.args["cluster"], 1, 1)


@pytest.mark.parametrize("what,e,m,n_rb,d_in_b,br,want", [
    ("gemma3 gate decode", 1, 4, 10, 5, 1024, (1, 16, 128, 3)),
    ("gemma3 down decode", 1, 4, 5, 32, 512, (1, 16, 128, 8)),
    ("gemma3 gate M 16", 1, 16, 10, 5, 1024, (1, 16, 128, 3)),
    ("gemma3 gate M 32", 1, 32, 10, 5, 1024, (1, 32, 128, 3)),
    ("gemma3 gate M 48", 1, 48, 10, 5, 1024, (2, 128, 128, 1)),
    ("gemma3 down M 64", 1, 64, 5, 32, 512, (1, 64, 128, 8)),
    ("gemma3 gate M 256", 1, 256, 10, 5, 1024, (2, 128, 128, 1)),
    ("gemma3 down M 128", 1, 128, 5, 32, 512, (2, 128, 64, 1)),
    ("gemma3 down M 256", 1, 256, 5, 32, 512, (2, 128, 64, 1)),
    ("granite up decode", 32, 4, 2, 4, 256, (1, 16, 128, 1)),
    ("granite down decode", 32, 4, 4, 3, 256, (1, 16, 128, 1)),
    ("granite up C 32", 32, 32, 2, 4, 256, (1, 32, 128, 1)),
    ("granite up C 64", 32, 64, 2, 4, 256, (2, 128, 128, 1)),
    ("granite down C 256", 32, 256, 4, 3, 256, (2, 128, 128, 1)),
    ("bR 64 decode", 1, 4, 8, 4, 64, (2, 128, 64, 1)),
    ("bR 192 decode", 1, 4, 4, 4, 192, (2, 128, 64, 1)),
])
def test_body_rule(what, e, m, n_rb, d_in_b, br, want):
    """The body, row tile, width and cluster of each shape
    ``tools/time_quant.py --bodies`` and ``--splits`` timed, as the rule
    picks them on 132 SMs: the stream body up to 32 rows per expert, and
    up to 64 where the wgmma body's tiles would fill less than half the
    SMs (gemma3-4b's down junction); its cluster 1 from three tiles for
    every four SMs, else up to 8 ranks of whole slots; the wgmma body
    otherwise, and wherever 128 does not divide bR; f32 the grid body."""
    got = launch.quant_body("bfloat16", e, m, n_rb, d_in_b, br,
                            launch.H100_SMS)
    assert got == want, what
    assert launch.quant_body("float32", e, m, n_rb, d_in_b, br,
                             launch.H100_SMS)[0] == launch.BODY_GRID


@pytest.mark.parametrize("tiles,d_in_b,want", [
    (20, 32, 8),    # gemma3 down: 14 wanted, at most 8, 4 slots a rank
    (80, 5, 3),     # gemma3 up/gate: 4 wanted -> 2 slots a rank -> 3 ranks
    (128, 4, 1),    # granite up/gate: nearly an SM each
    (256, 3, 1),    # granite down
    (40, 2, 2),     # a fan-in of 2 caps the cluster
    (10, 1, 1),     # a fan-in of 1 cannot split
])
def test_stream_cluster(tiles, d_in_b, want):
    assert launch.stream_cluster(1, 128 * tiles, d_in_b,
                                 launch.H100_SMS) == want


@pytest.fixture
def force_quant():
    """``force_quant(body)``: the int8 forward's plans take ``body``
    ((body, tile_m, tile_n, cluster)) whatever ``launch.quant_body``
    picks, for the rest of the test (``launch.forced_body``)."""
    with contextlib.ExitStack() as stack:
        yield lambda body: stack.enter_context(launch.forced_body(body))


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("experts", [None, 3])
def test_cluster_split_writes_y_once_from_rank_0(cluster, experts,
                                                 force_quant):
    """The stream body with its fan-in (8 slots) split over clusters of 1
    to 8 CTAs: rank 0 alone writes y, each element once, its slots are the
    cluster's (the epilogue after every slot), the other ranks' slots
    partition the fan-in, and shared memory stays within the opt-in."""
    bp = grid_pass._demo_pattern(block_in=128, block_out=256, n_lb=16,
                                 n_rb=2, rho=0.5)
    assert bp.d_in_b == 8
    case = grid_pass._fwd_case("q", bp, 5, BF16, experts=experts,
                               activation="gelu", bias=True, quant=True)
    force_quant((launch.BODY_STREAM, 16, 128, cluster))
    plan = case.build()
    (ln,) = plan.launches
    e = experts or 1
    assert ln.grid == (cluster, bp.n_out // 128, e)
    assert ln.cluster == (cluster, 1, 1) and ln.threads == 160
    assert ln.smem == launch.stream_smem(16) <= launch.SMEM_OPTIN
    ctas = ln.ctas()
    (y,) = ln.writes(ctas)
    writes = (y.hi > y.lo).all(1)
    assert np.array_equal(writes, ctas[:, 0] == 0)
    lo, hi = ln.slots(ctas)
    first = ctas[:, 0] == 0
    assert (lo[first] == 0).all() and (hi[first] == bp.d_in_b).all()
    tile = (ctas[:, 1] == 0) & (ctas[:, 2] == 0)  # one tile's ranks
    per = -(-bp.d_in_b // cluster)
    own = sorted((int(r) * per, min(bp.d_in_b, int(r) * per + per))
                 for r in ctas[tile & ~first, 0])
    assert [s for a, b in own for s in range(a, b)] \
        == list(range(per, bp.d_in_b))
    assert grid_pass.analyze_plan(plan, "q")[0] == []


def test_a_cluster_that_does_not_tile_the_grid_is_flagged(force_quant):
    """SL102 sees a cluster the grid cannot be cut into."""
    import dataclasses
    bp = grid_pass._demo_pattern(block_in=128, block_out=128)
    case = grid_pass._fwd_case("q", bp, 5, BF16, quant=True)
    force_quant((launch.BODY_STREAM, 16, 128, 2))
    plan = case.build()
    (ln,) = plan.launches
    bad = dataclasses.replace(plan, launches=(
        dataclasses.replace(ln, cluster=(3, 1, 1)),))
    codes = [f.code for f in grid_pass.analyze_plan(bad, "q")[0]]
    assert codes == ["SL102"]


@pytest.mark.parametrize("tile_m,smem", [
    (16, 6 * (16 * 128 + 64 * 128) + 1024 + 96),
    (32, 6 * (32 * 128 + 64 * 128) + 1024 + 96),
    (64, 4 * (64 * 128 + 64 * 128) + 1024 + 64),
])
def test_stream_shared_memory(tile_m, smem):
    """The stream body's ring (6 stages, 4 at 64 rows) of x and weight
    boxes, alignment and barriers: three CTAs fit an SM."""
    assert launch.stream_smem(tile_m) == smem
    assert 3 * smem <= 3 * launch.SMEM_OPTIN


@pytest.mark.parametrize("bn,smem", [
    (64, 4 * (128 * 2 + 64) * 64 + 3 * 64 * 64 * 2 + 2 * 2 * 64 * 64 * 2
     + 1024 + 64),
    (128, 4 * (128 * 2 + 128) * 64 + 3 * 128 * 64 * 2
     + 2 * 2 * 64 * 128 * 2 + 1024 + 64),
])
def test_int8_wgmma_shared_memory(bn, smem):
    """The int8 wgmma body: the ring of bf16 x and int8 w tiles, three
    widened bf16 tiles, the staging tiles, alignment and barriers."""
    assert launch.fwd_wgmma_smem(bn, quant=True) == smem \
        <= launch.SMEM_OPTIN


def test_stream_body_refuses_a_split():
    bp = grid_pass._demo_pattern()
    with pytest.raises(ValueError, match="does not split"):
        launch.fwd_plan(1, 4, bp.n_in, bp.n_rb, bp.d_in_b, 128, 128,
                        "bfloat16", has_bias=False, save_preact=False,
                        quant=True, n_sm=132, n_splits=2)


def test_wrapper_passes_the_plan_to_the_library():
    """The arguments the wrapper gives the C entry point are the plan's:
    captured, the plan names its body, tiles and cluster, and the library's
    plan export takes exactly those names."""
    _, down = _gemma3()
    case = grid_pass._fwd_case("d", down, 4, BF16, quant=True)
    (x, w, idx), kw = case.args("meta")
    plan = capture_launch(csd_spmm.csd_spmm_fwd_cuda, x, w, idx, **kw)
    names = launch.PLAN_EXPORTS[plan.name][2]
    assert set(names) <= set(plan.args)
    assert (plan.args["body"], plan.args["tile_m"], plan.args["tile_n"],
            plan.args["cluster"]) == (launch.BODY_STREAM, 16, 128, 8)
    assert plan.dims() == [((8, 20, 1), 160, launch.stream_smem(16), 8)]
