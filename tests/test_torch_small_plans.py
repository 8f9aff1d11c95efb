"""The launch plans of the small-block forms (``kernels/launch.py``:
``small_block``, ``fwd_small_plan``, ``dx_small_plan``, ``dw_small_plan``)
and of the mask kernel with its tail, captured from the real wrappers on
the CPU and certified by the port's sparselint grid pass (one writer per
output element and no hole, masked edges, the epilogue after the last
slot, shared memory within the H100's opt-in, every read inside its
buffer): at the paper MLP's junctions (also at 8000 rows), the LM smoke
configurations' 16 x 16 blocks, ragged M, three experts and blocks wider
than 64; with the geometry rules (``small_gather_split``,
``small_dw_cluster``), the dw kernel's slabs by input block
(``small_dw_items``) and the forced splits (``forced_small_split``)."""
import numpy as np
import pytest
import torch

from repro_torch.analysis import grid_pass
from repro_torch.core.block_pattern import make_block_pattern
from repro_torch.kernels import launch

F32, BF16 = torch.float32, torch.bfloat16

# (n_in, n_out, bL, bR, rho)
JUNCTIONS = [(800, 100, 16, 4, 0.2), (100, 100, 4, 4, 0.8),
             (39, 390, 1, 2, 0.2), (390, 39, 2, 1, 0.2),
             (100, 40, 4, 10, 0.5), (64, 256, 16, 16, 0.5),
             (128, 300, 32, 100, 0.5), (300, 128, 100, 32, 0.5),
             (128, 320, 128, 160, 0.5)]


def _cases():
    out = []
    for n_in, n_out, bl, br, rho in JUNCTIONS:
        bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br)
        tag = f"{bl}x{br}"
        for m, experts, dt in ((1, None, F32), (77, None, BF16),
                               (256, None, F32), (40, 3, BF16)):
            t = f"{tag}/m{m}" + ("" if experts is None else f"_e{experts}")
            out += [
                grid_pass._fwd_case(f"{t}/fwd_gelu_preact_bias", bp, m, dt,
                                    experts=experts, activation="gelu",
                                    bias=True, save_preact=True),
                grid_pass._dx_case(f"{t}/dx", bp, m, dt, experts=experts),
                grid_pass._dw_case(f"{t}/dw_db", bp, m, dt, experts=experts,
                                   want_db=True),
            ]
    for rows, n_out in ((256, 100), (77, 390), (33, 39), (3, 13), (1, 1)):
        for dt in (F32, BF16):
            out.append(grid_pass._mask_case(f"mask/{rows}x{n_out}/{dt}",
                                            rows, n_out, dt,
                                            activation="relu"))
    return out


CASES = {c.name: c for c in _cases() + grid_pass.small_block_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_small_block_plan_is_certified_clean(name):
    plan = CASES[name].build()
    findings, cost = grid_pass.analyze_plan(plan, name)
    assert findings == [], [f.message for f in findings]
    assert plan.launches
    for ln in plan.launches:
        assert 0 < ln.smem <= launch.SMEM_OPTIN or ln.kernel.startswith(
            "csd_mask")
        assert ln.n_ctas > 0
    assert cost["ctas"] == [ln.n_ctas for ln in plan.launches]
    if plan.name != "csd_mask_cotangent":
        assert plan.name.endswith("_small")


@pytest.mark.parametrize("bl,br,small", [
    (16, 4, True), (4, 4, True), (1, 2, True), (2, 1, True), (4, 10, True),
    (16, 16, True), (64, 32, True), (100, 128, True), (64, 64, False),
    (128, 256, False), (256, 1024, False), (256, 512, False)])
def test_small_block_rule(bl, br, small):
    """Every block whose bL or bR is not a multiple of 64 runs the
    small-block forms; multiples of 64 keep their bodies (the plans of the
    full-width kernels)."""
    assert launch.small_block(bl, br) == small
    bp = make_block_pattern(4 * bl, 4 * br, 0.5, block_in=bl, block_out=br)
    names = {grid_pass._fwd_case("f", bp, 64, BF16).build().name,
             grid_pass._dx_case("d", bp, 64, BF16).build().name,
             grid_pass._dw_case("w", bp, 64, BF16).build().name}
    want = {"csd_spmm_fwd_small", "csd_spmm_dx_small", "csd_spmm_dw_small"}
    assert names == want if small \
        else names == {"csd_spmm_fwd", "csd_spmm_dx", "csd_spmm_dw"}


# (E, M, n_ob, ow, iw, in_cols, n_slots, itemsize) -> the rule's (rows,
# groups, ks, stages, y) on the H100's 132 SMs
GATHER = {
    # Table I's forward at the training set: 32-row tiles (two stages fit),
    # the whole output width a CTA
    "table1_fwd_m8000": ((1, 8000, 25, 4, 16, 800, 10, 4), (32, 1, 2, 1, 250)),
    # CIFAR's forward: 8-row tiles, one stage of 160 KB (16 rows would not
    # fit twice), persistent over the tiles, the fan-in whole (the spare
    # threads would only double in an 8-row tile)
    "cifar_fwd_m8000": ((1, 8000, 125, 4, 16, 4000, 50, 4), (8, 1, 1, 1, 132)),
    # CIFAR's dx: 32-row tiles of g, the 4000 outputs over ranges
    "cifar_dx_m8000": ((1, 8000, 250, 16, 4, 500, 25, 4), (32, 16, 1, 1, 17)),
    # Table I's dx: 64-row tiles, a ring
    "table1_dx_m8000": ((1, 8000, 50, 16, 4, 100, 5, 4), (64, 7, 1, 3, 38)),
    # the batch: 8-row tiles, the output ranges split to fill the card
    "table1_fwd_m256": ((1, 256, 25, 4, 16, 800, 10, 4), (8, 2, 10, 1, 32)),
    "cifar_fwd_m256": ((1, 256, 125, 4, 16, 4000, 50, 4), (8, 8, 13, 1, 17)),
    # one output column a block, 40 slots: the fan-in over ranks
    "timit_dx_m256": ((1, 256, 39, 1, 2, 390, 40, 4), (8, 4, 20, 1, 32)),
    # the smoke down forward at a decode step's 4 rows: one tile, the
    # fan-in of 12 slots over ranks
    "smoke_down_fwd_m4": ((1, 4, 4, 16, 16, 256, 12, 4), (8, 2, 12, 1, 1)),
    # granite's 8 experts of 24 rows, bf16
    "granite_up_fwd_e8": ((8, 24, 2, 16, 16, 64, 2, 2), (8, 1, 2, 1, 3)),
}


@pytest.mark.parametrize("name", list(GATHER))
def test_gather_geometry(name):
    """The rule's geometry (``small_gather_split``): at most 256 threads of
    8 rows x CW columns x a fan-in rank; output ranges that cover the
    output; every fan-in rank owning a slot; the stage the larger of the
    staged rows and the ranks' partial sums; the ring within the H100's
    opt-in shared memory; at most one persistent CTA a tile."""
    (e, m, n_ob, ow, iw, in_cols, n_slots, size), want = GATHER[name]
    sp = launch.small_gather_split(e, m, n_ob, ow, iw, in_cols, n_slots,
                                   size, launch.H100_SMS)
    cw = launch.small_column_group(ow)
    n_cg = n_ob * ow // cw
    nrg = sp.rows // 8
    assert sp.rows in (8, 16, 32, 64) and sp.rows <= max(8, -(-m // 8) * 8)
    assert nrg * sp.ncg * sp.ks <= 256
    assert sp.groups == -(-n_cg // sp.ncg) and sp.groups * sp.ncg >= n_cg
    per = -(-n_slots // sp.ks)
    assert 1 <= sp.ks <= n_slots and (sp.ks - 1) * per < n_slots
    rs = launch.small_gather_rs(in_cols, iw, size, sp.rows)
    assert (rs * size) % 128 == 16
    bs = launch.small_block_stride(iw, size, sp.rows)
    assert rs >= in_cols // iw * bs and bs >= iw
    if sp.rows == 8 and (iw * size) % 32 == 0:  # one row a warp: padded
        assert (bs * size // 16) % 2 == 1
    elif sp.rows > 8:
        assert bs == iw
    x = sp.rows * rs * size
    red = 4 * sp.ks * sp.rows * sp.ncg * cw if sp.ks > 1 else 0
    stage = launch.small_gather_stage(in_cols, iw, size, sp.rows,
                                      sp.ncg * cw, sp.ks)
    assert stage == -(-max(x, red) // 16) * 16
    assert 1 <= sp.stages <= 3 and sp.stages * stage <= launch.SMEM_OPTIN
    assert 1 <= sp.y <= -(-m // sp.rows)
    assert sp.stages <= -(-(-(-m // sp.rows)) // sp.y)
    if want is not None:
        assert (sp.rows, sp.groups, sp.ks, sp.stages, sp.y) == want


@pytest.mark.parametrize("in_cols,iw,size,fits", [
    (4000, 16, 4, True), (5760, 16, 4, True), (5824, 16, 4, False),
    (7200, 4, 4, True), (7300, 4, 4, False), (14000, 2, 2, True),
    (15000, 2, 2, False)])
def test_gather_width_limit(in_cols, iw, size, fits):
    """The widest input the gather kernel stages: 8 rows in 227 KB (blocks
    of 16 f32 padded to 20)."""
    assert launch.small_gather_fits(in_cols, iw, size) == fits


# (E, M, n_lb, bL, bR, itemsize) -> the rule's M split, the thread tile
# and the slabs a batch
DW = {
    "table1_m8000": ((1, 8000, 50, 16, 4, 4), (4, 16, 4, 256)),
    "cifar_m8000": ((1, 8000, 250, 16, 4, 4), (1, 16, 4, 256)),
    "table1_m256": ((1, 256, 50, 16, 4, 4), (4, 16, 4, 256)),
    "mnist4j_m256": ((1, 256, 25, 4, 4, 4), (8, 4, 4, 256)),
    "timit_in_m256": ((1, 256, 39, 1, 2, 4), (4, 1, 2, 256)),
    "timit_out_m256": ((1, 256, 195, 2, 1, 4), (1, 2, 1, 256)),
    "smoke_gate_m64": ((1, 64, 4, 16, 16, 4), (4, 16, 4, 64)),
    "granite_up_e8": ((8, 24, 4, 16, 16, 2), (1, 16, 4, 64)),
    "wide_128x160": ((1, 77, 1, 128, 160, 2), (4, 16, 4, 1)),
}


@pytest.mark.parametrize("name", list(DW))
def test_dw_geometry(name):
    """The dw kernel's geometry: a TI x TJ tile that divides the block (at
    most 64 outputs a thread), batches of at most 256 tiles (or one slab),
    the M split over at most 8 ranks, each keeping rows; the phases' sums
    and one stage row within the ring, the ring within the opt-in."""
    (e, m, n_lb, bl, br, size), want = DW[name]
    ti, tj = launch.small_dw_tile(bl, br)
    assert bl % ti == 0 and br % tj == 0 and ti * tj <= 64
    tp = (bl // ti) * (br // tj)
    qg = launch.small_dw_batch(bl, br)
    assert qg * tp <= 256 or qg == 1
    c = launch.small_dw_cluster(e, m, n_lb, launch.H100_SMS)
    assert c in (1, 2, 4, 8)
    assert c == 1 or (m // c >= launch._DW_MIN_ROWS
                      and e * n_lb * c <= 2 * launch.H100_SMS)
    if c < 8:  # the next cluster breaks a limit
        assert m // (2 * c) < launch._DW_MIN_ROWS \
            or e * n_lb * 2 * c > 2 * launch.H100_SMS
    assert launch.small_dw_fits(bl, br, size)
    ring = launch._DW_STAGES * launch._DW_STAGE_BYTES
    assert 256 * (ti * tj + tj) * 4 <= ring
    assert launch._DW_HEADER + ring <= launch.SMEM_OPTIN
    if want is not None:
        assert (c, ti, tj, qg) == want


@pytest.mark.parametrize("cluster", [1, 3, 8])
@pytest.mark.parametrize("bl,br,pattern", [
    (16, 4, "table1"), (16, 16, "smoke"), (128, 160, "wide"),
    (4, 4, "irregular")])
def test_dw_items_partition(bl, br, pattern, cluster):
    """The dw CTAs' tiles (``small_dw_items``, what the plan says each
    writes) cover every (slab, tile) once over the left blocks and the
    ranks, also where the fan-out varies from block to block."""
    rng = np.random.default_rng(1)
    if pattern == "irregular":
        n_lb, idx = 9, rng.integers(0, 9, size=(7, 5))
    else:
        bp = make_block_pattern(
            {"table1": 800, "smoke": 256, "wide": 256}[pattern],
            {"table1": 100, "smoke": 64, "wide": 320}[pattern], 0.5,
            block_in=bl, block_out=br)
        n_lb, idx = bp.n_lb, bp.block_idx
    ti, tj = launch.small_dw_tile(bl, br)
    got = [it for lb in range(n_lb) for r in range(cluster)
           for it in launch.small_dw_items(idx, lb, bl, br, cluster, r)]
    want = [(f, a, b) for f in range(idx.size) for a in range(bl // ti)
            for b in range(br // tj)]
    assert sorted(got) == want


@pytest.mark.parametrize("gather,dw", [(2, 2), (8, 8), (4, None)])
def test_forced_splits_certified(gather, dw):
    """The splits the sweep forces (the gather kernel's fan-in ranks, the
    dw kernel's cluster): the plans take them, clamped to the slots and
    the threads (and for dw to M), stay clean, and the rules return
    after."""
    from repro_torch.configs import paper_mlp as pm
    from repro_torch.nn.mlp import mlp_patterns
    bp = mlp_patterns(pm.MNIST_2J, pm.rho_from_dout(pm.MNIST_2J,
                                                     (20, 10)))[0]
    cases = [grid_pass._fwd_case("f", bp, 8001, F32, activation="relu",
                                 bias=True),
             grid_pass._dx_case("d", bp, 8001, F32),
             grid_pass._dw_case("w", bp, 8001, F32, want_db=True)]
    before = [c.build().args for c in cases]
    with launch.forced_small_split(gather=gather, dw=dw):
        for c in cases:
            plan = c.build()
            assert grid_pass.analyze_plan(plan, c.name)[0] == []
            if plan.name == "csd_spmm_dw_small":
                assert plan.args["cluster"] == (dw or before[2]["cluster"])
                continue
            # the forced ranks, within the slots and the spare threads, each
            # rank owning a slot
            a = plan.args
            room = min(a["n_slots"], 256 // (a["R"] // 8 * a["ncg"]))
            want = max(1, min(gather, room))
            assert a["ks"] == -(-a["n_slots"] // -(-a["n_slots"] // want))
    assert [c.build().args for c in cases] == before


def test_mask_tail_plan():
    """Whole 16-byte chunks one a thread, then the tail's elements one a
    thread: 33 x 39 f32 elements are 321 chunks and 3 more."""
    plan = launch.mask_plan(33, 39, "float32")
    (ln,) = plan.launches
    assert ln.grid == (2, 1, 1)  # 324 threads
    assert grid_pass.analyze_plan(plan, "mask")[0] == []
