"""The launch plans of the small-block forms (``kernels/launch.py``:
``small_block``, ``fwd_small_plan``, ``dx_small_plan``, ``dw_small_plan``)
and of the mask kernel with its tail, captured from the real wrappers on
the CPU and certified by the port's sparselint grid pass (one writer per
output element and no hole, masked edges, the epilogue after the last
slot, shared memory within the H100's opt-in, every read inside its
buffer): at the paper MLP's junctions, the LM smoke configurations' 16 x 16
blocks, ragged M, three experts and blocks wider than 64."""
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
    (ln,) = plan.launches
    assert ln.smem <= launch.SMEM_OPTIN
    assert sum(cost["ctas"]) == ln.n_ctas > 0
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


@pytest.mark.parametrize("n_ob,ow,k,want", [
    (25, 4, 160, (16, 1, 16, 2)),   # Table I: 16 blocks of 4 columns
    (39, 1, 80, (64, 1, 4, 1)),     # TIMIT out: 64 one-column blocks
    (195, 2, 8, (32, 1, 8, 7)),     # TIMIT in: all 8 slots of 1 a stage
    (4, 10, 16, (6, 1, 16, 1)),     # 6 blocks of 10: 60 of 64 columns
    (3, 100, 64, (1, 2, 64, 6)),    # 64-column chunks of a wide block
    (16, 16, 32, (4, 1, 32, 4)),    # the smoke configurations
])
def test_gather_geometry(n_ob, ow, k, want):
    """(blocks a CTA, chunks a block, fan-in elements a stage, CTAs along
    x): whole output blocks up to 64 columns a CTA; a stage at most 256
    elements over its blocks, a multiple of 4, taking several slots when
    the blocks are narrow (k = fan-in x input-block width)."""
    assert launch.small_gather_geo(n_ob, ow, k) == want
    nb, _, bk, _ = want
    assert bk % 4 == 0 and nb * bk <= 256
    assert launch.small_gather_smem(nb, bk) \
        == 2048 + 4 * (nb * (32 * bk + 4) + bk * 64)


@pytest.mark.parametrize("d_in_b,bl,br", [(10, 16, 4), (20, 4, 4), (8, 1, 2),
                                          (40, 2, 1), (2, 16, 16),
                                          (3, 100, 32), (2, 32, 100)])
def test_dw_geometry(d_in_b, bl, br):
    """At most 256 outputs a CTA, every thread busy through row phases
    where there are fewer, and the slot tiles covering every slot."""
    g = launch.small_dw_geo(d_in_b, bl, br)
    assert g["outs"] <= 256 and g["outs"] * g["rp"] <= 256
    assert g["outs"] * (g["rp"] + 1) > 256
    assert g["nf"] * g["p_tiles"] >= d_in_b if g["n_ic"] == 1 \
        else g["p_tiles"] == d_in_b * g["n_ic"]
    assert g["mc"] * g["nf"] * g["blc"] <= 4096 or g["mc"] == 8


def test_mask_tail_plan():
    """Whole 16-byte chunks one a thread, then the tail's elements one a
    thread: 33 x 39 f32 elements are 321 chunks and 3 more."""
    plan = launch.mask_plan(33, 39, "float32")
    (ln,) = plan.launches
    assert ln.grid == (2, 1, 1)  # 324 threads
    assert grid_pass.analyze_plan(plan, "mask")[0] == []
