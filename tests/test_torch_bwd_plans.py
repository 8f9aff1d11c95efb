"""The backward's launch plans (``kernels/launch.py``: ``dx_plan``,
``dw_plan``, ``mask_plan``), captured from the real wrappers on the CPU and
certified by the port's sparselint grid pass: one writer per output element
and no hole (SL101), tiles that divide their extents or are masked (SL102),
the epilogue after the last fan-in slot (SL103), shared memory within the
H100's 227 KiB opt-in (SL104) and every read inside its buffer (SL105), at
gemma3-4b's and granite-moe-1b-a400m's training shapes and at ragged M, a
bL = 64 pattern and three experts."""
import pytest
import torch

from repro_torch.analysis import grid_pass
from repro_torch.configs import get_config, granite_moe_1b_a400m
from repro_torch.kernels import launch

BF16, F32 = torch.bfloat16, torch.float32
TRAIN_M = grid_pass.TRAIN_B * grid_pass.TRAIN_S


def _gemma3_cases():
    gp = grid_pass._layer0_patterns(get_config("gemma3_4b"))
    gate, down = gp["ffn.gate.pattern"], gp["ffn.down.pattern"]
    return [
        grid_pass._mask_case("gemma3/mask_gate", TRAIN_M, gate.n_out, BF16),
        grid_pass._dx_case("gemma3/dx_gate", gate, TRAIN_M, BF16),
        grid_pass._dw_case("gemma3/dw_gate_db", gate, TRAIN_M, BF16,
                           want_db=True),
        grid_pass._dx_case("gemma3/dx_down", down, TRAIN_M, BF16),
        grid_pass._dw_case("gemma3/dw_down", down, TRAIN_M, BF16),
    ]


def _granite_cases():
    cfg = granite_moe_1b_a400m.card_config()
    rp = grid_pass._layer0_patterns(cfg)
    e, c = cfg.moe.n_routed, 1280  # C rows per expert at 2 x 2048, top-8
    out = [grid_pass._mask_case("granite/mask_up_gelu", c, rp["ffn.up_pat"]
                                .n_out, BF16, experts=e)]
    for name in ("up", "down"):
        bp = rp[f"ffn.{name}_pat"]
        out += [grid_pass._dx_case(f"granite/dx_{name}", bp, c, BF16,
                                   experts=e),
                grid_pass._dw_case(f"granite/dw_{name}_db", bp, c, BF16,
                                   experts=e, want_db=True)]
    return out


def _small_cases():
    bp = grid_pass._demo_pattern()  # 128 x 128 blocks, fan-in 2
    bp64 = grid_pass._demo_pattern(block_in=64, block_out=64, n_lb=4, n_rb=6)
    wide = grid_pass._demo_pattern(block_in=128, block_out=256)
    out = []
    for m in (1, 77, 1000):
        for dt, tag in ((BF16, "bf16"), (F32, "f32")):
            out += [
                grid_pass._dx_case(f"m{m}/{tag}/dx", bp, m, dt),
                grid_pass._dw_case(f"m{m}/{tag}/dw_db", bp, m, dt,
                                   want_db=True),
                grid_pass._mask_case(f"m{m}/{tag}/mask_relu", m, bp.n_out,
                                     dt, activation="relu"),
            ]
    out += [
        grid_pass._dx_case("bl64/dx", bp64, 77, BF16),
        grid_pass._dw_case("bl64/dw_db", bp64, 77, BF16, want_db=True),
        grid_pass._dx_case("bl128_br256/dx", wide, 77, BF16),
        grid_pass._dw_case("bl128_br256/dw_db", wide, 77, BF16,
                           want_db=True),
        grid_pass._dx_case("e3_m77/dx", bp, 77, BF16, experts=3),
        grid_pass._dw_case("e3_m77/dw_db", bp, 77, BF16, experts=3,
                           want_db=True),
        grid_pass._mask_case("e3_m77/mask_gelu", 77, bp.n_out, BF16,
                             experts=3),
        grid_pass._dx_case("e3_m1000/dx", bp64, 1000, BF16, experts=3),
        grid_pass._dw_case("e3_m1000/dw", bp64, 1000, BF16, experts=3),
    ]
    return out


CASES = {c.name: c for c in _gemma3_cases() + _granite_cases()
         + _small_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_backward_plan_is_certified_clean(name):
    plan = CASES[name].build()
    findings, cost = grid_pass.analyze_plan(plan, name)
    assert findings == [], [f.message for f in findings]
    (ln,) = plan.launches
    assert ln.smem <= launch.SMEM_OPTIN
    assert sum(cost["ctas"]) == ln.n_ctas > 0


@pytest.mark.parametrize("dtype,bl,br,want", [
    ("bfloat16", 256, 1024, ((128, 256), (128, 256), 384)),
    ("bfloat16", 256, 512, ((128, 256), (128, 256), 384)),
    ("bfloat16", 64, 192, ((128, 64), (64, 64), 256)),
    ("bfloat16", 128, 384, ((128, 128), (128, 128), 384)),
    ("float32", 256, 1024, ((64, 64), (64, 64), 128)),
])
def test_backward_tiles(dtype, bl, br, want):
    """bf16: dx tiles of 128 rows by the widest of 256, 128 and 64 columns
    that divides the left block; dw tiles of 128 (or 64) block rows by the
    widest of 256, 128 and 64 that divides the right block, one consumer
    warpgroup per 64 rows beside the producer; f32: 64 x 64 tiles on 128
    CUDA-core threads."""
    dx_tile, dw_tile, dw_threads = want
    assert launch.dx_tile(bl, dtype) == dx_tile
    assert launch.dw_tile(bl, br, dtype) == dw_tile
    plan = launch.dw_plan(1, 100, 4 * bl, 2, 2, bl, br, dtype,
                          want_db=False)
    assert plan.launches[0].threads == dw_threads
    dx = launch.dx_plan(1, 100, 2, 2, bl, br, 4, 1, dtype,
                        n_sm=launch.H100_SMS)
    assert dx.launches[0].threads == (128 if dtype == "float32" else 384)


@pytest.mark.parametrize("n_sm", [1, 7, 132])
def test_persistent_dx_plan_covers_every_tile_once(n_sm):
    """The bf16 dx kernel runs min(tiles, SMs) persistent CTAs, CTA b
    taking tiles b, b + n_ctas, ...: on 1, 7 or 132 SMs every dx element
    still has exactly one writer."""
    bp = grid_pass._demo_pattern()
    plan = grid_pass._dx_case("dx", bp, 300, BF16, experts=3).build(n_sm)
    (ln,) = plan.launches
    n_tiles = 3 * 3 * 4  # experts x row tiles x 128-column tiles
    assert ln.grid == (min(n_tiles, n_sm), 1, 1)
    assert plan.args["n_ctas"] == ln.grid[0]
    assert grid_pass.analyze_plan(plan, "dx")[0] == []


def test_mask_plan_covers_every_element_once():
    """One 16-byte chunk per thread over the flat cotangent: the grid
    rounds up, and the last CTA's range ends at the last element."""
    plan = launch.mask_plan(3 * 77, 512, "bfloat16")
    (ln,) = plan.launches
    assert ln.grid == (-(-3 * 77 * 512 // 8 // 256), 1, 1)
    assert ln.threads == 256 and ln.smem == 0
    assert grid_pass.analyze_plan(plan, "mask")[0] == []
