"""The forward's launch plans (``kernels/launch.py``: ``fwd_plan``, its
wgmma body ``_fwd_wgmma_launch`` and the rule ``fwd_tile_n`` between the
bodies), captured from the real wrappers on the CPU and certified by the
port's sparselint grid pass: one writer per output element and no hole
(SL101), tiles that divide their extents or are masked (SL102), the
epilogue after the last fan-in slot (SL103), shared memory within the
H100's 227 KiB opt-in (SL104) and every read inside its buffer (SL105), at
gemma3-4b's and granite-moe-1b-a400m's training shapes, at ragged M, three
experts and bL / bR of 64, 128 and 256."""
import pytest
import torch

from repro_torch.analysis import grid_pass
from repro_torch.analysis.capture import capture_launch
from repro_torch.configs import get_config, granite_moe_1b_a400m
from repro_torch.kernels import csd_spmm, launch

BF16, F32 = torch.bfloat16, torch.float32
TRAIN_M = grid_pass.TRAIN_B * grid_pass.TRAIN_S
GRANITE_C = 1280  # rows per expert at 2 x 2048 tokens, top-8, capacity 1.25
WGMMA = "csd_spmm_fwd_wgmma_kernel"


def _gemma3():
    gp = grid_pass._layer0_patterns(get_config("gemma3_4b"))
    return gp["ffn.gate.pattern"], gp["ffn.down.pattern"]


def _granite():
    cfg = granite_moe_1b_a400m.card_config()
    rp = grid_pass._layer0_patterns(cfg)
    return cfg.moe.n_routed, rp["ffn.up_pat"], rp["ffn.down_pat"]


def _training_cases():
    gate, down = _gemma3()
    e, up, edown = _granite()
    fwd = grid_pass._fwd_case
    return [
        fwd("gemma3/gate_gelu_preact", gate, TRAIN_M, BF16,
            activation="gelu", save_preact=True),
        fwd("gemma3/down", down, TRAIN_M, BF16),
        fwd("gemma3/down_bias_relu", down, TRAIN_M, BF16, activation="relu",
            bias=True),
        fwd("granite/up", up, GRANITE_C, BF16, experts=e),
        fwd("granite/up_gelu_preact", up, GRANITE_C, BF16, experts=e,
            activation="gelu", save_preact=True),
        fwd("granite/down", edown, GRANITE_C, BF16, experts=e),
    ]


def _small_cases():
    fwd = grid_pass._fwd_case
    out = []
    for bl, br in ((64, 64), (128, 128), (128, 256), (256, 128),
                   (256, 256), (64, 256)):
        bp = grid_pass._demo_pattern(block_in=bl, block_out=br)
        for m in (1, 77, 1000):
            out.append(fwd(f"bl{bl}_br{br}/m{m}", bp, m, BF16,
                           activation="gelu", bias=True, save_preact=True))
        out.append(fwd(f"bl{bl}_br{br}/e3_m1000", bp, 1000, BF16, experts=3,
                       activation="relu", bias=True, save_preact=True))
    bp = grid_pass._demo_pattern()
    out += [fwd(f"f32/m{m}", bp, m, F32, bias=True, save_preact=True)
            for m in (1, 77, 1000)]
    return out


CASES = {c.name: c for c in _training_cases() + _small_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_plan_is_certified_clean(name):
    plan = CASES[name].build()
    findings, cost = grid_pass.analyze_plan(plan, name)
    assert findings == [], [f.message for f in findings]
    assert all(ln.smem <= launch.SMEM_OPTIN for ln in plan.launches)
    assert sum(cost["ctas"]) == sum(ln.n_ctas for ln in plan.launches) > 0


@pytest.mark.parametrize("name", [c.name for c in _training_cases()])
def test_training_shapes_take_the_wgmma_body(name):
    """Every training forward is one persistent launch of the wgmma body:
    one CTA per SM, 384 threads, 256-column tiles, the fan-in a loop."""
    plan = CASES[name].build()
    (ln,) = plan.launches
    assert ln.kernel == WGMMA and ln.grid == (launch.H100_SMS, 1, 1)
    assert ln.threads == 384 and ln.fan_in_axis == "loop"
    assert plan.n_splits == 1 and plan.args["tile_n"] == 256
    assert dict((t[0], t[2]) for t in ln.tiles)["n_out"] == 256


@pytest.fixture
def force_body(monkeypatch):
    """``force_body(t)``: the forward's plans take the body of tile width
    ``t`` (0 the grid body) whatever ``launch.fwd_tile_n``'s rule picks."""
    def force(tile_n):
        monkeypatch.setattr(launch, "fwd_tile_n", lambda *a: tile_n)
        launch.fwd_plan.cache_clear()
    yield force
    launch.fwd_plan.cache_clear()


@pytest.mark.parametrize("n_sm", [1, 7, 132])
@pytest.mark.parametrize("tile_n", [64, 128, 256])
def test_persistent_plan_writes_y_and_z_once(n_sm, tile_n, force_body):
    """The wgmma body on 1, 7 or 132 SMs, at each tile width, three experts
    of a ragged M: every element of y and z has exactly one writer, also
    where the last round's tiles run as halves."""
    bp = grid_pass._demo_pattern(block_in=128, block_out=256)
    case = grid_pass._fwd_case("fwd", bp, 300, BF16, experts=3,
                               activation="gelu", bias=True,
                               save_preact=True)
    (x, w, idx), kw = case.args("meta")
    force_body(tile_n)
    plan = capture_launch(
        csd_spmm._launch_fwd, "fwd", x, w, idx, kw["bias"],
        "gelu", True, batched=True, n_sm=n_sm)
    (ln,) = plan.launches
    n_tiles = 3 * 3 * (bp.n_out // tile_n)  # experts x row tiles x columns
    assert ln.kernel == WGMMA and ln.grid == (min(n_tiles, n_sm), 1, 1)
    assert plan.args["tile_n"] == tile_n
    assert grid_pass.analyze_plan(plan, "fwd")[0] == []


@pytest.mark.parametrize("n_tiles,n_ctas,bn,full", [
    (320, 132, 256, 264),    # gemma3 down at M 4096: 56 tiles left halved
    (1280, 132, 256, 1280),  # gemma3 gate: a last round of 92 stays whole
    (640, 132, 256, 640),    # granite up/gate: 112 left, too many to halve
    (160, 132, 256, 132),    # gemma3 gate at M 512: 28 left halved
    (264, 132, 256, 264),    # whole rounds
    (100, 100, 256, 100),    # fewer tiles than SMs: one round
    (320, 132, 64, 320),     # 64-wide tiles are not halved
])
def test_last_round_halves(n_tiles, n_ctas, bn, full):
    assert launch.fwd_full_tiles(n_tiles, n_ctas, bn) == full


def test_halved_last_round_covers_the_down_junction():
    """gemma3-4b's down junction at M 4096 on 132 SMs: 320 tiles of 256
    columns, two whole rounds, then the last 56 tiles as 112 halves of 128
    columns; its writes still cover y once."""
    _, down = _gemma3()
    plan = grid_pass._fwd_case("down", down, TRAIN_M, BF16).build()
    (ln,) = plan.launches
    boxes = ln.writes(ln.ctas())
    assert len(boxes) == 3  # three rounds
    widths = boxes[2].hi[:, 1] - boxes[2].lo[:, 1]
    assert sorted(set(widths.tolist())) == [0, 128]
    assert int((widths == 128).sum()) == 112
    assert grid_pass.analyze_plan(plan, "down")[0] == []


@pytest.mark.parametrize("what,e,m,n_rb,br,want", [
    ("gemma3 gate decode", 1, 4, 10, 1024, 0),
    ("gemma3 down decode", 1, 4, 5, 512, 0),
    ("gemma3 gate M 16", 1, 16, 10, 1024, 0),
    ("gemma3 gate prefill", 1, 64, 10, 1024, 128),
    ("gemma3 down prefill", 1, 64, 5, 512, 0),
    ("granite up decode", 32, 4, 2, 256, 128),
    ("granite down decode", 32, 4, 4, 256, 256),
    ("granite down prefill", 32, 64, 4, 256, 256),
    ("gemma3 gate M 128", 1, 128, 10, 1024, 128),
    ("gemma3 down M 128", 1, 128, 5, 512, 64),
    ("gemma3 gate M 256", 1, 256, 10, 1024, 128),
    ("gemma3 down M 256", 1, 256, 5, 512, 64),
    ("gemma3 gate M 512", 1, 512, 10, 1024, 128),
    ("gemma3 down M 512", 1, 512, 5, 512, 128),
    ("gemma3 down M 2048", 1, 2048, 5, 512, 128),
    ("gemma3 gate train", 1, TRAIN_M, 10, 1024, 256),
    ("gemma3 down train", 1, TRAIN_M, 5, 512, 256),
    ("granite up train", 32, GRANITE_C, 2, 256, 256),
    ("granite down train", 32, GRANITE_C, 4, 256, 256),
    ("bR 192", 1, TRAIN_M, 4, 192, 64),
])
def test_body_rule(what, e, m, n_rb, br, want):
    """The body and tile width of each shape ``tools/time_forward.py
    --bodies`` timed, as the rule picks them on 132 SMs: the single
    junction's decode, and gemma3-4b's down junction below 128 rows (40
    64-wide tiles), keep the grid body; everything else in bf16 takes the
    wgmma body; f32 the grid body."""
    assert launch.fwd_tile_n("bfloat16", e, m, n_rb, br,
                             launch.H100_SMS) == want, what
    assert launch.fwd_tile_n("float32", e, m, n_rb, br,
                             launch.H100_SMS) == 0


@pytest.mark.parametrize("n_tiles,bn,cost", [
    (320, 256, 2 * 288 + 160),  # gemma3 down, M 4096: a halved last round
    (640, 128, 5 * 160),        # the same at 128: 112 tiles left, whole
    (80, 256, 288),             # gemma3 gate, M 256: one round
    (160, 128, 160 + 96),       # the same at 128: 28 tiles left, halved
    (320, 64, 3 * 96),          # the same at 64: never halved
    (40, 64, 96),               # gemma3 down, M 64: a third of the SMs
])
def test_schedule_cost(n_tiles, bn, cost):
    """Each round of the persistent schedule costs its width plus 32."""
    assert launch._schedule_cost(n_tiles, launch.H100_SMS, bn) == cost


@pytest.mark.parametrize("bn,stages,smem", [
    (64, 4, 4 * (128 + 64) * 128 + 2 * 2 * 64 * 64 * 2 + 1024 + 64),
    (128, 4, 4 * (128 + 128) * 128 + 2 * 2 * 64 * 128 * 2 + 1024 + 64),
    (256, 3, 3 * (128 + 256) * 128 + 2 * 64 * 256 * 2 + 1024 + 48),
])
def test_wgmma_shared_memory(bn, stages, smem):
    """The ring (3 stages of 256-wide tiles, else 4), the staging tiles of y
    and z, alignment and barriers fit the H100's opt-in."""
    assert launch.fwd_wgmma_smem(bn) == smem <= launch.SMEM_OPTIN


def test_wgmma_body_refuses_a_split():
    bp = grid_pass._demo_pattern(block_in=128, block_out=256)
    with pytest.raises(ValueError, match="does not split"):
        launch.fwd_plan(1, 4096, bp.n_in, bp.n_rb, bp.d_in_b, 128, 256,
                        "bfloat16", has_bias=False, save_preact=False,
                        quant=False, n_sm=132, n_splits=2)
