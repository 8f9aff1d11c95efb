"""The full-sequence attention's launch plans (``kernels/launch.py``:
``flash_plan``, ``flash_tiles``, ``flash_smem``), captured from the real
wrappers on the CPU and certified by the port's sparselint grid pass: one
writer per element of o, lse, dq, dk, dv and delta and no hole (SL101),
tiles that divide their extents or are masked (SL102), the epilogue once
per output element (SL103), shared memory within the H100's 227 KiB
opt-in (SL104) and every read inside its buffer (SL105): at gemma3-4b's
global and local and granite-moe-1b-a400m's training shapes, and at every
geometry of ``tests/test_torch_cuda.py``'s ``FLASH_CASES`` (ragged S, a
query offset, no causal mask, Sq != Skv, empty rows, G 1/2/4) with Dh 16,
64, 128 and 256 in f32 and bf16."""
import pytest
import torch

from repro_torch.analysis import grid_pass
from repro_torch.analysis.capture import capture_launch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import launch

# (B, Sq, Skv, Hq, Hkv, causal, window, softcap, q_offset), as
# tests/test_torch_cuda.py's FLASH_CASES
GEOMETRIES = {
    "causal_g2": (2, 200, 200, 4, 2, True, None, None, 0),
    "window_g4": (1, 200, 200, 8, 2, True, 50, None, 0),
    "softcap_g1": (2, 130, 130, 2, 2, True, None, 30.0, 0),
    "offset": (1, 70, 150, 4, 2, True, None, None, 13),
    "not_causal": (1, 100, 77, 4, 1, False, None, 50.0, 0),
    "empty_rows": (1, 100, 40, 2, 1, True, 16, None, 0),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _meta(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _plan(geometry, dh, dtype, backward):
    b, sq, skv, hq, hkv, causal, window, softcap, off = GEOMETRIES[geometry]
    q, do, o = (_meta(b, sq, hq, dh, dtype=dtype) for _ in range(3))
    k, v = (_meta(b, skv, hkv, dh, dtype=dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, logit_softcap=softcap,
              q_offset=off)
    if not backward:
        return capture_launch(fa.flash_attention_cuda, q, k, v, **kw)
    lse = _meta(b, hq, sq, dtype=torch.float32)
    return capture_launch(fa.flash_attention_bwd_cuda, q, k, v, o, lse, do,
                          **kw)


def _certified(plan, name):
    findings, cost = grid_pass.analyze_plan(plan, name)
    assert findings == [], [f.message for f in findings]
    assert all(ln.smem <= launch.SMEM_OPTIN for ln in plan.launches)
    assert cost["ctas"] == [ln.n_ctas for ln in plan.launches]


TRAIN_CASES = {c.name: c for c in grid_pass.full_width_cases()
               if "/flash_" in c.name}


def test_training_cases_are_the_three_layers_both_ways():
    assert sorted(TRAIN_CASES) == sorted(
        f"{m}/train/flash_{d}{t}" for m, tags in (
            ("gemma3_4b", ("_global", "_local")), ("granite", ("",)))
        for t in tags for d in ("fwd", "bwd"))


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_training_shape_plan_is_certified_clean(name):
    plan = TRAIN_CASES[name].build()
    _certified(plan, name)
    want = ["flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel"] \
        if "bwd" in name else ["flash_fwd_wgmma_kernel"]
    assert [ln.kernel for ln in plan.launches] == want
    assert all(ln.threads == 384 for ln in plan.launches)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dh", [16, 64, 128, 256])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_geometry_plan_is_certified_clean(geometry, dh, dtype, backward):
    plan = _plan(geometry, dh, DTYPES[dtype], backward)
    _certified(plan, f"{geometry}/dh{dh}/{dtype}")
    tiles = launch.flash_tiles(str(DTYPES[dtype]).replace("torch.", ""), dh)
    keys = ("dq", "dkv") if backward else ("fwd",)
    for ln, key in zip(plan.launches, keys):
        assert ln.threads == tiles[key]["threads"]
        rows = dict((what, tile) for what, _, tile, _ in ln.tiles)
        own = "Skv" if key == "dkv" else "Sq"
        assert rows[own] == tiles[key]["rows"]


@pytest.mark.parametrize("dh,want", [
    # (rows, streamed rows) of fwd, dq, dk/dv; dynamic shared memory
    (64, (((128, 128), (128, 64), (128, 64)), (83016, 66632, 67624))),
    (128, (((128, 128), (128, 64), (128, 64)), (164936, 132168, 133160))),
    (256, (((128, 64), (128, 64), (64, 64)), (197704, 230472, 198696))),
    (16, (((128, 128), (128, 64), (128, 64)), (83016, 66632, 67624))),
])
def test_bf16_tiles_and_shared_memory(dh, want):
    """bf16: 128 query rows (two consumer warpgroups of 64) in the forward
    and dq; in dk/dv 128 key rows (64 per consumer) up to Dh 128 and 64 at
    Dh 256 (both consumers on the same keys); two stages of the widest
    streamed tile that fits the 232,448-byte opt-in at Dh 256 (64 keys
    forward; in dq 64 keys with one stage of V); a Dh below 64 takes the
    Dh-64 bucket's tiles (TMA zero-fills the head dims past Dh)."""
    tiles, smem = want
    t = launch.flash_tiles("bfloat16", dh)
    got = tuple((t[k]["rows"], t[k]["stream"]) for k in ("fwd", "dq", "dkv"))
    assert got == tiles
    s = launch.flash_smem("bfloat16", dh)
    assert (s["fwd"], s["dq"], s["dkv"]) == smem
    assert max(smem) <= launch.SMEM_OPTIN


def test_f32_plans_keep_the_cuda_core_tiles():
    """f32 keeps 64-row CTAs of 256 threads and 32-row streamed tiles."""
    t = launch.flash_tiles("float32", 256)
    assert all(v == dict(rows=64, stream=32, threads=256)
               for v in t.values())
    plan = _plan("causal_g2", 256, torch.float32, True)
    assert [ln.kernel for ln in plan.launches] == ["flash_dq_kernel",
                                                    "flash_dkv_kernel"]
    assert [ln.grid for ln in plan.launches] == [(4, 4, 2), (4, 2, 2)]


@pytest.mark.parametrize("dh,rows", [(64, 128), (256, 64)])
def test_causal_dkv_reads_only_the_queries_that_see_its_keys(dh, rows):
    """dk/dv CTA t owns key rows [R t, R t + R) and reads q, dout, lse and
    delta only from the query rows that can see them: causal from R t on."""
    plan = _plan("causal_g2", dh, torch.bfloat16, True)
    dkv = plan.launches[1]
    assert dict((w, tile) for w, _, tile, _ in dkv.tiles)["Skv"] == rows
    ctas = dkv.ctas()
    reads = {a.buffer: a for a in dkv.reads(ctas, {})}
    assert (reads["q"].lo[:, 1] == rows * ctas[:, 0]).all()
    assert (reads["q"].hi[:, 1] == 200).all()
