"""The paged decode's launch plans (``kernels/launch.py``: ``paged_tile``,
``split_plan``, ``paged_smem``, ``paged_decode_plan``), captured from the
real wrapper on the CPU and certified by the port's sparselint grid pass:
one writer per output element and no hole (SL101), the epilogue or the
merge after the last split (SL103), shared memory within the H100's 227 KiB
opt-in (SL104) and every read inside its buffer (SL105; a -1 page-table
entry is never dereferenced). Cases: gemma3-4b's and granite-moe's decode
shapes of ``chip_smoke.py`` phases 4/4b and of its serving runs, windows
with the leading -1 pages of window reclamation, empty rows, G 1, 2, 7, 8,
Dh 16, 64, 128, 256, page sizes 8, 16, 32 and 12, int8 pages, long
rows; and the split rule: one launch at the serving tables, splits and the
merge at 72 pages."""
import pytest
import torch

from repro_torch.analysis import grid_pass
from repro_torch.configs import get_config, granite_moe_1b_a400m
from repro_torch.kernels import launch

BF16, F32 = torch.bfloat16, torch.float32
P4 = dict(lengths=grid_pass.PAGED_LENGTHS, n_pages=grid_pass.PAGED_PAGES)
SERVE = dict(lengths=grid_pass.SERVING_LENGTHS,
             n_pages=grid_pass.SERVING_PAGES)
LONG = dict(lengths=(8192, 8000, 0, 4097), n_pages=512)


def _heads(cfg):
    return cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim


def _case(name, hkv, g, dh, dtype=BF16, *, lengths, n_pages, page=16,
          window=None, quant=False):
    return grid_pass._paged_case(name, hkv, g, dh, dtype, lengths=lengths,
                                 n_pages=n_pages, page=page, window=window,
                                 quant=quant)


def _model_cases():
    gemma = _heads(get_config("gemma3_4b"))
    granite = _heads(granite_moe_1b_a400m.card_config())
    out = []
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        for window in (None, 1024):
            out.append(_case(f"gemma3/phase4/{tag}/w{window}", *gemma,
                             window=window, quant=quant, **P4))
            out.append(_case(f"gemma3/long/{tag}/w{window}", *gemma,
                             window=window, quant=quant, **LONG))
        out.append(_case(f"gemma3/serve/{tag}", *gemma, window=1024,
                         quant=quant, **SERVE))
        out.append(_case(f"granite/phase4/{tag}", *granite, quant=quant,
                         **P4))
        out.append(_case(f"granite/serve/{tag}", *granite, quant=quant,
                         **SERVE))
        out.append(_case(f"granite/long/{tag}", *granite, quant=quant,
                         **LONG))
    return out


def _geometry_cases():
    out = []
    for g in (1, 2, 7, 8):
        for dh in (16, 64, 128, 256):
            for dtype in (F32, BF16):
                out.append(_case(f"g{g}/dh{dh}/{str(dtype)[6:]}", 2, g, dh,
                                 dtype, window=300, **P4))
    for page in (8, 16, 32):
        for dh in (64, 256):
            out.append(_case(f"page{page}/dh{dh}", 2, 2, dh, page=page,
                             window=70, lengths=(600, 3, 0, 317),
                             n_pages=1040 // page))
            out.append(_case(f"page{page}/dh{dh}/int8", 2, 7, dh, page=page,
                             quant=True, lengths=(600, 3, 0, 317),
                             n_pages=1040 // page))
    for dh in (64, 256):  # 12-key pages: the cp.async copy path
        out.append(_case(f"page12/dh{dh}", 2, 2, dh, page=12, window=100,
                         lengths=(600, 3, 0, 317), n_pages=87))
    out.append(_case("empty_rows", 2, 2, 64, lengths=(0, 0), n_pages=72))
    out.append(_case("empty_rows/one_launch", 2, 2, 64, lengths=(0, 0),
                     n_pages=4))
    return out


CASES = {c.name: c for c in _model_cases() + _geometry_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_paged_plan_is_certified_clean(name):
    plan = CASES[name].build()
    findings, cost = grid_pass.analyze_plan(plan, name)
    assert findings == [], [f.message for f in findings]
    assert all(ln.smem <= launch.SMEM_OPTIN for ln in plan.launches)
    assert plan.launches[-1].epilogue
    assert len(plan.launches) == (1 if plan.n_splits == 1 else 2)


@pytest.mark.parametrize("model", ["gemma3", "granite"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_serving_tables_run_in_one_launch(model, kind):
    """The serving runs' 10-page tables: the split kernel alone, its
    epilogue in the kernel, one CTA per (row, head)."""
    plan = CASES[f"{model}/serve/{kind}"].build()
    (ln,) = plan.launches
    assert plan.n_splits == 1 and ln.epilogue and ln.fan_in_axis == "loop"
    assert ln.grid[0] == 1 and ln.kernel == "paged_decode_kernel"


@pytest.mark.parametrize("model", ["gemma3", "granite"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_long_tables_split_and_merge(model, kind):
    """72- and 512-page tables: contiguous page ranges over gridDim.x,
    then the merge kernel, one CTA per (head, row), over all splits."""
    for shape in ("phase4", "long"):
        name = f"{model}/{shape}/{kind}" + ("/wNone" if model == "gemma3"
                                            else "")
        plan = CASES[name].build()
        split, merge = plan.launches
        b = len(P4["lengths"])
        n_pages = P4["n_pages"] if shape == "phase4" else LONG["n_pages"]
        pps = plan.args["pages_per_split"]
        assert plan.n_splits == split.grid[0] == -(-n_pages // pps) > 1
        assert split.fan_in_axis == "x" and not split.epilogue
        assert merge.kernel == "paged_decode_merge_kernel"
        gd = plan.buffers["out"].shape[-1]
        assert merge.grid == (split.grid[1], b, -(-gd // 256))
        assert merge.epilogue
        # about launch._PAGED_WAVES CTAs per SM, at least a tile a split
        tile_pages = plan.args["keys_per_tile"] // 16
        assert split.n_ctas <= launch._PAGED_WAVES * launch.H100_SMS + \
            b * split.grid[1]
        assert pps % tile_pages == 0 and plan.n_splits <= n_pages


@pytest.mark.parametrize("g,dh,page,itemsize,keys", [
    (2, 64, 16, 2, 128), (2, 256, 16, 2, 32), (2, 128, 16, 2, 64),
    (2, 256, 32, 2, 32), (2, 64, 16, 1, 128), (2, 256, 16, 1, 32),
    (2, 256, 16, 4, 16), (2, 16, 8, 4, 128), (2, 64, 8, 4, 64),
    (2, 20, 8, 4, 128), (1, 256, 8, 4, 16), (8, 256, 16, 2, 16),
    (7, 128, 32, 2, 32), (8, 64, 16, 2, 64), (2, 256, 64, 2, 64)])
def test_tile_rule(g, dh, page, itemsize, keys):
    """One softmax chunk of every consumer warp (8 warps x 256 / bucket
    keys a step x 4 slots, 2 from G 4 up), at most 16 KB of K, in whole
    pages (at least one)."""
    assert launch.paged_tile(g, dh, page, itemsize) == keys


@pytest.mark.parametrize("n_sm", [1, 7, 132])
def test_split_rule(n_sm):
    """The rule's invariants on a grid of shapes: whole tiles per split,
    every page in a split, one launch up to 8 tiles of table, about two
    CTAs per SM beyond, at most _PAGED_MAX_PPS entries held by a CTA."""
    for b, hkv in ((1, 1), (4, 4), (4, 8), (64, 8)):
        for dh, itemsize in ((64, 2), (256, 2), (256, 1), (128, 4)):
            for page in (8, 16, 32):
                for n_pages in (1, 4, 10, 32, 33, 72, 512, 4096):
                    kt, pps, ns = launch.split_plan(b, hkv, 2, dh, page,
                                                    n_pages, itemsize, n_sm)
                    tile_pages = kt // page
                    assert kt % page == 0 and pps % tile_pages == 0
                    assert ns == -(-n_pages // pps) and (ns - 1) * pps \
                        < n_pages
                    assert pps <= max(launch._PAGED_MAX_PPS, tile_pages)
                    n_tiles = -(-n_pages // tile_pages)
                    if n_tiles <= launch._PAGED_ONE_LAUNCH_TILES:
                        assert ns == 1
                    elif pps < launch._PAGED_MAX_PPS:
                        # enough splits for launch._PAGED_WAVES CTAs a SM
                        want = -(-launch._PAGED_WAVES * n_sm // (b * hkv))
                        assert ns >= min(want, n_tiles) // 2


def test_shared_memory_formula():
    """``paged_smem`` is the ring (128-byte stages, up to 4 within 96 KiB,
    or the warps' states, where larger), then q in the Dh bucket, the full
    and empty barriers of 4 stages, their key-visible bytes, and the page
    ids."""
    w = launch._PAGED_WARPS
    # bf16 Dh 256 G 2, 32-key tiles: 3 stages of 2 x 16 KB
    ring = 3 * 2 * 32 * 256 * 2
    assert launch.paged_smem(2, 256, 32, 15, 2, False) == \
        ring + 4 * 2 * 256 + 16 * 4 + 4 * 32 + 4 * 15
    # int8 Dh 256 G 8, 16-key tiles: the ring holds the scales too, and
    # the warps' states are larger than it
    ring = 4 * (2 * 16 * 256 + 8 * 16)
    states = 4 * (w * 8 * 256 + w * 8 * 2 + 8 * w + 2 * 8)
    assert states > ring
    assert launch.paged_smem(8, 256, 16, 16, 1, True) == \
        -(-(states + 4 * 8 * 256 + 16 * 4 + 4 * 16) // 16) * 16 + 4 * 16
    # Dh 16 sits in the 64 bucket: q rows of 64 floats
    assert launch.paged_smem(1, 16, 128, 4, 4, False) == \
        -(-(4 * 2 * 128 * 16 * 4 + 4 * 64 + 16 * 4 + 4 * 128) // 16) * 16 \
        + 4 * 4
