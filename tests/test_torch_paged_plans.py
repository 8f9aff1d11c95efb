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
merge at 72 pages.

The dense decoders' shapes: gemma2-9b's (G 2, Dh 256, window 4096 over
rows past it), qwen2-7b's (Hkv 4, G 7, Dh 128) and granite-34b's (Hkv 1,
G 48, Dh 128), and a group of 12, run the grouped form above G 8: one CTA
per chunk of 8 query heads, each writing its chunk's heads. Its plain
version is held against the JAX package's ``paged_decode_attention``
through its plain (XLA) route at G 12 and 48."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import paged_decode_attention as jpaged

from repro_torch.analysis import grid_pass
from repro_torch.configs import get_config, granite_moe_1b_a400m
from repro_torch.kernels import flash_attention, launch

BF16, F32 = torch.bfloat16, torch.float32
P4 = dict(lengths=grid_pass.PAGED_LENGTHS, n_pages=grid_pass.PAGED_PAGES)
SERVE = dict(lengths=grid_pass.SERVING_LENGTHS,
             n_pages=grid_pass.SERVING_PAGES)
LONG = dict(lengths=(8192, 8000, 0, 4097), n_pages=512)
# gemma2-9b's phase 4 shape: rows past its 4096 window, 300-page tables
GEMMA2 = dict(lengths=(4160, 517, 0, 4097), n_pages=300)


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
        # the dense decoders (the grouped form for granite-34b and G 12)
        out.append(_case(f"gemma2/phase4/{tag}",
                         *_heads(get_config("gemma2_9b")), window=4096,
                         quant=quant, **GEMMA2))
        out.append(_case(f"qwen2/phase4/{tag}",
                         *_heads(get_config("qwen2_7b")), quant=quant,
                         **P4))
        for shape, kw in (("phase4", P4), ("serve", SERVE), ("long", LONG)):
            out.append(_case(f"granite34b/{shape}/{tag}",
                             *_heads(get_config("granite_34b")),
                             quant=quant, **kw))
        out.append(_case(f"g12/phase4/{tag}", 4, 12, 128, quant=quant,
                         window=300, **P4))
    return out


def _geometry_cases():
    out = []
    for g in (1, 2, 7, 8, 9, 48):
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


@pytest.mark.parametrize("name", ["granite34b/phase4/bf16",
                                  "granite34b/serve/int8", "g12/phase4/int8",
                                  "g9/dh16/float32"])
def test_grouped_plan_chunks_the_group(name):
    """Above G 8 the split grid's y runs over (KV head, chunk of 8 query
    heads): ceil(G / 8) CTAs per (row, KV head, split), each writing its
    chunk's heads of the output (or of the partials), the last chunk the
    rest; the split rule counts those CTAs; shared memory is the 8-head
    form's."""
    plan = CASES[name].build()
    split = plan.launches[0]
    b, hkv, g, dh = plan.buffers["q"].shape
    nc = -(-g // 8)
    assert launch.paged_chunks(g) == nc > 1
    assert split.grid == (plan.n_splits, hkv * nc, b)
    assert split.smem == launch.paged_smem(8, dh, plan.args["keys_per_tile"],
                                           plan.args["pages_per_split"],
                                           plan.buffers["k_pages"].itemsize,
                                           "int8" in name)
    c = split.ctas()
    c = c[c[:, 0] == 0]
    acc = split.writes(c)[0]  # out, or part_o: (g, d) flattened
    lo, hi = acc.lo[:, -1], acc.hi[:, -1]
    chunk = c[:, 1] % nc
    assert (lo == chunk * 8 * dh).all()
    assert (hi == np.minimum(chunk * 8 + 8, g) * dh).all()
    kt, pps, ns = launch.split_plan(b, hkv, g, dh, 16, plan.args["n_pages"],
                                    plan.buffers["k_pages"].itemsize,
                                    launch.H100_SMS)
    assert (pps, ns) == (plan.args["pages_per_split"], plan.n_splits)


def test_split_rule_counts_the_chunks():
    """A long table splits until the (row, KV head, chunk, split) CTAs
    number about two a SM: granite-34b's one KV head and six chunks need
    six times fewer splits than one chunk would."""
    one = launch.split_plan(4, 1, 8, 128, 16, 512, 2, launch.H100_SMS)
    six = launch.split_plan(4, 1, 48, 128, 16, 512, 2, launch.H100_SMS)
    assert one[0] == six[0]
    want = launch._PAGED_WAVES * launch.H100_SMS
    for ctas_per_split, (_, _, ns) in ((4, one), (24, six)):
        assert want // 2 <= ctas_per_split * ns <= want + ctas_per_split
    assert six[2] * 5 < one[2]


def test_grouped_wrappers_route_and_refuse():
    """``paged_decode_attention_cuda`` sends a group above 8 to the grouped
    wrapper (captured on the CPU, not launched), which refuses a group of
    8 or fewer; no wrapper launches on CPU tensors."""
    from repro_torch.analysis.capture import capture_launch
    args, kw = CASES["granite34b/serve/bf16"].args("meta")
    plan = capture_launch(flash_attention.paged_decode_attention_cuda,
                          *args, **kw)
    assert plan.launches[0].grid[1] == 6
    small = [torch.zeros((1, 1, 8, 64))] + [None] * 4
    for fn in (flash_attention.paged_decode_attention_grouped_cuda,
               flash_attention.paged_decode_attention_quant_grouped_cuda):
        kw = {} if "quant" not in fn.__name__ else dict(k_scale=None,
                                                        v_scale=None)
        with pytest.raises(ValueError, match="groups above 8"):
            fn(*small, **kw)
    q = torch.zeros((1, 1, 12, 64))
    kp = torch.zeros((3, 16, 1, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.paged_decode_attention_grouped_cuda(
            q, kp, kp, torch.zeros((1, 2), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))


def _grouped_inputs(g, seed=0, b=4, dh=128, page=16, n_pages=24):
    """One KV head under g query heads; rows of 3, 300, 0 and 377 keys, -1
    entries only past a row's length (as the engine's tables have them)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([3, 300, 0, 377], np.int32)[:b]
    total = sum(-(-int(n) // page) for n in lengths) + 1
    q = rng.normal(size=(b, 1, g, dh)).astype(np.float32)
    kp = rng.normal(size=(total, page, 1, dh)).astype(np.float32)
    vp = rng.normal(size=(total, page, 1, dh)).astype(np.float32)
    table = np.full((b, n_pages), -1, np.int32)
    perm, k = rng.permutation(total - 1), 0
    for i, n in enumerate(lengths):
        for p in range(-(-int(n) // page)):
            table[i, p] = perm[k]
            k += 1
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("quant", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("g", [12, 48])
def test_plain_grouped_decode_matches_reference(g, quant):
    """The plain paged decode at G 12 and 48, Dh 128, softcap 50 and a
    window of 100, against the JAX ``paged_decode_attention`` through its
    plain route (f32; int8 pages with per-token scales)."""
    from repro.serving.kv_cache import quantize_kv as jquantize_kv
    q, kp, vp, table, lengths = _grouped_inputs(g)
    kw = dict(window=100, softcap=50.0)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    targs = [torch.from_numpy(np.array(a)) for a in (q, kp, vp, table,
                                                       lengths)]
    if quant:
        (k8, ks), (v8, vs) = jquantize_kv(jargs[1]), jquantize_kv(jargs[2])
        jargs[1:3] = k8, v8
        targs[1:3] = (torch.from_numpy(np.array(k8)),
                      torch.from_numpy(np.array(v8)))
        jkw = dict(kw, k_scale=ks, v_scale=vs)
        tkw = dict(kw, k_scale=torch.from_numpy(np.array(ks)),
                   v_scale=torch.from_numpy(np.array(vs)))
    else:
        jkw = tkw = kw
    ref = jpaged(*jargs, backend="xla", **jkw)
    got = flash_attention.paged_decode_attention(*targs, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    assert (got.numpy()[2] == 0).all()
