"""The paged decode's launch plans (``kernels/launch.py``: ``paged_tile``,
``split_plan``, ``paged_smem``, ``paged_decode_plan``; the tensor-core
form's ``paged_rule``, ``mma_split_plan``, ``paged_mma_smem``), captured
from the real wrapper on the CPU and certified by the port's sparselint
grid pass: one writer per output element and no hole (SL101), the
epilogue or the merge after the last split (SL103), shared memory within
the H100's 227 KiB opt-in (SL104) and every read inside its buffer (SL105;
a -1 page-table entry is never dereferenced). Cases: gemma3-4b's and
granite-moe's decode shapes of ``chip_smoke.py`` phases 4/4b and of its
serving runs, windows with the leading -1 pages of window reclamation,
empty rows, G 1, 2, 7, 8, Dh 16, 64, 128, 256, page sizes 8, 16, 32 and
12, int8 pages, long rows; and the split rule: one launch at the serving
tables, splits and the merge at 72 pages.

The dense decoders' shapes: gemma2-9b's (G 2, Dh 256, window 4096 over
rows past it), qwen2-7b's (Hkv 4, G 7, Dh 128) and granite-34b's (Hkv 1,
G 48, Dh 128), and a group of 12. From G 5 to 48 over bf16 q the
tensor-core form runs (one CTA per (split, KV head, row) for the whole
group); f32, and the CUDA-core form forced, run groups above 8 in chunks
of 8 query heads, each CTA writing its chunk's heads. The plain version is
held against the JAX package's ``paged_decode_attention`` through its
plain (XLA) route at G 12 and 48, and an emulation of the tensor-core
form's rounding at G 7, 12 and 48."""
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


def _mma_cases():
    """The tensor-core form's shapes beyond the models': G 5 (its
    threshold), 16, 17 and 33 (one, two and three row tiles), Dh 64 and
    256, 12-key pages (cp.async copies) and 8-key ones, a window, long
    rows, bf16 and int8 pages."""
    out = []
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        for g in (5, 16, 17, 33, 48):
            out.append(_case(f"mma/g{g}/{tag}", 2, g, 128, quant=quant,
                             window=300, **P4))
        out.append(_case(f"mma/dh256/{tag}", 1, 48, 256, quant=quant,
                         **LONG))
        for page in (8, 12):
            out.append(_case(f"mma/page{page}/{tag}", 2, 12, 128,
                             page=page, quant=quant, window=70,
                             lengths=(600, 3, 0, 317), n_pages=1056 // page))
    out.append(_case("mma/dh64/bf16", 4, 7, 64, window=1000, **LONG))
    return out


CASES = {c.name: c for c in _model_cases() + _geometry_cases()
         + _mma_cases()}


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
    # the chunked form (f32's), forced where the rule takes the tensor-core
    # form (bf16 q)
    with launch.forced_paged_form("cores"):
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
    # the chunked form, forced over these bf16 q (the rule's tensor-core
    # form: test_mma_grid_is_one_cta_per_row_head_split)
    with launch.forced_paged_form("cores"):
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


# ---------------------------------------------------------------------------
# the tensor-core form (paged_decode_mma_kernel)
# ---------------------------------------------------------------------------

MMA = "paged_decode_mma_kernel"


@pytest.mark.parametrize("g,dh,page,dtype,quant,form", [
    (1, 128, 16, "bfloat16", False, "cores"),
    (2, 256, 16, "bfloat16", False, "cores"),
    (4, 128, 16, "bfloat16", True, "cores"),
    (5, 128, 16, "bfloat16", False, "mma"),
    (7, 128, 16, "bfloat16", False, "mma"),
    (7, 128, 16, "float32", False, "cores"),
    (7, 128, 16, "float32", True, "cores"),
    (7, 128, 16, "bfloat16", True, "mma"),
    (12, 128, 16, "bfloat16", True, "mma"),
    (48, 128, 16, "bfloat16", False, "mma"),
    (48, 128, 16, "bfloat16", True, "mma"),
    (49, 128, 16, "bfloat16", False, "cores"),
    (48, 16, 16, "bfloat16", False, "cores"),
    (12, 64, 16, "bfloat16", False, "mma"),
    (12, 64, 16, "bfloat16", True, "cores"),
    (48, 256, 16, "bfloat16", True, "mma"),
    (48, 96, 16, "bfloat16", False, "cores"),
    (12, 128, 12, "bfloat16", False, "mma"),
    (12, 256, 12, "bfloat16", False, "cores"),
    (12, 256, 64, "bfloat16", False, "mma"),
    (12, 128, 256, "bfloat16", False, "cores")])
def test_form_rule(g, dh, page, dtype, quant, form):
    """Which form each (G, Dh, page size, dtype, page dtype) takes: the
    tensor-core form for bf16 q over bf16 or int8 pages from G0 (5) to 48
    heads, whole 128-byte rows (bf16 Dh 64, 128, 256; int8 128, 256) and a
    tile of K and V within 64 KiB; the CUDA-core form for G 1, 2 and 4,
    f32 and the rest."""
    assert launch.paged_rule(g, dh, page, dtype, quant) == form


@pytest.mark.parametrize("name,form", [
    ("gemma3/phase4/bf16/wNone", "cores"), ("granite/serve/int8", "cores"),
    ("gemma2/phase4/int8", "cores"), ("qwen2/phase4/bf16", "mma"),
    ("qwen2/phase4/int8", "mma"), ("granite34b/long/bf16", "mma"),
    ("g12/phase4/int8", "mma"), ("g7/dh128/float32", "cores"),
    ("g7/dh128/bfloat16", "mma"), ("g48/dh16/bfloat16", "cores"),
    ("mma/page12/bf16", "mma")])
def test_plans_take_the_rules_form(name, form):
    """The wrapper's plan runs the rule's split kernel, left to the
    library's own rule (form -1); forced, either form is passed to it."""
    plan = CASES[name].build()
    kernel = MMA if form == "mma" else "paged_decode_kernel"
    assert plan.launches[0].kernel == kernel and plan.args["form"] == -1
    for forced in launch.PAGED_FORMS:
        b, hkv, g, dh = plan.buffers["q"].shape
        if forced == "mma" and not launch.paged_mma_legal(
                g, dh, "bfloat16" if plan.args["dtype"] else "float32",
                bool(plan.args["quant"])):
            continue
        with launch.forced_paged_form(forced):
            got = CASES[name].build()
        assert got.args["form"] == launch.PAGED_FORMS.index(forced)
        assert (got.launches[0].kernel == MMA) == (forced == "mma")


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith(
    ("mma/", "qwen2/", "granite34b/", "g12/"))])
def test_mma_grid_is_one_cta_per_row_head_split(name):
    """The tensor-core form: grid (splits, Hkv, B), no chunks of the group;
    each CTA writes every head of its (row, KV head) to the output (one
    launch) or to its split's partials; threads 32 x (row tiles x dim
    slices x key slices); shared memory ``paged_mma_smem``; the tile whole
    16-key chunks and pages, the split whole tiles."""
    plan = CASES[name].build()
    split = plan.launches[0]
    b, hkv, g, dh = plan.buffers["q"].shape
    assert split.kernel == MMA
    kt, pps = plan.args["keys_per_tile"], plan.args["pages_per_split"]
    page = plan.args["page_size"]
    psize = plan.buffers["k_pages"].itemsize
    assert split.grid == (plan.n_splits, hkv, b)
    assert split.threads == 32 * int(np.prod(launch.paged_mma_warps(g, dh)))
    assert split.smem == launch.paged_mma_smem(g, dh, kt, pps, psize,
                                               psize == 1)
    assert kt % 16 == 0 and kt % page == 0 and pps % (kt // page) == 0
    acc = split.writes(split.ctas())[0]
    assert (acc.lo[:, -1] == 0).all() and (acc.hi[:, -1] == g * dh).all()


def test_mma_split_rule_counts_row_head_split_ctas():
    """The tensor-core form's split rule counts (row, KV head, split) CTAs,
    with no chunks: granite-34b's 48 heads split as a group of 7 would over
    one KV head, not six times less; a short table runs in one launch as
    one tile where two stages of it fit the shared memory; CTAs of 4 warps
    (one row tile) fill two a SM, larger ones one."""
    sms = launch.H100_SMS
    for g in (7, 12, 48):
        kt, pps, ns = launch.mma_split_plan(4, 1, g, 128, 16, 512, 2, sms)
        waves = 2 if g <= 16 else 1
        assert kt == 64 and ns * kt * pps // kt >= 512
        assert 4 * ns <= waves * sms + 4 and 4 * ns >= waves * sms // 2
    # the serving runs' 10-page tables: one tile of 192 keys at Dh 128; at
    # Dh 256 two stages of 192 int8 keys fit, of bf16 keys not even 128
    assert launch.mma_split_plan(4, 4, 7, 128, 16, 10, 2, sms) == \
        (192, 12, 1)
    assert launch.mma_split_plan(4, 1, 48, 256, 16, 10, 1, sms)[0] == 192
    assert launch.mma_split_plan(4, 1, 48, 256, 16, 10, 2, sms)[0] == 64
    for n_sm in (1, 7, 132):
        for b, hkv in ((1, 1), (4, 1), (4, 4), (64, 8)):
            for page in (8, 12, 16, 32):
                for n_pages in (1, 4, 10, 33, 72, 512, 4096):
                    kt, pps, ns = launch.mma_split_plan(
                        b, hkv, 48, 128, page, n_pages, 2, n_sm)
                    tp = kt // page
                    assert kt % 16 == 0 and kt % page == 0 and pps % tp == 0
                    assert ns == -(-n_pages // pps) and (ns - 1) * pps \
                        < n_pages
                    assert pps <= max(launch._PAGED_MAX_PPS, tp)
                    base = launch.paged_mma_tile(page) // page
                    if -(-n_pages // base) <= \
                            launch._PAGED_MMA_ONE_LAUNCH_TILES:
                        assert ns == 1


def test_mma_shared_memory_formula():
    """``paged_mma_smem`` is the source's ``mma_layout``: 1024 bytes of
    alignment slack, the ring (1024-byte stages of a K and a V tile and the
    int8 scales, up to 4 within 96 KiB, at least 2) or the key slices'
    outputs (rows padded by 8 floats, int8 16), maxima, sums and weights
    where larger, q (16 rows a row tile
    of Dh bf16 padded by 16 bytes), the barriers and key-visible bytes of
    4 stages, the page ids."""
    # G 48 (3 row tiles, 4 key slices), Dh 128, bf16, 64-key tiles: the
    # slices' outputs (4 x 48 x 128 floats) pass the 3-stage ring
    ring = 3 * 2 * 64 * 128 * 2
    merge = 4 * (4 * 48 * (128 + 8) + 4 * 48 * 2 + 48 * 4 + 2 * 48)
    assert merge > ring
    want = merge + 48 * (2 * 128 + 16) + 16 * 4
    want = -(-(want + 4 * 64) // 16) * 16 + 4 * 4 + 1024
    assert launch.paged_mma_smem(48, 128, 64, 4, 2, False) == want
    # G 7, Dh 256 over int8 pages (2 dim slices, 4 key slices): 2 stages
    # of 1024-byte-rounded K, V and scales, less than the padded outputs
    stage = -(-(2 * 64 * 256 + 8 * 64) // 1024) * 1024
    ring = 2 * stage
    merge = 4 * (4 * 16 * (256 + 16) + 4 * 16 * 2 + 16 * 4 + 2 * 16)
    assert merge > ring > 4 * (4 * 16 * 256)
    want = merge + 16 * (2 * 256 + 16) + 16 * 4
    want = -(-(want + 4 * 64) // 16) * 16 + 4 * 8 + 1024
    assert launch.paged_mma_smem(7, 256, 64, 8, 1, True) == want
    assert launch.paged_mma_warps(7, 256) == (1, 2, 4)
    assert launch.paged_mma_warps(48, 128) == (3, 1, 4)
    assert launch.paged_mma_warps(48, 256) == (3, 2, 2)


def _bf16(a):
    """``a`` rounded to bf16 (nearest even), back in f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float()


def _mma_emulation(q, kp, vp, table, lengths, *, window, softcap, scale,
                   k_scale=None, v_scale=None):
    """The tensor-core form's rounding, in torch on the CPU: q and bf16
    pages as bf16 values (int8 pages as their exact integers), S = q K^T
    summed in f32 with q unscaled, a key's K scale on its column, then
    scale log2(e) or softcap tanh(S scale / softcap) log2(e) in f32; P =
    2^(S - max) in f32 into the row sum, times a key's V scale and rounded
    to bf16 for P.V in f32. (The kernel takes the max per 16-key chunk as
    it goes and rescales; with the final max the rounding points differ by
    a power of two only.)"""
    b, hkv, g, dh = q.shape
    page = kp.shape[1]
    idx = table.long().clamp(0, kp.shape[0] - 1)
    k = kp.float()[idx].reshape(b, -1, hkv, dh)
    v = vp.float()[idx].reshape(b, -1, hkv, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k)
    if k_scale is not None:
        s = s * k_scale[idx].reshape(b, 1, 1, -1)
    log2e = 1.4426950408889634
    s = softcap * torch.tanh(s * scale / softcap) * log2e \
        if softcap is not None else s * (scale * log2e)
    kpos = torch.arange(k.shape[1])
    lens = lengths.long()[:, None]
    mask = kpos[None] < lens
    if window is not None:
        mask &= kpos[None] > (lens - 1) - window
    mask &= (table >= 0).repeat_interleave(page, dim=1)
    s = torch.where(mask[:, None, None], s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask[:, None, None], torch.exp2(s - m), 0.0)
    lsum = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[idx].reshape(b, 1, 1, -1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(torch.bfloat16).float(), v)
    return o / torch.where(lsum == 0, 1.0, lsum)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g", [7, 12, 48])
def test_mma_rounding_fits_the_bf16_gate(g, quant):
    """The tensor-core form's rounding (``_mma_emulation``: q unscaled in
    bf16, S in f32, then the scale or the softcap, P rounded to bf16 with
    the V scale folded in) against the JAX ``paged_decode_attention``
    through its plain route, at G 7, 12 and 48, Dh 128, softcap 50 and a
    window of 100, bf16 and int8 pages: within the card's bf16 gate (1e-2
    abs + rel), so the numerics fit it before the card runs."""
    from repro.serving.kv_cache import quantize_kv as jquantize_kv
    q, kp, vp, table, lengths = _grouped_inputs(g)
    q, kp, vp = (np.asarray(_bf16(a)) for a in (q, kp, vp))
    kw = dict(window=100, softcap=50.0)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    targs = [torch.from_numpy(np.array(a)) for a in (q, kp, vp, table,
                                                       lengths)]
    jkw, tkw = dict(kw), dict(kw)
    if quant:
        (k8, ks), (v8, vs) = jquantize_kv(jargs[1]), jquantize_kv(jargs[2])
        jargs[1:3] = k8, v8
        targs[1:3] = (torch.from_numpy(np.array(k8)),
                      torch.from_numpy(np.array(v8)))
        jkw.update(k_scale=ks, v_scale=vs)
        tkw.update(k_scale=torch.from_numpy(np.array(ks)),
                   v_scale=torch.from_numpy(np.array(vs)))
    ref = np.asarray(jpaged(*jargs, backend="xla", **jkw))
    got = _mma_emulation(*targs, scale=128 ** -0.5, **tkw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)
    assert (got[2] == 0).all()
    # the emulation is not the reference: P's rounding shows
    assert np.abs(got - ref).max() > 1e-6
