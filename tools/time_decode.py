#!/usr/bin/env python3
"""Time the paged decode attention kernels of the port on one card.

    python3 tools/time_decode.py [--src DIR] [--label NAME] [--iters N]
                                 [--splits] [--forms]
                                 [--shapes NAME,...] [--models NAME,...]
                                 [--kinds NAME,...]

Times TPU kernels #2 and #8b (``paged_decode_attention_cuda`` over bf16
pages and over int8 pages with per-token scales, q in bf16) through the
wrapper, as a caller would call it, from one seed, at the heads of
``chip_smoke.PAGED_SHAPES``: gemma3-4b's (Hkv 4, G 2, Dh 256; windowed
layers at window 1024), granite-moe-1b-a400m's (Hkv 8, G 2, Dh 64),
gemma2-9b's (Hkv 8, G 2, Dh 256, window 4096, softcap 50), qwen2-7b's (Hkv
4, G 7, Dh 128), granite-34b's (Hkv 1, G 48, Dh 128) and a group of 12
(Hkv 4, Dh 128), page 16, at three shapes:

- ``phase4``: ``chip_smoke.py`` phases 4 and 4b (B 4, lengths [1100, 517,
  0, 1040], a 72-page table; gemma3 with and without its window; gemma2's
  rows [4160, 517, 0, 4097] past its window, a 300-page table);
- ``serving``: a decode step of the serving runs (B 4, lengths 97-160, a
  10-page table);
- ``long``: B 4 rows of 8192 keys (a 512-page table, no window);
- ``empty``: B 4 empty rows over a 10-page table: what a call costs with
  no key to read (launch, prologue, epilogue).

The pages are cycled over enough copies to exceed the 50 MB L2, as phase
4 does. ``--src`` names the ``src`` directory whose ``repro_torch`` is
timed (default: this checkout's), so the same inputs and timing can be
run against two versions of the kernel: run one process per version in
turns (A, B, B, A) on one card and compare only the times of one such
sequence.

``--splits`` (this checkout's kernel only) times instead each shape with
the split forced (``launch.split_plan`` and ``mma_split_plan`` replaced
for the run): one
launch, and every pages-per-split from one tile up, so that the rule's
crossover can be read off; and the keys per tile halved and doubled at the
rule's split (in whole tiles the form takes: 16-key chunks for the
tensor-core form). Each record carries the rule's own pick (``rule_pps``).

``--forms`` (this checkout's kernel only) times each case on both forms of
the split kernel (``launch.forced_paged_form``: the CUDA-core
``paged_decode_kernel`` and, where it can take the case, the tensor-core
``paged_decode_mma_kernel``), each with its own split rule, in turns
(cores, mma, mma, cores) over the same inputs. ``--shapes`` and
``--models`` keep only the named shapes and models; ``--kinds`` names the
page kinds (default ``bfloat16,int8``; ``float32`` times f32 q over f32
pages, the CUDA-core form at every G).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
record per case: device µs per call (``chip_smoke.bench``: behind a sleep
kernel), the plain version's (``plain_us``), the bound
(``chip_smoke.paged_bound``: bytes), the share of the bound reached, SDPA
over the gathered KV with ``enable_gqa`` as ``library_us`` (the gather
made outside the timed call; no softcap), the plan's split kernel and
split, and the version's label.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SERVING_LENGTHS, SERVING_PAGES = (150, 97, 128, 160), 10
LONG_LENGTHS, LONG_PAGES = (8192,) * 4, 512
EMPTY_LENGTHS = (0,) * 4


def shapes():
    """(shape name, lengths, table pages, windows of each model)."""
    yield "phase4", None, None, lambda w: w
    yield "serving", SERVING_LENGTHS, SERVING_PAGES, lambda w: (None,)
    yield "long", LONG_LENGTHS, LONG_PAGES, lambda w: (None,)
    yield "empty", EMPTY_LENGTHS, SERVING_PAGES, lambda w: (None,)


def models(cs):
    """(model, Hkv, G, Dh, windows, softcap, phase-4 lengths and table
    pages) of ``chip_smoke.PAGED_SHAPES``."""
    for model, hkv, grp, dh, windows, cap, lens, pages in cs.PAGED_SHAPES:
        yield model, hkv, grp, dh, windows, cap, dict(lengths=lens,
                                                      n_pages=pages)


@contextlib.contextmanager
def forced_split(launch, keys_per_tile: int, pages_per_split: int):
    """The paged-decode plans of either form take this tile and split for
    the run."""
    real = launch.split_plan, launch.mma_split_plan

    def forced(b, hkv, g, dh, page_size, n_pages, page_itemsize, n_sm):
        return (keys_per_tile, pages_per_split,
                -(-n_pages // pages_per_split))
    launch.split_plan = launch.mma_split_plan = forced
    launch.paged_decode_plan.cache_clear()
    try:
        yield
    finally:
        launch.split_plan, launch.mma_split_plan = real
        launch.paged_decode_plan.cache_clear()


def sweep(n_pages: int, page: int, kt: int, pps: int, chunk: int = 1):
    """(keys per tile, pages per split) to force: one split, then one
    tile and up (doubling), then the rule's split with the tile halved and
    doubled (whole pages and whole chunks of ``chunk`` keys, the split a
    multiple of the tile)."""
    tp = kt // page
    out = [(kt, -(-n_pages // tp) * tp)]
    k = 1
    while k * tp < n_pages:
        out.append((kt, k * tp))
        k *= 2
    for t in (tp // 2, 2 * tp):
        if t >= 1 and (t * page) % chunk == 0:
            out.append((t * page, -(-pps // t) * t))
    return list(dict.fromkeys(out))




def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--shapes", default="")
    ap.add_argument("--models", default="")
    ap.add_argument("--kinds", default="bfloat16,int8")
    args = ap.parse_args(argv)
    keep_shapes = set(filter(None, args.shapes.split(",")))
    keep_models = set(filter(None, args.models.split(",")))
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launch
    from repro_torch.serving.kv_cache import quantize_kv
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    bf16 = torch.bfloat16
    for shape, lengths, n_pages, windows_of in shapes():
        if keep_shapes and shape not in keep_shapes:
            continue
        for model, hkv, grp, dh, windows, cap, p4 in models(cs):
            if keep_models and model not in keep_models:
                continue
            geo = p4 if lengths is None else dict(lengths=lengths,
                                                  n_pages=n_pages)
            for window in windows_of(windows):
                q, kp, vp, table, lens = cs.paged_inputs(
                    dev, torch.float32, window, gen, hkv, dh, grp=grp,
                    **geo)
                q32 = q
                for kind in args.kinds.split(","):
                    q = q32 if kind == "float32" else q32.to(bf16)
                    if kind == "int8":
                        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
                        pages, scales = (k8, v8, ks, vs), (ks, vs)
                    else:
                        pages, scales = (kp.to(q.dtype), vp.to(q.dtype)), None
                    nbytes = sum(t.numel() * t.element_size() for t in pages)
                    pools = [tuple(t.clone() for t in pages)
                             for _ in range(cs.copies_for(nbytes))]

                    def kw_of(p):
                        kw = dict(window=window, softcap=cap)
                        if len(p) == 4:
                            kw.update(k_scale=p[2], v_scale=p[3])
                        return kw

                    def call(p):
                        return fa.paged_decode_attention_cuda(
                            q, p[0], p[1], table, lens, **kw_of(p))

                    def plain(p):
                        return fa.paged_decode_attention_plain(
                            q, p[0], p[1], table, lens, **kw_of(p))

                    def split_of(p):
                        return cs.paged_split(
                            fa.paged_decode_attention_cuda, q, p[0], p[1],
                            table, lens, **kw_of(p))
                    sdpa, visible = cs.paged_yardstick(
                        q, pages[0], pages[1], table, lens, window, scales)
                    lib_ms, _ = cs.bench([sdpa], args.iters)
                    plain_ms, _ = cs.bench([lambda p=p: plain(p)
                                            for p in pools[:2]], 10)
                    bound_ms, bound_by = cs.paged_bound(
                        q, table, lens, visible, kind == "int8")
                    rule = split_of(pools[0])
                    base = dict(label=args.label, shape=shape, model=model,
                                kind=kind, hkv=hkv, g=grp, dh=dh,
                                window=window, softcap=cap,
                                b=len(lens), n_pages=table.shape[1],
                                visible=visible, bound_us=bound_ms * 1e3,
                                bound_by=bound_by, plain_us=plain_ms * 1e3,
                                library_us=lib_ms * 1e3)
                    forced = [(None, None)]
                    if args.splits:
                        mma = rule["split_kernel"] \
                            == "paged_decode_mma_kernel"
                        forced = sweep(table.shape[1], kp.shape[1],
                                       rule["keys_per_tile"],
                                       rule["pages_per_split"],
                                       16 if mma else 1)
                    # --forms: each form in turns (the tensor-core one
                    # where it can take the case)
                    for form in (["cores", "mma", "mma", "cores"]
                                 if args.forms else [None]):
                        for kt, pps in forced:
                            form_ctx = contextlib.nullcontext() \
                                if form is None \
                                else launch.forced_paged_form(form)
                            ctx = contextlib.nullcontext() if kt is None \
                                else forced_split(launch, kt, pps)
                            with form_ctx, ctx:
                                try:
                                    plan = split_of(pools[0])
                                except ValueError:  # not this form's case
                                    continue
                                ms, host_ms = cs.bench(
                                    [lambda p=p: call(p) for p in pools],
                                    args.iters)
                            rec = dict(base, us=ms * 1e3,
                                       host_us=host_ms * 1e3,
                                       bound_share=bound_ms / ms, **plan)
                            if args.splits:
                                rec["rule_pps"] = rule["pages_per_split"]
                                rec["rule_kt"] = rule["keys_per_tile"]
                            if form is not None:
                                rec["forced_form"] = form
                            print(json.dumps(rec), flush=True)
                    del pools, sdpa
                del q, q32, kp, vp
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
