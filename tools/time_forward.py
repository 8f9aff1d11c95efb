#!/usr/bin/env python3
"""Time the junction forward kernel of the port on one card.

    python3 tools/time_forward.py [--src DIR] [--label NAME]
                                  [--bodies [--rows M ...] | --epilogues]

Times TPU kernels #1 (``csd_spmm_fwd_cuda``) and #3
(``csd_spmm_fwd_batched_cuda``) in bf16 through their wrappers, as a
caller would call them, from one seed: at gemma3-4b's training shapes (M =
2 x 2048 tokens; the gate junction with its gelu and ``save_preact``, the
down junction without), at granite-moe-1b-a400m's (32 experts of 1280
rows; up/gate without and with gelu and ``save_preact``, down), and at
gemma3-4b's decode (M 4) and prefill (M 256) junctions. The weight slab is
cycled over enough copies to exceed the 50 MB L2, as ``chip_smoke.py``'s
phase 3 does. ``--src`` names the ``src`` directory whose ``repro_torch``
is timed (default: this checkout's), so the same inputs and timing can be
run against two versions of the kernel: run one process per version in
turns (A, B, B, A) on one card and compare only the times of one such
sequence.

``--bodies`` (this checkout's kernel only) times instead each body of the
forward forced at the same inputs (``launch.forced_body`` for the run:
0 the grid body, 64/128/256 the wgmma body at that tile width):
gemma3-4b's gate and down junctions at M 4 to 4096, granite-moe's up/gate
and down at 4, 64, 256 and 1280 rows per expert, and both at a speculative
verify chunk's M 20 and 40 (4 and 8 slots of 1 + 4 tokens; granite-moe's
dropless serving capacity gives each expert as many rows as tokens), so
that the rule between the bodies and the tile width can be read off; each
record carries the rule's pick (``rule_tile_n``); ``--rows`` keeps only
those M (rows per expert for granite-moe).
``--epilogues`` times instead gemma3-4b's gate and granite-moe's up/gate
training junctions with each epilogue: no activation or gelu, with and
without ``save_preact``, so that the epilogue's share can be read off.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
record per case: device ms per call (``chip_smoke.bench``: behind a sleep
kernel), the bound, the library call's ms (``torch.matmul`` /
``torch.bmm`` over the densified slab) and the version's label.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rows", type=int, nargs="*",
                    help="with --bodies: only these M")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--bodies", action="store_true")
    mode.add_argument("--epilogues", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_forward: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import csd_spmm
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    up, down = cs.junction_patterns(get_config("gemma3_4b"))
    gcfg = cs.granite_training_config()
    g_up, g_down = cs.expert_patterns(gcfg)
    n_exp = gcfg.moe.n_routed
    c = cs.expert_capacity(gcfg, cs.TRAIN_M)
    bf16 = torch.bfloat16
    gate, gelu = ("gate", up, "gelu"), ("down", down, None)
    if args.bodies:
        rows = [("gemma3-4b", (), m, (gate, gelu))
                for m in (4, 16, 20, 32, 40, 64, 128, 256, 512, 1024,
                          2048, cs.TRAIN_M)]
        rows += [("granite-moe-1b-a400m", (n_exp,), m,
                  (("up/gate", g_up, None), ("down", g_down, None)))
                 for m in (4, 20, 40, 64, 256, c)]
        if args.rows:
            rows = [r for r in rows if r[2] in args.rows]
    elif args.epilogues:
        rows = [("gemma3-4b", (), cs.TRAIN_M,
                 tuple(("gate", up, a) for a in (None, "gelu"))),
                ("granite-moe-1b-a400m", (n_exp,), c,
                 tuple(("up/gate", g_up, a) for a in (None, "gelu")))]
    else:
        rows = [("gemma3-4b", (), cs.TRAIN_M, (gate, gelu)),
                ("granite-moe-1b-a400m", (n_exp,), c,
                 (("up/gate", g_up, None), ("up/gate", g_up, "gelu"),
                  ("down", g_down, None))),
                ("gemma3-4b", (), 4, (gate, gelu)),
                ("gemma3-4b", (), 256, (gate, gelu))]
    for model, lead, m, cases in rows:
        fn = getattr(csd_spmm, f"csd_spmm_fwd{'_batched' if lead else ''}"
                     f"_cuda")
        for name, bp, act in cases:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev)
            shape = lead + (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
            x = randn(*lead, m, bp.n_in).to(bf16)
            n = cs.copies_for(2 * math.prod(shape))
            ws = [(randn(*shape) / math.sqrt(bp.d_in_b * bp.block_in))
                  .to(bf16) for _ in range(n)]
            idx = torch.as_tensor(bp.block_idx, dtype=torch.int32,
                                  device=dev)
            dense = cs.dense_of_experts(bp, ws[0]) if lead \
                else cs.dense_of(bp, ws[0])
            mul = torch.bmm if lead else torch.matmul
            lib_ms, _ = cs.bench([lambda: mul(x, dense)], args.iters)
            del dense
            # the training forward saves z where the backward needs it
            for sp in (False, True) if args.epilogues else (act == "gelu",):
                time_case(args, dict(model=model, junction=name, m=m), fn, bp,
                          act, sp, x, ws, idx, lib_ms)
            del x, ws
            torch.cuda.empty_cache()
    return 0


def time_case(args, rec, fn, bp, act, save_preact, x, ws, idx,
              lib_ms) -> None:
    """Time one junction forward (with ``--bodies`` each body) on ``x``
    (the expert-batched form where it is 3-D), cycling over the slabs
    ``ws``, and print its records."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import launch
    batched = x.dim() == 3
    e, m = (x.shape[0] if batched else 1), x.shape[-2]
    n_w = ws[0].numel()
    n_y = e * m * bp.n_out
    nbytes = 2 * (x.numel() + n_w + (1 + save_preact) * n_y) \
        + 4 * idx.numel()
    bound_ms, bound_by = cs.bound(nbytes, 2 * m * n_w, torch.bfloat16)
    bodies, rule = [None], None
    if args.bodies:
        bodies = [0] + [t for t in (64, 128, 256) if bp.block_out % t == 0]
        rule = launch.fwd_tile_n("bfloat16", e, m, bp.n_rb, bp.block_out,
                                 launch.sm_count(x.device))
    calls = [lambda w=w: fn(x, w, idx, activation=act,
                            save_preact=save_preact) for w in ws]
    for tile_n in bodies:
        with contextlib.nullcontext() if tile_n is None else \
                launch.forced_body(launch.body_of_tile_n(tile_n),
                                   quant=False):
            ms, host_ms = cs.bench(calls, args.iters)
        print(json.dumps(dict(
            label=args.label, kernel="csd_spmm_fwd"
            + ("_batched" if batched else ""), **rec, activation=act,
            save_preact=save_preact, w_shape=list(ws[0].shape),
            tile_n=tile_n, rule_tile_n=rule, ms=ms, host_ms=host_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)),
            flush=True)



if __name__ == "__main__":
    sys.exit(main())
