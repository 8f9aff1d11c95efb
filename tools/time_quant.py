#!/usr/bin/env python3
"""Time the int8 junction forward of the port on one card.

    python3 tools/time_quant.py [--src DIR] [--label NAME] [--rows M ...]
                                [--bodies | --splits]

Times TPU kernels #4 (``csd_spmm_fwd_quant_cuda``, through
``csd_spmm_fwd_cuda`` with ``w_scale``) and #5
(``csd_spmm_fwd_quant_batched_cuda``, through ``csd_spmm_fwd_batched_cuda``)
with bf16 x through their wrappers, as a caller would call them, from one
seed: gemma3-4b's up/gate junction (with its gelu) and down junction at M =
4 (a decode step's four slots), 20 and 40 (a speculative verify chunk of
4 and 8 slots of 1 + 4 tokens) and 16, 32, 64, 128 and 256 (prefill: four
slots of 4- to 64-token chunks), and granite-moe-1b-a400m's up/gate and
down expert junctions (32 experts, 128 x 256 blocks) at as many rows per
expert (its dropless serving capacity; ``--rows`` sets them). The int8 slabs (and the
slabs of the yardsticks) are cycled over enough copies to exceed the 50 MB
L2, as ``chip_smoke.py``'s phase 4b does. Beside each kernel time: the bound
(the int8 slab, its scales, x, y and the pattern once over 3.35 TB/s, or
the products over the bf16 peak), the library call's time (``torch.matmul``
/ ``torch.bmm`` over the densified slab dequantized to bf16) and the bf16
forward's time at the same inputs (``csd_spmm_fwd_cuda`` /
``csd_spmm_fwd_batched_cuda`` over the dequantized bf16 slab).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so the same inputs and timing can be run
against two versions of the kernel: run one process per version in turns
(A, B, B, A) on one card and compare only the times of one such sequence.

``--bodies`` (this checkout's kernel only) times instead each body the
int8 forward has for bf16 x forced at the same inputs (``launch.forced_body``
for the run): the stream body at its smallest row tile holding M
(up to 64 rows) and the wgmma body at each width of 64 and 128 dividing bR,
so that the rule between the bodies can be read off; ``--splits`` times the
stream body at every cluster size from 1 to min(8, fan-in), for the
cluster rule. Each record carries the rule's pick.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
record per case: device ms per call (``chip_smoke.bench``: behind a sleep
kernel), the body the plan ran, the bound and its share, the library's and
the bf16 forward's ms, and the version's label.
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
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rows", type=int, nargs="*",
                    default=[4, 16, 20, 32, 40, 64, 128, 256])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--bodies", action="store_true")
    mode.add_argument("--splits", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_quant: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.quant import dequantize_slab, quantize_slab
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 22)
    up, down = cs.junction_patterns(get_config("gemma3_4b"))
    gcfg = cs.granite_serving_config()
    g_up, g_down = cs.expert_patterns(gcfg)
    n_exp = gcfg.moe.n_routed
    bf16 = torch.bfloat16
    rows = [("gemma3-4b", (), (("up/gate", up, "gelu"), ("down", down,
                                                          None)))]
    rows += [("granite-moe-1b-a400m", (n_exp,),
              (("up/gate", g_up, None), ("down", g_down, None)))]
    for model, lead, cases in rows:
        for name, bp, act in cases:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev)
            shape = lead + (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
            n_w = math.prod(shape)
            slabs = [quantize_slab(randn(*shape)
                                   / math.sqrt(bp.d_in_b * bp.block_in))
                     for _ in range(cs.copies_for(n_w))]
            wide = [dequantize_slab(q, s, bf16)
                    for q, s in slabs[:cs.copies_for(2 * n_w)]]
            dense = cs.dense_of_experts(bp, wide[0]) if lead \
                else cs.dense_of(bp, wide[0])
            denses = [dense] + [dense.clone() for _ in range(
                cs.copies_for(dense.numel() * 2) - 1)]
            idx = torch.as_tensor(bp.block_idx, dtype=torch.int32,
                                  device=dev)
            for m in args.rows:
                x = randn(*lead, m, bp.n_in).to(bf16)
                time_case(args, dict(model=model, junction=name, m=m), bp,
                          act, x, slabs, wide, denses, idx)
                del x
            del slabs, wide, dense, denses
            torch.cuda.empty_cache()
    return 0


def body_of(fn, x, w, idx, **kw) -> dict:
    """The launches the plan of this call runs (captured, not launched):
    kernel, grid, cluster and the plan's body arguments."""
    from repro_torch.analysis.capture import capture_launch
    from repro_torch.kernels import launch
    plan = capture_launch(fn, x, w, idx.cpu(),
                          n_sm=launch.sm_count(x.device), **kw)
    a = plan.args
    return dict(kernels=[ln.kernel for ln in plan.launches],
                grid=[list(ln.grid) for ln in plan.launches],
                cluster=[list(getattr(ln, "cluster", (1, 1, 1)))
                         for ln in plan.launches],
                tile_m=a.get("tile_m"), tile_n=a.get("tile_n"),
                n_splits=plan.n_splits)


def time_case(args, rec, bp, act, x, slabs, wide, denses, idx) -> None:
    """Time the int8 forward (with ``--bodies`` or ``--splits`` each forced
    body or cluster) on ``x`` (the expert-batched form where it is 3-D),
    cycling over ``slabs``, beside the library and the bf16 forward, and
    print its records."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import csd_spmm, launch
    batched = x.dim() == 3
    e, m = (x.shape[0] if batched else 1), x.shape[-2]
    fn = csd_spmm.csd_spmm_fwd_batched_cuda if batched \
        else csd_spmm.csd_spmm_fwd_cuda
    n_w = slabs[0][0].numel()
    n_blocks = slabs[0][1].numel()
    nbytes = n_w + 4 * n_blocks + 2 * (x.numel() + e * m * bp.n_out) \
        + 4 * idx.numel()
    bound_ms, bound_by = cs.bound(nbytes, 2 * m * n_w, torch.bfloat16)
    calls = [lambda q=q, s=s: fn(x, q, idx, activation=act, w_scale=s)
             for q, s in slabs]
    mul = torch.bmm if batched else torch.matmul
    lib_ms, _ = cs.bench([lambda d=d: mul(x, d) for d in denses],
                         args.iters)
    bf16_ms, _ = cs.bench([lambda w=w: fn(x, w, idx, activation=act)
                           for w in wide], args.iters)
    forced = [None]
    rule = None
    if args.bodies or args.splits:
        rule = launch.quant_body("bfloat16", e, m, bp.n_rb, bp.d_in_b,
                                 bp.block_out, launch.sm_count(x.device))
    if args.bodies:
        forced = [(launch.BODY_WGMMA, 128, t, 1) for t in (64, 128)
                  if bp.block_out % t == 0]
        if m <= 64 and bp.block_out % 128 == 0:
            tm = next(t for t in (16, 32, 64) if m <= t)
            forced.insert(0, (launch.BODY_STREAM, tm, 128,
                              launch.stream_cluster(e, bp.n_out, bp.d_in_b,
                                                    launch.sm_count(
                                                        x.device))))
    elif args.splits:
        if rule[0] != launch.BODY_STREAM:
            return
        forced = [rule[:3] + (c,)
                  for c in range(1, min(8, bp.d_in_b) + 1)]
    for body in forced:
        with contextlib.nullcontext() if body is None else \
                launch.forced_body(body):
            ms, host_ms = cs.bench(calls, args.iters)
            q, s = slabs[0]
            info = body_of(fn, x, q, idx, activation=act, w_scale=s)
        print(json.dumps(dict(
            label=args.label, kernel="csd_spmm_fwd_quant"
            + ("_batched" if batched else ""), **rec, activation=act,
            w_shape=list(slabs[0][0].shape), **info,
            forced=list(body) if body else None,
            rule=list(rule) if rule else None, ms=ms, host_ms=host_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            bound_share=bound_ms / ms, library_ms=lib_ms,
            bf16_forward_ms=bf16_ms)), flush=True)



if __name__ == "__main__":
    sys.exit(main())
