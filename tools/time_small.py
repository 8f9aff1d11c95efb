#!/usr/bin/env python3
"""Time the small-block forms of the junction kernels on one card.

    python3 tools/time_small.py [--src DIR] [--label NAME]

Times the forms of ``csrc/csd_spmm_small.cu`` that blocks whose bL or bR
is not a multiple of 64 run, at the junctions and with the inputs of
``chip_smoke.py`` phase 3d (``small_junctions`` and ``small_calls``), f32,
through the shipped wrappers; beside each, its library call (a dense
``torch.matmul`` or ``torch.bmm`` on the densified slab) and the bound.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so two versions of the kernels can be run in
turns (A, B, B, A) in one call on one card. Prints the card's
``nvidia-smi`` name and power limit, then one JSON record per case: device
ms per call (``chip_smoke.bench``: behind a sleep kernel, cycling through
phase 3d's copies of the data inputs), the plan's grid and the version's
label.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_small: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 30)
    f32 = torch.float32
    for name, bp, rows, opt in cs.small_junctions():
        for m in rows:
            copies = cs.small_copies(bp, m, f32, opt)
            for kernel, runs, _, libs, nbytes, ops in cs.small_calls(
                    bp, m, f32, gen, dev, copies=copies, **opt):
                iters = max(args.iters, copies)
                ms, _ = cs.bench(runs, iters)
                lib_ms, _ = cs.bench(libs, iters)
                bound_ms, bound_by = cs.bound(nbytes, ops, f32)
                print(json.dumps(dict(
                    kernel=kernel, junction=name, m=m, dtype="float32",
                    experts=opt.get("experts"),
                    block=[bp.block_in, bp.block_out], fan_in=bp.d_in_b,
                    ms=ms, library_ms=lib_ms, bound_ms=bound_ms,
                    bound_by=bound_by,
                    grid=cs.captured_plan(runs[0])["grid"],
                    label=args.label)), flush=True)
                del runs, libs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
