#!/usr/bin/env python3
"""Time the small-block forms of the junction kernels on one card.

    python3 tools/time_small.py [--src DIR] [--label NAME] [--splits]
                                [--kinds float32 int8]

Times the forms of ``csrc/csd_spmm_small.cu`` (forward and dx) and
``csrc/csd_spmm_small_dw.cu`` (dw) that blocks whose bL or bR is not a
multiple of 64 run, at the junctions and with the inputs of
``chip_smoke.py`` phase 3d (``small_junctions`` and ``small_calls``), f32,
through the shipped wrappers; beside each, its library call (a dense
``torch.matmul`` or ``torch.bmm`` on the densified slab) and the bound.
The ``int8`` kind times the int8 small-block forward (the gather kernel
over an int8 slab, ``csd_spmm_fwd_quant_small``) at phase 3d's int8 cases,
f32 and bf16 x, beside its plain version and the library call over the
dequantized dense slab; ``--kinds`` picks the kinds (default both).
``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so two versions of the kernels can be run in
turns (A, B, B, A) in one call on one card. ``--splits`` times each case
with the split forced (``launch.forced_small_split``): the forward and dx
with the gather kernel's fan-in over 1, 2, 4, 8 and 16 ranks of the CTA,
dw with its M over a cluster of 1, 2, 4 and 8 CTAs, the sweep the rules
``small_gather_split`` and ``small_dw_cluster`` are read off. Prints the card's ``nvidia-smi`` name and
power limit, then one JSON record per case: device ms per call
(``chip_smoke.bench``: behind a sleep kernel, cycling through phase 3d's
copies of the data inputs), the plan's grid and arguments and the
version's label.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPLITS = (1, 2, 4, 8, 16)
DW_SPLITS = (1, 2, 4, 8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--splits", action="store_true",
                    help="force each cluster size of the splits")
    ap.add_argument("--kinds", nargs="*", default=["float32", "int8"],
                    choices=["float32", "int8"])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_small: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import launch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 30)
    splits = SPLITS if args.splits else (None,)
    for name, bp, rows, opt in cs.small_junctions():
        int8 = "fwd_quant" in opt.get("ops", ())
        if ("int8" if int8 else "float32") not in args.kinds:
            continue
        for m in rows:
            for dtype_name in opt["dtypes"] if int8 else ("float32",):
                dtype = getattr(torch, dtype_name)
                copies = cs.small_copies(bp, m, dtype, opt)
                for kernel, runs, plains, libs, nbytes, ops in \
                        cs.small_calls(bp, m, dtype, gen, dev, copies=copies,
                                       **opt):
                    iters = max(args.iters, copies)
                    bound_ms, bound_by = cs.bound(nbytes, ops, dtype)
                    lib_ms = None if args.splits \
                        else cs.bench(libs, iters)[0]
                    plain_ms = cs.bench(plains[:2], 2)[0] \
                        if int8 and not args.splits else None
                    dw = kernel == "csd_spmm_dw_small"
                    for split in splits:
                        if split is not None and dw \
                                and split not in DW_SPLITS:
                            continue
                        force = contextlib.nullcontext() if split is None \
                            else launch.forced_small_split(
                                **{"dw" if dw else "gather": split})
                        with force:
                            ms, _ = cs.bench(runs, iters)
                            plan = cs.captured_plan(runs[0])
                        print(json.dumps(dict(
                            kernel=kernel, junction=name, m=m,
                            dtype=dtype_name, experts=opt.get("experts"),
                            block=[bp.block_in, bp.block_out],
                            fan_in=bp.d_in_b, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound_ms,
                            bound_by=bound_by, split=split,
                            grid=plan["grid"], args=plan.get("args"),
                            label=args.label)), flush=True)
                    del runs, plains, libs
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
