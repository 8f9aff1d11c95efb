#!/usr/bin/env python3
"""Time the junction backward kernels of the port on one card.

    python3 tools/time_backward.py [--src DIR] [--label NAME]

Times TPU kernels #6 (``csd_spmm_dx_cuda``) and #7 (``csd_spmm_dw_cuda``)
in bf16 at gemma3-4b's training shapes (M = 2 x 2048 tokens; the gate
junction with its gelu mask, the down junction without) and their
expert-batched forms at granite-moe-1b-a400m's (32 experts of 1280 rows;
up/gate with and without the gelu mask, down), each through its wrapper as
a caller would call it, from one seed. ``--src`` names the ``src``
directory whose ``repro_torch`` is timed (default: this checkout's), so the
same inputs and timing can be run against two versions of the kernels:
run one process per version in turns (A, B, B, A) on one card and compare
only the times of one such sequence. Prints the card's ``nvidia-smi`` name
and power limit, then one JSON record per case: device ms per call
(``chip_smoke.bench``: behind a sleep kernel, inputs cycled past the L2),
the bound and the version's label.
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_backward: no CUDA device", file=sys.stderr)
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
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    up, down = cs.junction_patterns(get_config("gemma3_4b"))
    gcfg = cs.granite_training_config()
    g_up, g_down = cs.expert_patterns(gcfg)
    n_exp = gcfg.moe.n_routed
    c = cs.expert_capacity(gcfg, cs.TRAIN_M)
    bf16 = torch.bfloat16
    for model, lead, m, cases in (
            ("gemma3-4b", (), cs.TRAIN_M,
             (("gate", up, "gelu"), ("down", down, None))),
            ("granite-moe-1b-a400m", (n_exp,), c,
             (("up/gate", g_up, None), ("up/gate", g_up, "gelu"),
              ("down", g_down, None)))):
        form = "_batched" if lead else ""
        for name, bp, act in cases:
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev)
            shape = lead + (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
            n_w = math.prod(shape)
            x = randn(*lead, m, bp.n_in).to(bf16)
            w = (randn(*shape) / math.sqrt(bp.d_in_b * bp.block_in)).to(bf16)
            dy = randn(*lead, m, bp.n_out).to(bf16)
            aux = randn(*lead, m, bp.n_out).to(bf16) if act else None
            pat = {k: torch.as_tensor(getattr(bp, k), dtype=torch.int32,
                                      device=dev)
                   for k in ("block_idx", "out_idx", "out_slot")}
            dx_fn = getattr(csd_spmm, f"csd_spmm_dx{form}_cuda")
            dw_fn = getattr(csd_spmm, f"csd_spmm_dw{form}_cuda")
            n_x, n_y = x.numel(), dy.numel()
            n_aux = n_y if act else 0
            for kernel, run, nbytes in (
                    ("csd_spmm_dx", lambda: dx_fn(
                        dy, w, pat["out_idx"], pat["out_slot"], aux=aux,
                        activation=act), 2 * (n_y + n_aux + n_w + n_x)),
                    ("csd_spmm_dw", lambda: dw_fn(
                        x, dy, pat["block_idx"], block_in=bp.block_in,
                        block_out=bp.block_out, aux=aux, activation=act),
                     2 * (n_x + n_y + n_aux + n_w))):
                ms, host_ms = cs.bench([run], args.iters)
                bound_ms, bound_by = cs.bound(nbytes, 2 * m * n_w, bf16)
                print(json.dumps(dict(
                    label=args.label, model=model, kernel=kernel + form,
                    junction=name, activation=act, m=m, w_shape=list(shape),
                    ms=ms, host_ms=host_ms, bound_ms=bound_ms,
                    bound_by=bound_by)), flush=True)
            del x, w, dy, aux
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
