#!/usr/bin/env python3
"""Time the full-sequence attention kernels of the port on one card.

    python3 tools/time_attention.py [--src DIR] [--label NAME]

Times TPU kernel #8's forward (``flash_attention_cuda``) and its backward
(``flash_attention_bwd_cuda``: dq, then dk/dv) in bf16 at
``chip_smoke.py`` phase 6c's training shapes (batch 2 x seq 2048, causal):
gemma3-4b's global and local (window 1024) layers (Hq 8, Hkv 4, Dh 256)
and granite-moe-1b-a400m's (Hq 16, Hkv 8, Dh 64), each through its wrapper
as a caller would call it, from one seed; the backward from the forward's
own o and lse. ``--src`` names the ``src`` directory whose ``repro_torch``
is timed (default: this checkout's), so the same inputs and timing can be
run against two versions of the kernels: run one process per version in
turns (A, B, B, A) on one card and compare only the times of one such
sequence. Prints the card's ``nvidia-smi`` name and power limit, then one
JSON record per case: device ms per call (``chip_smoke.bench``: behind a
sleep kernel), the bound (``chip_smoke.bound``: 4 Dh operations per visible
pair forward, 10 backward), the share of the bound reached and the
version's label.
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
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    bf16 = torch.bfloat16
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    for model, hq, hkv, dh, windows in cs.FLASH_SHAPES:
        def randn(*size):
            return torch.randn(size, generator=gen, device=dev).to(bf16)
        q, do = randn(b, s, hq, dh), randn(b, s, hq, dh)
        k, v = randn(b, s, hkv, dh), randn(b, s, hkv, dh)
        for window in windows:
            kw = dict(window=window)
            o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
            pairs = b * hq * cs.visible_pairs(s, window)
            n_q, n_kv = b * s * hq * dh, b * s * hkv * dh
            n_lse = 4 * b * hq * s
            for kernel, run, nbytes, ops in (
                    ("flash_attention",
                     lambda: fa.flash_attention_cuda(q, k, v, **kw),
                     2 * (2 * n_q + 2 * n_kv) + n_lse, 4 * dh * pairs),
                    ("flash_attention_bwd",
                     lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                         **kw),
                     2 * (4 * n_q + 4 * n_kv) + n_lse, 10 * dh * pairs)):
                ms, host_ms = cs.bench([run], args.iters)
                bound_ms, bound_by = cs.bound(nbytes, ops, bf16)
                print(json.dumps(dict(
                    label=args.label, model=model, kernel=kernel, b=b, s=s,
                    hq=hq, hkv=hkv, dh=dh, window=window,
                    visible_pairs=pairs, ms=ms, host_ms=host_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    bound_share=bound_ms / ms)), flush=True)
            del o, lse
        del q, k, v, do
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
