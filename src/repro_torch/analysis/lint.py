"""sparselint CLI of the port: ``python -m repro_torch.analysis.lint``.

Runs three passes over every shipped kernel and registered config:

* grid pass     — SL1xx: the CUDA launch plans the wrappers build (races,
                  divisibility, epilogue placement, shared memory, bounds)
                  at demo and full-width shapes; static, runs anywhere
* dispatch pass — SL2xx: host syncs, wide dtypes and whole-slab int8
                  upcasts in the paged serving steps and the training step,
                  at the smoke size on the CPU and at full width on the card
* pattern pass  — SL3xx: BlockPattern / partition invariants of every
                  junction of every config, smoke and full size; static

``--device`` (default ``cuda``) is where the dispatch pass runs its steps;
on the card the grid pass also plans for the card's SM count and checks
shared memory against its opt-in limit. Exits 1 on any unsuppressed finding
or pass error (a step the linter cannot run is not a certified step).
``--selftest-inject`` adds TPU kernel #9's counterpart, the race-broken
copy of ``csd_spmm_fwd`` (SL101 from the grid pass), and a
whole-slab-dequantizing junction (SL206 from the dispatch pass), and must
make the lint fail; on the card it also launches the race-broken kernel
once and reports its error against the plain version beside the shipped
kernel's, as evidence that SL101 flags a real wrong answer (on the CPU its
plan is captured and nothing is launched).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static certifier of the port's CUDA launch plans, "
                    "serving and training steps, and BlockPattern "
                    "invariants")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--output", default=None,
                    help="write the report to this file as well as stdout")
    ap.add_argument("--passes", default="grid,dispatch,pattern",
                    help="comma list from {grid,dispatch,pattern}")
    ap.add_argument("--configs", default=None,
                    help="comma list of arch names (default: all registered)")
    ap.add_argument("--smem-budget", type=int, default=None,
                    help="grid-pass shared memory per CTA in bytes (default: "
                         "the card's opt-in limit, 232448 on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="where the dispatch pass runs the steps (cuda: "
                         "full width; cpu: the smoke size)")
    ap.add_argument("--no-suppress", action="store_true",
                    help="ignore the checked-in suppression table")
    ap.add_argument("--selftest-inject", action="store_true",
                    help="add a race-broken kernel and a whole-slab upcast; "
                         "the lint MUST fail")
    args = ap.parse_args(argv)

    import torch

    from ..kernels import launch
    from ..nn.common import resolve_device
    from . import dispatch_pass, grid_pass, pattern_pass
    from .findings import Report, apply_suppressions
    from .suppressions import SUPPRESSIONS

    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = set(passes) - {"grid", "dispatch", "pattern"}
    if unknown:
        ap.error(f"unknown pass(es): {sorted(unknown)}")
    configs = [c.strip() for c in args.configs.split(",")] \
        if args.configs else None
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    report = Report()
    t0 = time.perf_counter()
    if "grid" in passes:
        budget = args.smem_budget or (
            getattr(torch.cuda.get_device_properties(device),
                    "shared_memory_per_block_optin",
                    grid_pass.DEFAULT_SMEM_BUDGET) if on_card
            else grid_pass.DEFAULT_SMEM_BUDGET)
        n_sm = launch.sm_count(device) if on_card else launch.H100_SMS
        f, cost, covered = grid_pass.run(smem_budget=budget,
                                         inject=args.selftest_inject,
                                         n_sm=n_sm)
        report.extend(f)
        report.cost.update(cost)
        report.covered["grid"] = covered
        if args.selftest_inject and on_card:
            ev = grid_pass.injected_alias_evidence(device)
            report.notes.append(
                f"{ev['kernel']} launched on "
                f"{torch.cuda.get_device_name(device)} at x "
                f"{tuple(ev['shape'][0])}, w {tuple(ev['shape'][1])} f32, "
                f"{ev['n_splits']} splits: max |error| vs the plain version "
                f"{ev['max_abs_err']:.6g}; the shipped csd_spmm_fwd at the "
                f"same split {ev['shipped_max_abs_err']:.6g} (tolerance "
                f"{ev['tolerance']:.3g})")
            if not (ev["race_shows"] and ev["shipped_within"]):
                report.errors.append(
                    f"the injected race did not show on the card as "
                    f"expected: {ev}")
        report.seconds["grid"] = time.perf_counter() - t0
    if "pattern" in passes:
        t0 = time.perf_counter()
        f, covered = pattern_pass.run(configs)
        report.extend(f)
        report.covered["pattern"] = covered
        report.seconds["pattern"] = time.perf_counter() - t0
    if "dispatch" in passes:
        t0 = time.perf_counter()
        f, covered, errors = dispatch_pass.run(
            configs, device=str(device), inject=args.selftest_inject)
        report.extend(f)
        report.covered["dispatch"] = covered
        report.errors.extend(errors)
        report.seconds["dispatch"] = time.perf_counter() - t0

    if not args.no_suppress:
        report.findings = apply_suppressions(report.findings, SUPPRESSIONS)

    out = report.to_json() if args.format == "json" else report.to_text()
    print(out)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(out + "\n")

    return 1 if (report.unsuppressed() or report.errors) else 0


if __name__ == "__main__":
    sys.exit(main())
