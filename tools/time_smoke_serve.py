#!/usr/bin/env python3
"""Time where ``chip_smoke.py``'s full-width serving phases, and the
phases this slice added, spend their seconds, on one card.

    python3 tools/time_smoke_serve.py [--phases 5e,5f,...] [--out FILE]

Builds the kernels, then runs the chosen phases (default: 5e, 5f, 5h, 5i,
5j, 5k, 5l, 5m, 5n and 5o, each at full width and depth, as the smoke runs
them) through the smoke's own ``serve``, ``serve_dense_loop``,
``ssm_dense_loop`` (after 5k and 5l) and ``top1_agreement``; or 6 (the
training junction kernels at seamless-m4t's and llava's training shapes,
``run_train_kernels``), 6c (the
attention kernels at ``FLASH_TRAIN_FORMS``, ``run_flash_forms``), 7e and
7f (``train`` of seamless-m4t-medium and of llava-next-34b at its card
depth) and 3f (the smoke's training of seamless-m4t's and llava's smoke
configurations and the dense-cache loop of mamba2's and zamba2's), with
timers around the helpers a phase calls: building
the model (``fresh_model``), the engines' construction, the served run
(``drain``; the dense-cache loop's ``generate``), the re-admitted request
(``readmission``), the kernels-vs-plain decode step (``launched_plans``
and the plain steps), the profiled steps (``profile_decode``, with the
trace's export, ``export_trace``, inside it) and the top-1 agreement. Each
phase prints one JSON line of seconds: its total and each helper's sum
(the rest of the total is the check engine's prefill and the checks); the
records go to ``--out`` (default ``chiprun_out/time_smoke_serve.json``).
An int8 phase (5f, 5j, 5m) needs its bf16 phase (5e, 5i, 5l) before it in
``--phases``. The card's name and power limit come first.
"""
import argparse
import functools
import gc
import json
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("5e", "5f", "5h", "5i", "5j", "5k", "5l", "5m", "5n", "5o")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "time_smoke_serve.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_smoke_serve: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.analysis.dispatch_pass import card_depth
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.nn.model import build_model
    from repro_torch.serving import engine

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    secs = defaultdict(float)

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                secs[name] += time.perf_counter() - t0
        return run

    for name in ("drain", "readmission", "profile_decode", "top1_agreement",
                 "launched_plans", "export_trace"):
        setattr(cs, name, timed(name, getattr(cs, name)))
    serve_cli.generate = timed("generate", serve_cli.generate)
    plain = cs.plain_versions

    @contextmanager
    def plain_steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain():
            yield
        torch.cuda.synchronize()
        secs["plain_steps"] += time.perf_counter() - t0

    cs.plain_versions = plain_steps
    engine.ServingEngine.__init__ = timed("engine_init",
                                          engine.ServingEngine.__init__)
    t0 = time.perf_counter()
    build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out" / "time_smoke_serve"
    out_dir.mkdir(parents=True, exist_ok=True)
    quant = QuantConfig(weights=True, kv=True)
    fresh = timed("fresh_model", lambda c: build_model(
        c, device=device,
        generator=torch.Generator(device=device).manual_seed(cs.SEED)))

    # the phases as chip_smoke.main runs them; a bf16 phase's model and
    # run stay for the int8 phase after it (top-1 agreement)
    g2cfg = get_config("gemma2_9b")
    g2 = dict(prompt_lens=cs.DENSE_PROMPTS + (cs.GEMMA2_LONG,),
              n_new=cs.DENSE_NEW, knobs=dict(
                  max_slots=5, total_pages=320,
                  max_pages_per_seq=-(-(cs.GEMMA2_LONG + cs.DENSE_NEW)
                                      // 16),
                  token_budget=1024, prefill_chunk=512))
    n_short = len(cs.DENSE_PROMPTS)
    dcfg = cs.deepseek_config().with_(param_dtype="bfloat16")
    zcfg = get_config("zamba2_1p2b")
    kept = {}

    def bf16(key, c, dense_loop=False, **kw):
        kept[key] = fresh(c)
        kept[key + "_run"] = run = cs.serve(kept[key], device, out_dir, **kw)
        if dense_loop:
            cs.ssm_dense_loop(kept[key], device, run[4], run[3])

    def ssm(model):
        run = cs.serve(model, device, out_dir)
        cs.ssm_dense_loop(model, device, run[4], run[3])

    def int8(key, c, n=None, **kw):
        m = fresh(c)
        cs.serve(m, device, out_dir, quant=quant, **kw)
        run = kept.pop(key + "_run")
        cs.top1_agreement(kept.pop(key), m, run[4][:n], run[3][:n], device,
                          quant)

    phases = {
        "5e": lambda: bf16("g2", g2cfg, **g2),
        "5f": lambda: int8("g2", g2cfg, n=n_short, **g2),
        "5h": lambda: cs.serve(fresh(get_config("granite_34b").with_(
            param_dtype="bfloat16")), device, out_dir,
            prompt_lens=cs.DENSE_PROMPTS, n_new=cs.DENSE_NEW),
        "5i": lambda: bf16("ds", dcfg),
        "5j": lambda: int8("ds", dcfg),
        "5k": lambda: ssm(fresh(get_config("mamba2_130m"))),
        "5l": lambda: bf16("z", zcfg, dense_loop=True),
        "5m": lambda: int8("z", zcfg),
        "5n": lambda: cs.serve_dense_loop(
            fresh(get_config("seamless_m4t_medium").with_(
                param_dtype="bfloat16")), device, out_dir,
            prompt_len=cs.SEAMLESS_PROMPT, frames=cs.SEAMLESS_FRAMES,
            n_new=cs.SEAMLESS_NEW, trace="decode_trace_seamless"),
        "5o": lambda: cs.serve_dense_loop(
            fresh(get_config("llava_next_34b").with_(
                param_dtype="bfloat16")), device, out_dir,
            prompt_len=cs.LLAVA_PATCHES, frames=cs.LLAVA_PATCHES,
            n_new=cs.LLAVA_NEW, trace="decode_trace_llava"),
        "6": lambda: (cs.run_train_kernels(
            get_config("seamless_m4t_medium"), device, [],
            rows=(cs.ENC_TRAIN_BATCH * cs.ENC_TRAIN_FRAMES,
                  cs.ENC_TRAIN_BATCH * cs.ENC_TRAIN_SEQ),
            dtypes=("bfloat16",)), cs.run_train_kernels(
            get_config("llava_next_34b"), device, [],
            dtypes=("bfloat16",))),
        "6c": lambda: cs.run_flash_forms(device, []),
        "7e": lambda: cs.train(
            device, get_config("seamless_m4t_medium"), out_dir,
            trace="train_trace_seamless", batch=cs.ENC_TRAIN_BATCH,
            seq=cs.ENC_TRAIN_SEQ, frames=cs.ENC_TRAIN_FRAMES,
            floor=True),
        "7f": lambda: cs.train(
            device, card_depth(get_config("llava_next_34b")), out_dir,
            trace="train_trace_llava", floor=True),
        "3f": lambda: (
            [cs.smoke_train_check(a) for a in ("seamless_m4t_medium",
                                               "llava_next_34b")],
            [cs.smoke_serve_dense(a, device) for a in ("mamba2_130m",
                                                       "zamba2_1p2b")]),
    }
    res = {}
    for name in args.phases.split(","):
        secs.clear()
        t0 = time.perf_counter()
        phases[name]()
        res[name] = dict(total=time.perf_counter() - t0, **secs)
        print(json.dumps({name: res[name]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    Path(args.out).write_text(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
