#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. print the card (``nvidia-smi`` name and power limit) and the torch
   version; turn TF32 off so that f32 references run in full f32;
2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once), and count the HGMMA (wgmma) and
   UTMALDG (TMA load) instructions in the forward, int8 forward, dx, dw
   and flash-attention libraries' SASS (none fails the run), and the HMMA
   (mma.sync) and LDGSTS (cp.async) instructions of the forward's wgmma
   body (bf16 and int8 weights) and the bf16 flash-attention kernels (any
   fails it); read every paged decode kernel form's (the CUDA-core
   ``paged_decode_kernel`` and the tensor-core ``paged_decode_mma_kernel``,
   which must be there), every form of the int8 forward's decode body's
   and of the small-block gather kernel's registers per thread from the
   compiler's ``-Xptxas -v`` log (any spill of the first two and of the
   gather kernel's one-CTA int8 forms fails the run);
3. hold ``csd_spmm_fwd`` against its plain version at gemma3-4b's junction
   shapes (up/gate and down, decode M = 4 and prefill M = 256, f32 and
   bf16) and at the dense decoders' (gemma2-9b, qwen2-7b, granite-34b:
   fan-ins 7-74, M 4 and 256, bf16), and time kernel, plain version, bound
   and a dense ``torch.matmul`` yardstick; each forward record of phases
   3, 3c, 4b, 6 and 6b names the body its plan runs (the grid body or the
   wgmma body and its tile);
4. the same for ``paged_decode_attention`` (B = 4, Hkv = 4, G = 2, Dh = 256,
   page 16, lengths past 1024, window None and 1024, -1 table entries and an
   empty row), with SDPA over the gathered KV (``enable_gqa``) as the
   yardstick, and again at granite-moe-1b-a400m's heads (Hkv = 8, G = 2,
   Dh = 64, no window), gemma2-9b's (Hkv 8, G 2, Dh 256, softcap 50,
   window 4096 over rows past it), qwen2-7b's (Hkv 4, G 7, Dh 128),
   granite-34b's (Hkv 1, G 48, Dh 128) and a group of 12: in bf16 these
   three run the tensor-core form (``paged_decode_mma_kernel``), in f32
   the CUDA-core form, and a case that runs another split kernel than
   ``launch.paged_rule`` gives fails; the last two count on the grouped
   wrapper; each record names the split kernel and the split its plan
   takes (keys per tile, pages per split, launches);
4b. the int8 serving kernels against their plain versions: the int8
   ``csd_spmm_fwd`` (``w_scale``) at phase 3's junctions (M 4, 16, 32,
   64, 128 and 256, f32 and bf16, with and without the gelu epilogue; the yardstick a
   ``torch.matmul`` on the densified, dequantized slab; each record names
   the body its plan runs, its tile and its cluster), and paged decode
   over int8 pages at phase 4's cases (the yardstick SDPA over the
   gathered, dequantized KV; bf16 q at G 7, 12 and 48 on the tensor-core
   form), timed like phase 3;
3c. the expert-batched forward kernels against their plain versions at
   granite-moe-1b-a400m's serving shapes (32 experts, C = 4 and 256 rows
   each; up/gate 1024 -> 512 in 128 x 256 blocks at fan-in 4, down 512 ->
   1024 at fan-in 3; f32 and bf16): ``csd_spmm_fwd_batched`` with phase 3's
   tolerances and ``csd_spmm_fwd_quant_batched`` with phase 4b's (also at
   C = 16, 32, 64 and 128), timed like phase 3 with one ``torch.bmm`` over the
   densified (dequantized) slabs as the yardstick;
3d. the small-block forms (``csrc/csd_spmm_small.cu``, the forward and dx,
   and ``csrc/csd_spmm_small_dw.cu``: blocks whose bL or bR is not a
   multiple of 64) through the shipped wrappers at the paper
   MLP's junctions: the forward (bias and relu), dx and dw with db against
   their plain versions at Table I's 800 -> 100 (16 x 4 blocks) and
   CIFAR_MLP's 4000 -> 500 at 256 and 8000 rows, MNIST_4J's 100 -> 100
   (4 x 4) and TIMIT's 39 -> 390 (1 x 2) and 390 -> 39 (2 x 1) at 256, f32
   and (256 rows) bf16; and at the smoke configurations' 16 x 16 junctions
   as phase 3f runs them, f32: gemma3-4b's gate (gelu with ``save_preact``;
   dx and dw through the gelu mask) and down at 64 rows and their forwards
   at a decode step's 4, granite-moe's expert-batched up and down (8
   experts of 24 rows); each timed like phase 6, cycling through copies of
   the data inputs, with a dense ``torch.matmul`` (``torch.bmm``) as the
   yardstick; the mask kernel at the widths 100, 390 and 39 and past its
   last whole chunk (77 x 39 bf16), equal element for element; then the
   int8 small-block forward (``csd_spmm_fwd_quant_small``, the gather
   kernel over an int8 slab with per-block scales) through the shipped
   int8 wrappers at Table I's and CIFAR_MLP's junctions (256 and 8000
   rows), TIMIT's two (256), the gemma3 smoke down junction at a decode
   step's 4 rows and granite-moe's 8 smoke experts at 4 rows each, f32 and
   bf16 x, at the int8 gates (f32 1e-4, bf16 1e-2 of max |plain|), the
   yardstick the matmul over the dequantized dense slab;
3e. train the paper's MLP (Table I's sparse column, Table II's MNIST_4J
   row d_out (80, 80, 80, 10), TIMIT at rho 0.2; block_gather at the
   published widths; ``synthetic_mnist(8000, 2000)``, TIMIT on
   ``synthetic_features``) from one seed: the first step with the kernels
   and with the plain versions (phase 7's f32 gates), two identical steps
   bit-equal, exact launches per step, 3 epochs of batch 256 through
   ``train_mlp`` with the kernels (every launch counted) and with the plain
   versions, both test accuracies recorded; between the two, a copy of the
   kernels' trained model quantized by ``quantize_model`` evaluated on the
   test set with the kernels and the plain versions (logits within 1e-4 of
   max |plain|, exactly one launch of the int8 small-block forward per
   block junction and no other junction kernel), its int8 and f32 test
   accuracies and the resident slab bytes (f32 against int8 plus scales)
   recorded;
3f. the LM smoke configurations (16 x 16 FFN and expert blocks): gemma3-4b's,
   gemma2-9b's, qwen2-7b's and granite-34b's served through
   ``launch.serve.generate`` and trained through ``launch.train.main``,
   granite-moe's trained, each again with the plain
   versions (losses and gradient norms compared; served first tokens
   equal and every served step's logits, teacher-forced, within 1e-4 of
   the largest), exact training launches; then the four served ones and
   granite-moe's (at the dropless capacity factor 4.0: the 5-D form) served
   again in int8 (``SparsityConfig.quant``: weights and KV), with the same
   checks against the int8 plain versions (the logits of each step from
   one cache state: over int8 KV pages two free-running caches may hold a
   token quantized a level apart, recorded), the int8 small-block forward
   launched and no other junction kernel (no f32 forward, no full-width
   int8 body); each served model (f32 and int8) then serves 4 periodic
   prompts with ``spec_k`` 4 and without: equal tokens, drafts made, only
   the small-block forward and the paged decode launched; gemma3-4b's
   ``launch.train.main`` run again with ``--checkpoint-every 2 --diloco 2
   --simulate-failure-at 3``, a checkpoint directory, ``--metrics-jsonl``
   and ``--profile-dir``, and without the failure: losses bit-equal, the
   JSONL stream replayed through ``repro_torch.obs.dump``, the Chrome trace
   naming ``train/step`` once a step;
3g. run the port's example scripts (``examples/torch_quickstart.py``,
   ``torch_train_sparse_mlp.py``, ``torch_serve_batched.py`` and
   ``torch_sparse_llm_pretrain.py`` with ``--checkpoint-dir``) at their
   defaults on the card, all at once, each in its own process: each must
   exit 0, the pretraining example's last loss below its first; then the
   pretraining example alone at ``--size full100m --steps 60`` (tok/s
   recorded);
5. serve gemma3-4b at its full configuration (34 layers, d_model 2560,
   vocab 262144; random weights from a seed; bf16) through
   ``ServingEngine``: 4 requests of 64-128 prompt tokens and 32 new tokens
   each, with every kernel's launch count read around that run (the
   serving kernels must run, no training kernel may); then the
   decode step after the prefill drain run with the kernels and with the
   plain versions from one cache state, logits compared; then 4 decode
   steps under ``torch.profiler`` (with the paged decode's CUDA launches
   and device time per layer);
5b. the same in int8 (``EngineConfig(quant=QuantConfig(weights=True,
   kv=True))``) from a fresh f32 model of the same seed, quantized at load:
   launch counts of all six serving kernels around the run (the bf16
   forward and the full-width paged decode must not run), the kernels per
   decode step, the bytes of the int8 slabs and of the page pool, the
   kernels-vs-plain decode step and 4 profiled decode steps; every int8
   junction call of the decode step must be one launch of the int8
   forward's decode body (``csd_spmm_fwd_quant_stream_kernel``, no f32
   partial buffer), and no ``reduce_splits_kernel`` may run in the
   profiled steps, whose junction kernels' µs per step are recorded; then
   the teacher-forced top-1 agreement of the int8 model's logits with the
   bf16 model's on phase 5's prompts and tokens (recorded, not gated);
5s. speculative decode (``EngineConfig(spec_k=4)``) on phase 5's and 5b's
   models (after 5b) and on phase 5c's (after 5c): 4 prompts of 8-token
   motifs tiled to 64-128 tokens, 32 new tokens, served spec-on, off, on,
   off (decode tok/s, steps and acceptance recorded); each run's launches
   exact for its paged steps (3 junction launches a layer a step, a paged
   decode a layer a plain decode step and none in a verify step); every
   spec-on run must draft; its tokens equal the spec-off run's or first
   differ where the spec-off logits' top-2 gap is below 5% of max |logit|;
   one verify step (4 rows of 1 + 4 positions, n_new 5, 5, 3, 1) held
   against the plain versions from one cache state at every valid
   position (5% of max |logit|), with exactly 3 junction launches a layer
   (102 for gemma3-4b, 72 expert-batched for granite-moe) on the body
   ``launch.fwd_body`` gives for the chunk's rows, and profiled;
5c. serve granite-moe-1b-a400m at its full width (24 layers, d_model 1024,
   32 experts top-8 of d_expert 512, vocab 49155; random weights from a
   seed; bf16) in its serving configuration: expert blocks 128 x 256
   (densities 0.5 and 0.75) and the dropless capacity factor 4.0 that
   paged serving needs. Phase 5's requests, checks and profile, with 72
   expert-batched forward and 24 paged-decode launches per decode step,
   none of the 4-D forward, and the resident expert slab bytes;
5d. the same weights quantized at load (weights and KV), as phase 5b:
   72 launches of the int8 expert-batched forward and 24 of the int8 paged
   decode per decode step (each junction call one launch of the decode
   body, no ``reduce_splits_kernel``), none of the full-width kernels, the
   int8 slab and scale bytes, and the top-1 agreement with 5c (recorded,
   not gated);
5e. serve gemma2-9b at full width and depth (42 layers, bf16; random
   weights from a seed) as phase 5 does, 16 new tokens a request, with a
   fifth request of 4,160 prompt tokens: the decode step held against the
   plain versions has a row past the 4096 window, which its local layers
   mask; exactly 126 junction and 42 paged-decode launches a decode step;
5f. the same weights quantized at load (weights and KV), as phase 5b
   (126 int8 junction and 42 int8 paged launches a step, each junction
   call one launch of the decode body), top-1 agreement with 5e on the
   four short requests (recorded, not gated);
5g. serve qwen2-7b at full width and depth (28 layers, bf16; QKV bias,
   untied head, G 7): 84 junction and 28 paged launches a decode step;
5h. serve granite-34b at full width and depth (88 layers), its parameters
   built in bf16 (in f32 they would not fit the card): 264 junction
   launches and 88 launches of the grouped paged decode a decode step;
   each model is freed before the next; in every serving phase each paged
   decode launch, of the run and of the checked decode step, must be of
   the split kernel ``launch.paged_rule`` gives the model (the tensor-core
   form for qwen2-7b and granite-34b);
6. hold the training kernels against their plain versions at gemma3-4b's
   training shapes (M = 2 x 2048 tokens; the gelu gate junction and the
   down junction, f32 and bf16): ``csd_spmm_fwd`` with ``save_preact``,
   ``csd_spmm_dx`` and ``csd_spmm_dw`` (with the gelu mask: the mask
   kernel, then the product), timed like phase 3; for the gate junction
   also the backward's pieces one by one as ``CsdMatmul`` launches them:
   ``csd_mask_cotangent`` (equal element for element to its plain
   version; the yardstick ``aten.gelu_backward``), then dx and dw on its
   output;
6b. hold the expert-batched training kernels against their plain versions
   at granite-moe-1b-a400m's training shapes (32 experts of C = 1280 rows:
   batch 2 x seq 2048 at top-8 and capacity factor 1.25; up/gate and down
   in 128 x 256 blocks, f32 and bf16): the 5-D ``csd_spmm_dx`` and
   ``csd_spmm_dw`` (with and without db) and the batched forward, each
   also once with the gelu epilogue (``save_preact``, masked cotangent,
   and the mask kernel alone), timed like phase 6 with one ``torch.bmm``
   over the densified slabs as the yardstick;
6c. hold the full-sequence attention kernels (``flash_attention_cuda`` and
   ``flash_attention_bwd_cuda``) against their plain versions at the
   training attention of gemma3-4b (B 2, S 2048, Hq 8, Hkv 4, Dh 256,
   window 1024 and none) and of granite-moe-1b-a400m (Hq 16, Hkv 8, Dh 64,
   no window), f32 and bf16, the backward from the kernel's own output and
   lse, each output's error measured per block of 64 rows of one (batch,
   head); three faulty controls made from the plain math must fail the same
   limits; timed with the bound over the visible pairs and SDPA
   (``enable_gqa``, causal or a window mask; its backward through autograd)
   as the yardstick; each record carries its launches' tiles (rows per CTA
   and streamed rows, from the plan) and the share of the bound reached;
7. free the serving model and train gemma3-4b at its full configuration
   (f32 parameters, bf16 compute, batch 2 x seq 2048, remat): one step's
   loss and gradients (the first and last layers' FFN and attention
   parameters) with the kernels and with the plain versions compared; two identical steps with bit-identical loss and gradients;
   then 4 ``Trainer`` steps on ``BigramLM`` batches with the launch counts
   of every kernel read around them (exactly 3 junction launches per layer
   for dx and dw, 6 for the forward with remat, 1 of the mask kernel for
   the gelu gate junction, 2 of the attention forward and 1 of its
   backward, none of any other kernel); then one step under
   ``torch.profiler``;
7b. free that model and train granite-moe-1b-a400m at its full width and
   depth in its training configuration (the published capacity factor
   1.25, expert blocks 128 x 256) the same way: the kernels-vs-plain step
   also reports how many routing choices differ between the two runs, and
   the counts are of the expert-batched kernels (72 dx, 72 dw, 144
   forwards per step) and the attention kernels (48 forward, 24 backward),
   none of the 4-D or int8 ones and no mask (silu does not fuse);
7d. free that model and train gemma3-4b at full width and 4 layers (bf16
   over f32 parameters, batch 2 x 2048; the depth cut for disk: 11.1 GB of
   f32 parameters and AdamW state a checkpoint, 33.7 GB at full depth) in
   a temporary directory: 4 ``Trainer`` steps uncut, then a fresh model of
   the same seed cut at step 3 through the CLI's restart loop (checkpoints
   every 2 steps, keep 1) and resumed: losses, parameters and AdamW state
   bit-equal to the uncut run's; around each of its saves and its restore
   the device's peak allocation above its resting allocation below the
   largest tensor (the 2.68 GB embedding); per save the snapshot, hash and
   write seconds and bytes, restore seconds, a step with an async save in
   flight against one without (recorded); a flipped byte in a shard makes
   ``restore`` raise ``IOError``; two DiLoCo runs (period 2) bit-equal,
   each sync of the first and last layers' parameters within 1e-6 of max
   of the same formula in numpy f32, peak memory against the three state
   copies (recorded); one step with a JSONL sink and a profile directory
   (replayed through ``obs.dump``, the trace names ``train/step``) and one
   without: equal launches, as phase 7 counts them; ``train_step`` under
   ``torch.cuda.set_sync_debug_mode("error")``;
7c. run the port's sparselint (``python -m repro_torch.analysis.lint``)
   on the card: clean it must exit 0 (grid, pattern and dispatch passes;
   the dispatch pass runs both models' full-width paged steps, bf16 and
   int8, and training steps under the sync debug mode), with
   ``--selftest-inject`` exit 1 with exactly SL101 on the race-broken
   forward and SL206 on the whole-slab upcast, launching the race-broken
   kernel once; every kernel's launches are counted around the two runs.
   Then hold every Python launch plan the run launched, and every lint
   case's, against its library's ``<name>_plan``; launch every lint case
   (each kernel family at demo and full-width shapes, the small-block forms
   at the paper MLP's and the smoke configurations' shapes, their int8
   forward among them, both forms of the paged decode's split kernel)
   twice into NaN-filled outputs (nothing unwritten, runs bit-equal); and
   time TPU
   kernel #9's counterpart (``csd_spmm_fwd_injected_alias``) at the demo
   shape beside the shipped forward, its error above 10x the forward's f32
   tolerance while the shipped forward at the same split passes;
8. print the seconds at which each phase ended (``phase_done_at_s``, also
   in ``chiprun_out/chip_smoke.json``) and one JSON line describing each
   ported kernel;
9. print the device line, last.

It exits non-zero without a result where no CUDA device is present or where
the port's sources are missing next to this script.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12                       # H100 SXM HBM3, bytes/s
PEAK_OPS = {"torch.bfloat16": 989e12,      # dense tensor-core bf16
            "torch.float32": 67e12}        # f32 outside the tensor cores
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def bench(calls, iters: int) -> tuple:
    """(device ms, host ms) per call over ``iters`` calls, cycling through
    ``calls`` (each on its own copy of the inputs, so that together they
    exceed the 50 MB L2 and every call reads device memory as the serving
    step does). The device time is taken behind a sleep kernel that holds
    the stream while the host enqueues every call, so it is the calls' time
    on the card without the host's launch overhead between them; the host
    time is the enqueue cost per call."""
    import torch
    for c in calls:
        c()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for i in range(iters):
        calls[i % len(calls)]()
    host_s = (time.perf_counter() - h0) / iters
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(4 * host_s * iters * 2e9) + 2_000_000)
    t0.record()
    for i in range(iters):
        calls[i % len(calls)]()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host_s * 1e3


def copies_for(nbytes: int) -> int:
    return max(2, math.ceil(150e6 / max(nbytes, 1)))


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, ref) -> tuple:
    d = (got.float() - ref.float()).abs()
    return float(d.max()), float((d / ref.float().abs().clamp_min(1e-3)).max())


def within(got, ref, atol: float, rtol: float) -> bool:
    d = (got.float() - ref.float()).abs()
    return bool((d <= atol + rtol * ref.float().abs()).all())


def fwd_body(fn, *args, **kw) -> dict:
    """Which body of ``csrc/csd_spmm_fwd.cu`` or (int8)
    ``csrc/csd_spmm_fwd_quant.cu`` the forward wrapper ``fn`` runs for
    these operands, read from the plan it builds for this card (captured,
    not launched): the kernel, its grid, the rows and output columns of its
    tile, its thread-block cluster, the fan-in splits and the launches."""
    from repro_torch.analysis.capture import capture_launch
    from repro_torch.kernels import launch
    plan = capture_launch(fn, *args, n_sm=launch.sm_count(args[0].device),
                          **kw)
    ln = plan.launches[0]
    tiles = dict((t[0], t[2]) for t in ln.tiles)
    return dict(body=ln.kernel, grid=list(ln.grid), tile_m=tiles["M"],
                tile_n=tiles["n_out"], cluster=ln.cluster[0],
                n_splits=plan.n_splits, n_launches=len(plan.launches))


def check_training_body(rec: dict) -> None:
    """Fail if a bf16 forward at a training shape (a record of phases 6 and
    6b with ``fwd_body``'s keys) would run another body than the wgmma
    body on this card."""
    if "body" in rec and rec["dtype"] == "bfloat16" \
            and rec["body"] != "csd_spmm_fwd_wgmma_kernel":
        fail(f"the bf16 training forward takes {rec['body']}, not the "
             f"wgmma body: {rec}")


# ---------------------------------------------------------------------------
# phase 2: what the wgmma libraries were compiled to
# ---------------------------------------------------------------------------

# the instructions of Hopper's tensor-core path in SASS: HGMMA (wgmma) and
# UTMALDG (a TMA tile load)
SASS_OPS = ("HGMMA", "UTMALDG")
# the Ampere-era path: HMMA (mma.sync) and LDGSTS (cp.async)
SASS_OLD_OPS = ("HMMA", "LDGSTS")
SASS_LIBS = ("csd_spmm_fwd", "csd_spmm_fwd_quant", "csd_spmm_dx",
             "csd_spmm_dw", "flash_attention")
# libraries whose every ``*_wgmma_kernel`` must hold no Ampere-era
# instruction, and how many such functions each has at least: the
# forward's wgmma body (3 tile widths x 3 activations), its int8
# instantiation (2 widths x 3 activations), the bf16 flash-attention
# kernels (forward, dq and dk/dv at Dh 64, 128, 256)
SASS_WGMMA_ONLY = {"csd_spmm_fwd": 9, "csd_spmm_fwd_quant": 6,
                   "flash_attention": 9}


def sass_counts() -> dict:
    """``cuobjdump -sass`` of the built forward, int8 forward, dx, dw and
    flash-attention libraries: how many HGMMA and UTMALDG instructions each
    holds (all must have both: their bf16 kernels at the training and
    prefill shapes run on wgmma fed by TMA), and, per function, HMMA and
    LDGSTS, of which the forward's wgmma body (bf16 and int8 weights) and
    the bf16 flash-attention kernels (``*_wgmma_kernel``) must hold
    none."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    rec = {}
    for name in SASS_LIBS:
        sass = subprocess.run([str(tool), "-sass", str(build._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        rec[name] = {op: sass.count(op) for op in SASS_OPS + SASS_OLD_OPS}
        if name in SASS_WGMMA_ONLY:
            funcs = {}
            for part in sass.split("Function : ")[1:]:
                fn = part.split("\n", 1)[0].strip()
                if "wgmma_kernel" in fn:
                    funcs[fn] = {op: part.count(op)
                                 for op in SASS_OPS + SASS_OLD_OPS}
            rec[name]["wgmma_kernels"] = funcs
    log(json.dumps(dict(check="sass", **rec)))
    if any(rec[n][op] == 0 for n in SASS_LIBS for op in SASS_OPS):
        fail(f"a wgmma library lacks wgmma or TMA instructions: {rec}")
    for name, least in SASS_WGMMA_ONLY.items():
        funcs = rec[name]["wgmma_kernels"]
        if len(funcs) < least or any(c[op] for c in funcs.values()
                                     for op in SASS_OLD_OPS):
            fail(f"the wgmma kernels of {name} are not all wgmma/TMA-only "
                 f"(at least {least} of them): {funcs}")
    return rec


def ptxas_functions(log: str) -> dict:
    """{mangled function: (registers per thread, spilled bytes)} from an
    ``-Xptxas -v`` compiler log."""
    import re
    fn, out = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, [0, 0])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def kernel_registers(source: str, match: str, what: str,
                     gated=None) -> dict:
    """Phase 2: registers per thread of every function of the library of
    ``csrc/<source>.cu`` whose name holds ``match``, read from its
    compiler log; fails if any spills (``what`` names them), or with
    ``gated`` any whose demangled name it accepts."""
    from repro_torch.kernels import build
    funcs = {k: v for k, v in ptxas_functions(
        build.compiler_log(source)).items() if match in k}
    filt = Path(build._nvcc()).with_name("cu++filt")
    names = list(funcs)
    if filt.exists():
        shown = subprocess.run([str(filt)], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    else:
        shown = names
    rec = {}
    for name, pretty in zip(names, shown):
        cut = pretty.find(">(")
        pretty = pretty[:cut + 1] if cut >= 0 else pretty.split("(", 1)[0]
        pretty = pretty.replace("void ", "").replace(
            "(anonymous namespace)::", "")
        rec[pretty] = dict(registers=funcs[name][0],
                           spill_bytes=funcs[name][1])
    log(json.dumps(dict(check=f"{what} registers", kernels=rec)))
    spilled = {k: v for k, v in rec.items() if v["spill_bytes"]
               and (gated is None or gated(k))}
    if not rec or spilled:
        fail(f"{what} kernels spill (or none were found): {spilled}")
    return rec


def paged_registers() -> dict:
    """Every form of the paged decode kernels
    (``paged_decode_kernel<T, PT, G, bucket>``, the tensor-core
    ``paged_decode_mma_kernel<PT, row tiles, Dh>`` and the merge); fails
    if a spill or no tensor-core form is found."""
    rec = kernel_registers("paged_decode", "paged_decode", "paged decode")
    if not any("paged_decode_mma_kernel" in k for k in rec):
        fail("no paged_decode_mma_kernel in the paged decode library")
    return rec


def stream_registers() -> dict:
    """Every row-tile form of the int8 forward's decode body
    (``csd_spmm_fwd_quant_stream_kernel<MT>``)."""
    return kernel_registers("csd_spmm_fwd_quant", "stream_kernel",
                            "int8 decode body")


def small_registers() -> dict:
    """Every instantiation of the small-block gather kernel
    (``csd_spmm_small_gather_kernel<T, WT, DX, CW, KQ, OCC>``), recorded;
    fails if one of its int8 forms built for one CTA an SM (WT ``signed
    char``, OCC 1: the 4 x 4 product with a 16 x 4 slot's slab in
    registers) spills. The two-CTA 4 x 4 forms spill a few words under
    their 128 registers (f32 and int8 alike); forms that do not (the int8
    slot's tile summed a half of the rows at a time) were slower (PERF.md,
    section 6)."""
    return kernel_registers(
        "csd_spmm_small", "gather_kernel", "small-block gather",
        gated=lambda name: "signed char" in name
        and name.endswith("(int)1>"))


# ---------------------------------------------------------------------------
# phase 3: csd_spmm_fwd
# ---------------------------------------------------------------------------

SPMM_TOL = {"torch.float32": (1e-4, 1e-4),   # f32 sums in another order
            "torch.bfloat16": (1e-2, 1e-2)}  # + one bf16 rounding of y


def junction_patterns(cfg):
    """The (up/gate, down) block patterns of gemma3-4b's FFN."""
    from repro_torch.core.block_pattern import fit_block_pattern
    sp = cfg.sparsity
    up = fit_block_pattern(cfg.d_model, cfg.d_ff, sp.rho_ffn[0], sp, seed=12)
    down = fit_block_pattern(cfg.d_ff, cfg.d_model, sp.rho_ffn[1], sp,
                             seed=13)
    return up, down


# the dense decoders of phases 5e-5h, whose FFN junctions phases 3 and 4b
# also hold at their decode (M 4) and prefill (M 256) shapes, bf16: fan-ins
# 7 and 40 (gemma2-9b, gelu), 14 and 74 (qwen2-7b, dense patterns), 12 and
# 64 (granite-34b)
DENSE_ARCHS = ("gemma2_9b", "qwen2_7b", "granite_34b")


def dense_junctions():
    """(model, junction, pattern, activation of the gate's epilogue) of the
    dense decoders' full-width FFN junctions."""
    from repro_torch.configs import get_config
    for arch in DENSE_ARCHS:
        c = get_config(arch)
        up, down = junction_patterns(c)
        act = "gelu" if c.act.startswith("gelu") else None
        yield c.name, "up/gate", up, act
        yield c.name, "down", down, None


def spmm_cases(cfg):
    """(model, junction, pattern, M, dtype, activation, bias) of phase 3:
    gemma3-4b's junctions in f32 and bf16, with and without the epilogue,
    then the dense decoders' in bf16."""
    up, down = junction_patterns(cfg)
    for dtype_name in ("float32", "bfloat16"):
        for m in (4, 256):
            for act in (None, "gelu"):
                yield (cfg.name, "up/gate", up, m, dtype_name, act, False)
            for with_bias in (False, True):
                yield (cfg.name, "down", down, m, dtype_name, None,
                       with_bias)
    for model, name, bp, act in dense_junctions():
        for m in (4, 256):
            yield model, name, bp, m, "bfloat16", act, False


def run_spmm(cfg, device, results):
    import torch
    from repro_torch.kernels import csd_spmm
    g = torch.Generator(device=device).manual_seed(SEED)
    for model, name, bp, m, dtype_name, act, with_bias in spmm_cases(cfg):
        dtype = getattr(torch, dtype_name)
        shape = (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
        slab_bytes = math.prod(shape) * dtype.itemsize
        n = copies_for(slab_bytes)
        xs = [torch.randn((m, bp.n_in), generator=g, device=device)
              .to(dtype) for _ in range(n)]
        ws = [(torch.randn(shape, generator=g, device=device)
               / math.sqrt(bp.d_in_b * bp.block_in)).to(dtype)
              for _ in range(n)]
        bias = (0.1 * torch.randn(bp.n_out, generator=g, device=device)
                ).to(dtype) if with_bias else None
        idx = torch.as_tensor(bp.block_idx, dtype=torch.int32, device=device)
        kw = dict(bias=bias, activation=act)
        got = csd_spmm.csd_spmm_fwd_cuda(xs[0], ws[0], idx, **kw)
        ref = csd_spmm.csd_spmm_fwd_plain(xs[0], ws[0], idx, **kw)
        torch.cuda.synchronize()
        atol, rtol = SPMM_TOL[str(dtype)]
        abs_e, rel_e = max_err(got, ref)
        ok = within(got, ref, atol, rtol) and bool(torch.isfinite(got).all())
        ms, host_ms = bench([lambda i=i: csd_spmm.csd_spmm_fwd_cuda(
            xs[i], ws[i], idx, **kw) for i in range(n)], 60)
        plain_ms, _ = bench([lambda i=i: csd_spmm.csd_spmm_fwd_plain(
            xs[i], ws[i], idx, **kw) for i in range(n)], 6)
        dense = [torch.zeros((bp.n_in, bp.n_out), dtype=dtype, device=device)
                 for _ in range(copies_for(bp.n_in * bp.n_out
                                           * dtype.itemsize))]
        lib_ms, _ = bench([lambda d=d: torch.matmul(xs[0], d)
                           for d in dense], 30)
        del dense
        el = dtype.itemsize
        nbytes = el * (m * bp.n_in + math.prod(shape) + m * bp.n_out
                       + (bp.n_out if with_bias else 0)) + 4 * idx.numel()
        ops = 2 * m * math.prod(shape)
        bound_ms, bound_by = bound(nbytes, ops, dtype)
        rec = dict(kernel="csd_spmm_fwd", model=model, junction=name, m=m,
                   fan_in=bp.d_in_b, dtype=dtype_name, activation=act,
                   bias=with_bias,
                   **fwd_body(csd_spmm.csd_spmm_fwd_cuda, xs[0], ws[0], idx,
                              **kw),
                   max_abs_err=abs_e, max_rel_err=rel_e, atol=atol,
                   rtol=rtol, ok=ok, ms=ms, host_ms=host_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=lib_ms)
        results.append(rec)
        log(json.dumps(rec))
        if not ok:
            fail(f"csd_spmm_fwd disagrees with its plain version: {rec}")


# ---------------------------------------------------------------------------
# phase 4: paged_decode_attention
# ---------------------------------------------------------------------------

PAGED_TOL = {"torch.float32": (2e-5, 2e-5), "torch.bfloat16": (1e-2, 1e-2)}
PAGED_LENGTHS, PAGED_PAGES = (1100, 517, 0, 1040), 72
# gemma2-9b's rows: one past its 4096 window, a 300-page table
GEMMA2_LENGTHS, GEMMA2_PAGES = (4160, 517, 0, 4097), 300
# (model, Hkv, G, Dh, windows, softcap, lengths, table pages):
# gemma3-4b's heads (5 of 6 layers windowed), granite-moe-1b-a400m's (all
# global), gemma2-9b's (alternating 4096 window, softcap 50, rows crossing
# the window), qwen2-7b's (a group of 7), granite-34b's (48 query heads
# over one KV head) and a group of 12: from G 5 in bf16 the tensor-core
# form (one row tile for 7 and 12, three for 48); in f32 the CUDA-core
# form (7 as its 8 form with a row masked, 12 and 48 in chunks of 8)
PAGED_SHAPES = (
    ("gemma3-4b", 4, 2, 256, (None, 1024), None, PAGED_LENGTHS, PAGED_PAGES),
    ("granite-moe-1b-a400m", 8, 2, 64, (None,), None, PAGED_LENGTHS,
     PAGED_PAGES),
    ("gemma2-9b", 8, 2, 256, (4096,), 50.0, GEMMA2_LENGTHS, GEMMA2_PAGES),
    ("qwen2-7b", 4, 7, 128, (None,), None, PAGED_LENGTHS, PAGED_PAGES),
    ("granite-34b", 1, 48, 128, (None,), None, PAGED_LENGTHS, PAGED_PAGES),
    ("g12", 4, 12, 128, (None,), None, PAGED_LENGTHS, PAGED_PAGES))


def paged_cases():
    """(dtype name, model, Hkv, G, Dh, window, softcap, lengths, table
    pages) of phases 4 and 4b."""
    for dtype_name in ("float32", "bfloat16"):
        for model, hkv, grp, dh, windows, cap, lens, pages in PAGED_SHAPES:
            for window in windows:
                yield dtype_name, model, hkv, grp, dh, window, cap, lens, \
                    pages


def paged_inputs(device, dtype, window, g, hkv=4, dh=256,
                 lengths=PAGED_LENGTHS, n_pages=PAGED_PAGES, grp=2):
    """B = len(lengths) rows (phases 4 and 4b: lengths past 1024, one
    empty, a 72-page table) of ``grp`` query heads a KV head, page 16;
    unmapped entries -1 (the table tail, and with a window the leading
    pages every query has left, as the engine's window reclamation leaves
    them)."""
    import torch
    b, page = len(lengths), 16
    pool = sum(-(-n // page) for n in lengths) + 1
    perm = torch.randperm(pool - 1, generator=torch.Generator().manual_seed(1))
    table = torch.full((b, n_pages), -1, dtype=torch.int32)
    k = 0
    for i, n in enumerate(lengths):
        for p in range(-(-n // page)):
            if window is None or (p + 1) * page > n - window:
                table[i, p] = int(perm[k])
            k += 1
    q = torch.randn((b, hkv, grp, dh), generator=g, device=device).to(dtype)
    kp = torch.randn((pool, page, hkv, dh), generator=g,
                     device=device).to(dtype)
    vp = torch.randn((pool, page, hkv, dh), generator=g,
                     device=device).to(dtype)
    return q, kp, vp, table.to(device), torch.tensor(
        lengths, dtype=torch.int32, device=device)


def paged_yardstick(q, kp, vp, table, lengths, window, scales=None):
    """(SDPA over the gathered KV with the visibility mask and
    ``enable_gqa`` (each KV head under its group of query heads),
    dequantized to q's dtype for int8 pages, without a softcap, which SDPA
    has not; the mask's visible keys). The gather is made here, outside
    the timed call."""
    import torch
    import torch.nn.functional as F
    b, hkv, grp, dh = q.shape
    idx = table.long().clamp_min(0)
    kk, vv = kp[idx], vp[idx]
    if scales is not None:
        kk = (kk.float() * scales[0][idx][..., None, None]).to(q.dtype)
        vv = (vv.float() * scales[1][idx][..., None, None]).to(q.dtype)
    kk, vv = (t.reshape(b, -1, hkv, dh).transpose(1, 2).contiguous()
              for t in (kk, vv))
    kpos = torch.arange(kk.shape[2], device=q.device)
    mask = (kpos[None] < lengths[:, None].long()) & (
        table >= 0).repeat_interleave(kp.shape[1], 1)
    if window is not None:
        mask &= kpos[None] >= lengths[:, None].long() - window
    qq = q.reshape(b, hkv * grp, 1, dh)
    return (lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask[:, None, None], enable_gqa=True)), \
        int(mask.sum())


def paged_bound(q, table, lengths, visible, quant: bool) -> tuple:
    """The bound of one paged decode call: the K and V rows of the visible
    keys (int8: one byte a value and 8 bytes of scales a key), q read and
    the output written in q's dtype, the table and the lengths; 4 G Dh
    operations a key."""
    b, hkv, grp, dh = q.shape
    el = q.element_size()
    kv = 2 * visible * hkv * dh + 8 * visible if quant \
        else el * 2 * visible * hkv * dh
    nbytes = kv + 2 * q.numel() * el + 4 * (table.numel() + lengths.numel())
    return bound(nbytes, 4 * grp * dh * visible * hkv, q.dtype)


def run_paged(device, results):
    import torch
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    for dtype_name, model, hkv, grp, dh, window, cap, lens, n_pages in \
            paged_cases():
        dtype = getattr(torch, dtype_name)
        q, kp, vp, table, lengths = paged_inputs(device, dtype, window, g,
                                                 hkv, dh, lens, n_pages, grp)
        n = copies_for(2 * kp.numel() * kp.element_size())
        pools = [(kp.clone(), vp.clone()) for _ in range(n)]
        kw = dict(window=window, softcap=cap)
        counter = paged_counter(fa, grp, False)
        n0 = counter.launches
        got = fa.paged_decode_attention_cuda(q, kp, vp, table, lengths,
                                             **kw)
        ref = fa.paged_decode_attention_plain(q, kp, vp, table, lengths,
                                              **kw)
        torch.cuda.synchronize()
        atol, rtol = PAGED_TOL[str(dtype)]
        abs_e, rel_e = max_err(got, ref)
        ok = within(got, ref, atol, rtol) and bool(
            (got[2] == 0).all()) and bool(torch.isfinite(got).all()) \
            and counter.launches == n0 + 1
        ms, host_ms = bench([lambda p=p: fa.paged_decode_attention_cuda(
            q, p[0], p[1], table, lengths, **kw) for p in pools], 100)
        plain_ms, _ = bench([lambda p=p: fa.paged_decode_attention_plain(
            q, p[0], p[1], table, lengths, **kw) for p in pools], 10)
        sdpa, visible = paged_yardstick(q, kp, vp, table, lengths, window)
        lib_ms, _ = bench([sdpa], 50)
        bound_ms, bound_by = paged_bound(q, table, lengths, visible, False)
        rec = dict(kernel=counter.__name__[:-5], model=model,
                   dtype=dtype_name, hkv=hkv, g=grp, dh=dh, window=window,
                   softcap=cap, lengths=lengths.tolist(),
                   max_abs_err=abs_e, max_rel_err=rel_e, atol=atol,
                   rtol=rtol, ok=ok, ms=ms, host_ms=host_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=lib_ms,
                   **paged_split(fa.paged_decode_attention_cuda, q, kp, vp,
                                 table, lengths, **kw))
        results.append(rec)
        log(json.dumps(rec))
        if not ok:
            fail(f"paged_decode_attention disagrees with its plain "
                 f"version: {rec}")
        check_paged_form(rec, grp, dh, dtype_name, False)


def check_paged_form(rec: dict, grp: int, dh: int, dtype_name: str,
                     quant: bool) -> None:
    """Fail unless a phase 4/4b case ran the split kernel the form rule
    gives it: the tensor-core form for bf16 q with G0 (5) to 48 query
    heads a KV head, the CUDA-core form for the rest (G 1, 2, 4 and f32)."""
    from repro_torch.kernels import launch
    want = "paged_decode_mma_kernel" if launch.paged_rule(
        grp, dh, 16, dtype_name, quant) == "mma" else "paged_decode_kernel"
    if rec["split_kernel"] != want:
        fail(f"a paged decode case ran {rec['split_kernel']}, the rule "
             f"gives {want}: {rec}")


def paged_counter(fa, grp: int, quant: bool):
    """The wrapper that counts a paged decode call's launch: the grouped
    form's for a group above 8 query heads."""
    name = "paged_decode_attention" + ("_quant" if quant else "") + (
        "_grouped" if grp > 8 else "")
    return getattr(fa, f"{name}_cuda")


def paged_split(fn, *args, **kw) -> dict:
    """The split the paged-decode wrapper ``fn`` plans for these operands
    on this card (captured, not launched): the split kernel (its form),
    keys per tile, pages per split, splits and launches."""
    from repro_torch.analysis.capture import capture_launch
    from repro_torch.kernels import launch
    plan = capture_launch(fn, *args, n_sm=launch.sm_count(args[0].device),
                          **kw)
    return dict(split_kernel=plan.launches[0].kernel,
                keys_per_tile=plan.args["keys_per_tile"],
                pages_per_split=plan.args["pages_per_split"],
                n_splits=plan.n_splits, n_launches=len(plan.launches))


# ---------------------------------------------------------------------------
# phase 4b: the int8 serving kernels
# ---------------------------------------------------------------------------

# max |kernel - plain|: f32 sums in another order, against the largest
# |plain|; bf16 one rounding of the output
QUANT_F32_TOL = 1e-4
# rows (per expert in phase 3c) of the int8 forward's cases: a decode
# step's 4 slots; prefill of 4 slots of 4, 8, 16, 32 and 64 tokens (the
# engine's power-of-two chunks), so that every body the rule picks on the
# serving path is held against plain: the stream body's 16-, 32- and
# 64-row tiles, the wgmma body at one and at two 128-row tiles
QUANT_M = (4, 16, 32, 64, 128, 256)


def quant_close(got, ref, dtype) -> bool:
    if dtype == "float32":
        return float((got - ref).abs().max()) \
            <= QUANT_F32_TOL * float(ref.abs().max())
    return within(got, ref, *SPMM_TOL["torch.bfloat16"])


def run_spmm_quant(cfg, device, results):
    import torch
    from repro_torch.core.quant import dequantize_slab, quantize_slab
    from repro_torch.kernels import csd_spmm
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    up, down = junction_patterns(cfg)
    # gemma3-4b's junctions at every M and both epilogues, f32 and bf16;
    # the dense decoders' at M 4 and 256 with their own epilogue, bf16
    cases = [(cfg.name, name, bp, dtype_name, QUANT_M, (None, "gelu"))
             for dtype_name in ("float32", "bfloat16")
             for name, bp in (("up/gate", up), ("down", down))]
    cases += [(model, name, bp, "bfloat16", (4, 256), (act,))
              for model, name, bp, act in dense_junctions()]
    for model, name, bp, dtype_name, rows, acts in cases:
        dtype = getattr(torch, dtype_name)
        shape = (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
        n_w = math.prod(shape)
        n = copies_for(n_w)
        slabs = [quantize_slab(torch.randn(shape, generator=g,
                                           device=device)
                               / math.sqrt(bp.d_in_b * bp.block_in))
                 for _ in range(n)]
        idx = torch.as_tensor(bp.block_idx, dtype=torch.int32,
                              device=device)
        dense = dense_of(bp, dequantize_slab(*slabs[0], dtype))
        denses = [dense] + [dense.clone() for _ in range(
            copies_for(dense.numel() * dense.element_size()) - 1)]
        for m in rows:
            x = torch.randn((m, bp.n_in), generator=g,
                            device=device).to(dtype)
            for act in acts:
                def kern(i=0):
                    q, sc = slabs[i]
                    return csd_spmm.csd_spmm_fwd_cuda(
                        x, q, idx, activation=act, w_scale=sc)

                def plain(i=0):
                    q, sc = slabs[i]
                    return csd_spmm.csd_spmm_fwd_plain(
                        x, q, idx, activation=act, w_scale=sc)
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                got, ref = got.float(), ref.float()
                ok = quant_close(got, ref, dtype_name) and bool(
                    torch.isfinite(got).all())
                abs_e, rel_e = max_err(got, ref)
                ms, host_ms = bench([lambda i=i: kern(i)
                                     for i in range(n)], 60)
                plain_ms, _ = bench([lambda i=i: plain(i)
                                     for i in range(n)], 6)
                lib_ms, _ = bench([lambda d=d: torch.matmul(x, d)
                                   for d in denses], 30)
                el = dtype.itemsize
                nbytes = el * m * (bp.n_in + bp.n_out) + n_w \
                    + 4 * 2 * idx.numel()  # slab, scales, pattern
                bound_ms, bound_by = bound(nbytes, 2 * m * n_w, dtype)
                q, sc = slabs[0]
                rec = dict(kernel="csd_spmm_fwd_quant", model=model,
                           junction=name, m=m, fan_in=bp.d_in_b,
                           dtype=dtype_name, activation=act,
                           **fwd_body(csd_spmm.csd_spmm_fwd_cuda, x, q,
                                      idx, activation=act, w_scale=sc),
                           max_abs_err=abs_e, max_rel_err=rel_e,
                           max_abs_ref=float(ref.abs().max()), ok=ok,
                           ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=lib_ms,
                           library="torch.matmul, densified "
                                   "dequantized slab")
                results.append(rec)
                log(json.dumps(rec))
                if not ok:
                    fail(f"int8 csd_spmm_fwd disagrees with its plain "
                         f"version: {rec}")
        del slabs, dense, denses
        torch.cuda.empty_cache()


def run_paged_quant(device, results):
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.kv_cache import quantize_kv
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    for dtype_name, model, hkv, grp, dh, window, cap, lens, n_pages in \
            paged_cases():
        dtype = getattr(torch, dtype_name)
        q, kp, vp, table, lengths = paged_inputs(device, torch.float32,
                                                 window, g, hkv, dh, lens,
                                                 n_pages, grp)
        q = q.to(dtype)
        (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
        del kp, vp
        n = copies_for(2 * k8.numel())
        pools = [tuple(t.clone() for t in (k8, v8, ks, vs))
                 for _ in range(n)]

        def kern(p):
            return fa.paged_decode_attention_cuda(
                q, p[0], p[1], table, lengths, window=window, softcap=cap,
                k_scale=p[2], v_scale=p[3])

        def plain(p):
            return fa.paged_decode_attention_plain(
                q, p[0], p[1], table, lengths, window=window, softcap=cap,
                k_scale=p[2], v_scale=p[3])
        counter = paged_counter(fa, grp, True)
        n0 = counter.launches
        got, ref = kern(pools[0]), plain(pools[0])
        torch.cuda.synchronize()
        atol, rtol = PAGED_TOL[str(dtype)]
        abs_e, rel_e = max_err(got, ref)
        ok = within(got, ref, atol, rtol) and bool(
            (got[2] == 0).all()) and bool(torch.isfinite(got).all()) \
            and counter.launches == n0 + 1
        ms, host_ms = bench([lambda p=p: kern(p) for p in pools], 100)
        plain_ms, _ = bench([lambda p=p: plain(p) for p in pools], 10)
        sdpa, visible = paged_yardstick(q, k8, v8, table, lengths, window,
                                        (ks, vs))
        lib_ms, _ = bench([sdpa], 50)
        bound_ms, bound_by = paged_bound(q, table, lengths, visible, True)
        rec = dict(kernel=counter.__name__[:-5], model=model,
                   dtype=dtype_name, hkv=hkv, g=grp, dh=dh, window=window,
                   softcap=cap, lengths=lengths.tolist(), max_abs_err=abs_e,
                   max_rel_err=rel_e, atol=atol, rtol=rtol, ok=ok, ms=ms,
                   host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=lib_ms,
                   library="SDPA over the gathered, dequantized KV",
                   **paged_split(fa.paged_decode_attention_cuda, q, k8, v8,
                                 table, lengths, window=window, softcap=cap,
                                 k_scale=ks, v_scale=vs))
        results.append(rec)
        log(json.dumps(rec))
        if not ok:
            fail(f"int8 paged_decode_attention disagrees with its plain "
                 f"version: {rec}")
        check_paged_form(rec, grp, dh, dtype_name, True)
        del pools, sdpa


# ---------------------------------------------------------------------------
# phase 3c: the expert-batched forward kernels at granite-moe's shapes
# ---------------------------------------------------------------------------


def granite_training_config():
    """granite-moe-1b-a400m as published (capacity factor 1.25: training
    drops the assignments past an expert's capacity, as the JAX trainer
    does) with 128 x 256 expert blocks: the default 256 x 1024 make both
    expert junctions dense at d_model 1024, d_expert 512."""
    from repro_torch.configs import granite_moe_1b_a400m
    return granite_moe_1b_a400m.card_config()


def granite_serving_config():
    """The training configuration with the dropless capacity factor
    n_routed / top_k = 4.0 that paged serving needs."""
    import dataclasses
    cfg = granite_training_config()
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))


def expert_patterns(cfg):
    """The (up/gate, down) expert patterns of the MoE blocks (layer seed 1,
    gate +32, down +33)."""
    from repro_torch.core.block_pattern import fit_block_pattern
    sp, d, d_e = cfg.sparsity, cfg.d_model, cfg.moe.d_expert
    return (fit_block_pattern(d, d_e, sp.rho_ffn[0], sp, seed=1 + 32),
            fit_block_pattern(d_e, d, sp.rho_ffn[1], sp, seed=1 + 33))


def expert_slab_bytes(cfg, itemsize: int) -> tuple:
    """(slab bytes, scale bytes) of every layer's up, gate and down expert
    slabs, from their patterns."""
    up, down = expert_patterns(cfg)
    per_expert = [bp.n_rb * bp.d_in_b for bp in (up, up, down)]
    n = cfg.n_layers * cfg.moe.n_routed
    weights = n * sum(k * bp.block_in * bp.block_out
                      for k, bp in zip(per_expert, (up, up, down)))
    return weights * itemsize, 4 * n * sum(per_expert)


def dense_of_experts(bp, w):
    """(E, n_in, n_out) dense weights of a stack of expert slabs: what
    ``torch.bmm`` multiplies in the yardstick."""
    import torch
    return torch.stack([dense_of(bp, w[e]) for e in range(w.shape[0])])


def run_spmm_batched(cfg, device, results):
    import torch
    from repro_torch.core.quant import dequantize_slab, quantize_slab
    from repro_torch.kernels import csd_spmm
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    n_exp = cfg.moe.n_routed
    up, down = expert_patterns(cfg)
    for dtype_name, (name, bp), quant in (
            (d, j, q) for d in ("float32", "bfloat16")
            for j in (("up/gate", up), ("down", down))
            for q in (False, True)):
        dtype = getattr(torch, dtype_name)
        kernel = "csd_spmm_fwd_quant_batched" if quant \
            else "csd_spmm_fwd_batched"
        shape = (n_exp, bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
        n_w = math.prod(shape)
        n = copies_for(n_w * (1 if quant else dtype.itemsize))
        slabs = []
        for _ in range(n):
            w = torch.randn(shape, generator=g, device=device) \
                / math.sqrt(bp.d_in_b * bp.block_in)
            slabs.append(quantize_slab(w) if quant else (w.to(dtype), None))
        idx = torch.as_tensor(bp.block_idx, dtype=torch.int32, device=device)
        w0 = dequantize_slab(*slabs[0], dtype) if quant else slabs[0][0]
        dense = dense_of_experts(bp, w0)
        denses = [dense] + [dense.clone() for _ in range(
            copies_for(dense.numel() * dense.element_size()) - 1)]
        del w0
        variants = ((None, False), ("gelu", False)) if name == "up/gate" \
            else ((None, False), (None, True))
        for m in QUANT_M if quant else (4, 256):
            x = torch.randn((n_exp, m, bp.n_in), generator=g,
                            device=device).to(dtype)
            for act, with_bias in variants:
                bias = (0.1 * torch.randn((n_exp, bp.n_out), generator=g,
                                          device=device)).to(dtype) \
                    if with_bias else None

                def kern(i=0):
                    w, sc = slabs[i]
                    return csd_spmm.csd_spmm_fwd_batched_cuda(
                        x, w, idx, bias=bias, activation=act, w_scale=sc)

                def plain(i=0):
                    w, sc = slabs[i]
                    return csd_spmm.csd_spmm_fwd_batched_plain(
                        x, w, idx, bias=bias, activation=act, w_scale=sc)
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                if quant:
                    ok = quant_close(got.float(), ref.float(), dtype_name)
                    tol = dict(tol_of_max=QUANT_F32_TOL) \
                        if dtype_name == "float32" \
                        else dict(zip(("atol", "rtol"),
                                      SPMM_TOL["torch.bfloat16"]))
                else:
                    ok = within(got, ref, *SPMM_TOL[str(dtype)])
                    tol = dict(zip(("atol", "rtol"), SPMM_TOL[str(dtype)]))
                ok = ok and bool(torch.isfinite(got).all()) \
                    and got.shape == (n_exp, m, bp.n_out)
                abs_e, rel_e = max_err(got, ref)
                ms, host_ms = bench([lambda i=i: kern(i)
                                     for i in range(n)], 60)
                plain_ms, _ = bench([lambda i=i: plain(i)
                                     for i in range(n)], 6)
                lib_ms, _ = bench([lambda d=d: torch.bmm(x, d)
                                   for d in denses], 30)
                el = dtype.itemsize
                slab_b = n_w + 4 * n_w // (bp.block_in * bp.block_out) \
                    if quant else el * n_w  # int8 slab + f32 scales
                nbytes = el * n_exp * m * (bp.n_in + bp.n_out) + slab_b \
                    + (el * n_exp * bp.n_out if with_bias else 0) \
                    + 4 * idx.numel()
                bound_ms, bound_by = bound(nbytes, 2 * m * n_w, dtype)
                w, sc = slabs[0]
                rec = dict(kernel=kernel, junction=name, experts=n_exp, m=m,
                           dtype=dtype_name, activation=act, bias=with_bias,
                           w_shape=list(shape),
                           **fwd_body(csd_spmm.csd_spmm_fwd_batched_cuda, x,
                                      w, idx, bias=bias, activation=act,
                                      w_scale=sc),
                           max_abs_err=abs_e, max_rel_err=rel_e,
                           max_abs_ref=float(ref.float().abs().max()),
                           **tol, ok=ok, ms=ms, host_ms=host_ms,
                           plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=lib_ms,
                           library="torch.bmm over the densified"
                                   + (" dequantized" if quant else "")
                                   + " slabs")
                results.append(rec)
                log(json.dumps(rec))
                if not ok:
                    fail(f"{kernel} disagrees with its plain version: {rec}")
        del slabs, dense, denses
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3d: the small-block forms at the paper MLP's junctions
# ---------------------------------------------------------------------------

SMALL_KERNELS = ("csd_spmm_fwd_small", "csd_spmm_dx_small",
                 "csd_spmm_dw_small", "csd_spmm_fwd_quant_small")
MLP_BATCH, MLP_FULL = 256, 8000  # train_mlp's batch; the training set
SMOKE_DECODE_M = 4  # phase 3f's decode step: 4 slots
SMALL_MAX_COPIES = 256  # of phase 3d's data inputs (<= 512 launches queued)


def small_junctions():
    """(name, pattern, rows, options) of phase 3d. The paper MLP's hidden
    junctions as ``train_mlp`` runs them (bias and relu fused; dx and dw
    with db on the masked cotangent): Table I's 800 -> 100 (16 x 4 blocks,
    fan-in 10) and CIFAR_MLP's 4000 -> 500 (16 x 4, fan-in 50) at the batch
    and the full training set, MNIST_4J's 100 -> 100 (4 x 4, fan-in 20) and
    TIMIT's 39 -> 390 (1 x 2) and 390 -> 39 (2 x 1) at the batch. Then the
    LM smoke configurations' 16 x 16 junctions as phase 3f runs them, f32:
    gemma3-4b's gate (gelu fused with ``save_preact``; dx and dw through
    the gelu mask) and down at the training step's rows, both forwards at
    a decode step's 4 slots, and granite-moe's expert-batched up and down
    at its 8 experts' training capacity. Then the int8 small-block forward
    (``ops`` ``fwd_quant``) at the junctions the lint certifies for it, f32
    and bf16 x: Table I's and CIFAR_MLP's at the batch and the training
    set, TIMIT's two at the batch (as ``SparseMLP.logits`` runs them: relu
    on the hidden one), the gemma3 smoke down junction at a decode step's 4
    rows and granite-moe's 8 smoke experts at 4 rows each. ``options``:
    ``experts``, ``act``, ``bias``, ``preact``, ``bwd_act`` (dx and dw take
    the saved output and the activation, as ``CsdMatmul`` launches them),
    ``ops``, ``bf16`` (also run in bf16 at the batch) and ``dtypes`` (run
    in each of these at every row count)."""
    from repro_torch.configs import get_config
    from repro_torch.configs import paper_mlp as pm
    from repro_torch.nn.mlp import mlp_patterns
    mlp = dict(act="relu", bias=True, bf16=True)
    t_in, t_out = mlp_patterns(pm.TIMIT, (0.2, 0.2))
    gate, down = junction_patterns(get_config("gemma3_4b", smoke=True))
    rcfg = get_config("granite_moe_1b_a400m", smoke=True)
    up_e, down_e = expert_patterns(rcfg)
    train_m = SMOKE_BATCH * SMOKE_SEQ
    experts = dict(experts=rcfg.moe.n_routed)
    cap = expert_capacity(rcfg, train_m)
    table1 = mlp_patterns(pm.MNIST_2J, pm.rho_from_dout(pm.MNIST_2J,
                                                         (20, 10)))[0]
    cifar = mlp_patterns(pm.CIFAR_MLP, (0.2, 0.5))[0]
    return [
        ("table1 800->100", table1, (MLP_BATCH, MLP_FULL), mlp),
        ("cifar 4000->500", cifar, (MLP_BATCH, MLP_FULL), mlp),
        ("mnist4j 100->100", mlp_patterns(pm.MNIST_4J, pm.rho_from_dout(
            pm.MNIST_4J, pm.TABLE2_MNIST[0][0]))[1], (MLP_BATCH,), mlp),
        ("timit 39->390", t_in, (MLP_BATCH,), mlp),
        ("timit 390->39", t_out, (MLP_BATCH,), mlp),
        ("gemma3 smoke gate", gate, (train_m,),
         dict(act="gelu", preact=True, bwd_act=True)),
        ("gemma3 smoke gate", gate, (SMOKE_DECODE_M,),
         dict(act="gelu", ops=("fwd",))),
        ("gemma3 smoke down", down, (train_m,), {}),
        ("gemma3 smoke down", down, (SMOKE_DECODE_M,), dict(ops=("fwd",))),
        ("granite smoke up", up_e, (cap,), experts),
        ("granite smoke down", down_e, (cap,), experts),
    ] + [(name, bp, rows, dict(opt, ops=("fwd_quant",),
                               dtypes=("float32", "bfloat16")))
         for name, bp, rows, opt in (
             ("table1 800->100", table1, (MLP_BATCH, MLP_FULL), mlp),
             ("cifar 4000->500", cifar, (MLP_BATCH, MLP_FULL), mlp),
             ("timit 39->390", t_in, (MLP_BATCH,), mlp),
             ("timit 390->39", t_out, (MLP_BATCH,), dict(bias=True)),
             ("gemma3 smoke down", down, (SMOKE_DECODE_M,), {}),
             ("granite smoke up", up_e, (SMOKE_DECODE_M,), experts))]


def small_copies(bp, m: int, dtype, opt: dict) -> int:
    """Copies of phase 3d's data inputs (x, dy and the saved output) that
    together pass the L2, at most ``SMALL_MAX_COPIES`` (the slab is
    shared)."""
    per_copy = (opt.get("experts") or 1) * m * (
        bp.n_in + bp.n_out * (2 if opt.get("bwd_act") else 1))
    return min(copies_for(dtype.itemsize * per_copy), SMALL_MAX_COPIES)


def small_calls(bp, m, dtype, gen, device, *, experts=None, act=None,
                bias=False, preact=False, bwd_act=False,
                ops=("fwd", "dx", "dw"), copies=1, **_):
    """Phase 3d's calls at one junction of ``m`` rows (per expert with
    ``experts``): (kernel, runs, plains, libraries, bytes, operations) for
    each of ``ops``. Each of runs, plains and libraries holds one call per
    copy of the data inputs (the slab is shared); the library is a dense
    ``torch.matmul`` (``torch.bmm`` over experts) on the densified slab.
    The wrappers are the shipped ones, which send these blocks to the
    small-block forms. ``fwd_quant``: the int8 forward over the slab
    quantized per block (``w_scale``), its library the matmul over the
    densified slab dequantized to x's dtype."""
    import torch
    from repro_torch.core.quant import dequantize_slab, quantize_slab
    from repro_torch.kernels import csd_spmm as k
    lead = (experts,) if experts else ()
    shape = lead + (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
    w = (torch.randn(shape, generator=gen, device=device)
         * math.sqrt(2 / (bp.d_in_b * bp.block_in))).to(dtype)
    b = (0.1 + 0.01 * torch.randn(lead + (bp.n_out,), generator=gen,
                                  device=device)).to(dtype) if bias else None

    def data(n_col, fn):
        return [fn(lead + (m, n_col), generator=gen, device=device).to(dtype)
                for _ in range(copies)]
    xs, gs = data(bp.n_in, torch.rand), data(bp.n_out, torch.randn)
    zs = data(bp.n_out, torch.randn) if bwd_act else [None] * copies
    pat = {f: torch.as_tensor(getattr(bp, f), dtype=torch.int32,
                              device=device)
           for f in ("block_idx", "out_idx", "out_slot")}
    densify = dense_of_experts if experts else dense_of
    wd = densify(bp, w)
    wt = wd.transpose(-2, -1)
    q, sc = quantize_slab(w.float()) if "fwd_quant" in ops else (None, None)
    wq = None if q is None else densify(bp, dequantize_slab(q, sc, dtype))
    batched = "_batched" if experts else ""
    fwd = {kind: getattr(k, f"csd_spmm_fwd{batched}_{kind}")
           for kind in ("cuda", "plain")}
    dx = {kind: getattr(k, f"csd_spmm_dx{batched}_{kind}")
          for kind in ("cuda", "plain")}
    dw = {kind: getattr(k, f"csd_spmm_dw{batched}_{kind}")
          for kind in ("cuda", "plain")}
    el = dtype.itemsize
    n_x, n_y, n_w = (math.prod(lead) * m * bp.n_in,
                     math.prod(lead) * m * bp.n_out, w.numel())
    n_aux = n_y if bwd_act else 0
    bwd = dict(aux=None, activation=act if bwd_act else None)
    kbw = dict(block_in=bp.block_in, block_out=bp.block_out,
               want_db=bool(bias))
    calls = {
        "fwd": ("csd_spmm_fwd_small",
                lambda kind, i: fwd[kind](
                    xs[i], w, pat["block_idx"], bias=b, activation=act,
                    save_preact=preact),
                lambda i: torch.matmul(xs[i], wd),
                el * (n_x + n_w + (b.numel() if bias else 0)
                      + n_y * (2 if preact else 1))
                + 4 * pat["block_idx"].numel()),
        "dx": ("csd_spmm_dx_small",
               lambda kind, i: dx[kind](
                   gs[i], w, pat["out_idx"], pat["out_slot"],
                   **dict(bwd, aux=zs[i])),
               lambda i: torch.matmul(gs[i], wt),
               el * (n_y + n_aux + n_w + n_x) + 8 * pat["out_idx"].numel()),
        "dw": ("csd_spmm_dw_small",
               lambda kind, i: dw[kind](
                   xs[i], gs[i], pat["block_idx"], **dict(bwd, aux=zs[i]),
                   **kbw),
               lambda i: torch.matmul(xs[i].transpose(-2, -1), gs[i]),
               el * (n_x + n_y + n_aux + n_w)
               + (4 * b.numel() if bias else 0)
               + 4 * pat["block_idx"].numel()),
        "fwd_quant": ("csd_spmm_fwd_quant_small",
                      lambda kind, i: fwd[kind](
                          xs[i], q, pat["block_idx"], bias=b,
                          activation=act, w_scale=sc),
                      lambda i: torch.matmul(xs[i], wq),
                      el * (n_x + (b.numel() if bias else 0) + n_y) + n_w
                      + 4 * (0 if sc is None else sc.numel())
                      + 4 * pat["block_idx"].numel())}
    out = []
    for op in ops:
        kernel, fn, lib, nbytes = calls[op]
        out.append((kernel,
                    [lambda i=i, fn=fn: fn("cuda", i) for i in range(copies)],
                    [lambda i=i, fn=fn: fn("plain", i)
                     for i in range(copies)],
                    [lambda i=i, lib=lib: lib(i) for i in range(copies)],
                    nbytes, 2 * m * n_w))
    return out


def run_small_kernels(device, results):
    """Phase 3d. The small-block forms at ``small_junctions``, each through
    the shipped wrapper, held against its plain version on the first copy
    of the inputs (f32 1e-4, bf16 1e-2 of max |plain|: the int8 gates too)
    and timed cycling through copies of the data inputs that together pass
    the L2 (at most ``SMALL_MAX_COPIES``; the slab is shared), beside the
    plain version, a dense ``torch.matmul`` (``torch.bmm``) on the
    densified (int8: dequantized) slab and the bound; then the mask kernel
    at the MLP's widths 100, 390 and 39 (equal element for element; the
    yardstick autograd's relu backward) and once at 77 x 39 bf16, past its
    last whole 16-byte chunk."""
    import torch
    from repro_torch.kernels import csd_spmm
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    for name, bp, rows, opt in small_junctions():
        for m in rows:
            dtypes = opt.get("dtypes") or (("float32", "bfloat16")
                                           if m == MLP_BATCH and opt.get(
                                               "bf16") else ("float32",))
            for dtype_name in dtypes:
                dtype = getattr(torch, dtype_name)
                copies = small_copies(bp, m, dtype, opt)
                for kernel, runs, plains, libs, nbytes, ops in small_calls(
                        bp, m, dtype, g, device, copies=copies, **opt):
                    before = wrapper(kernel).launches
                    rec = hold_and_time(kernel, runs, plains, libs, nbytes,
                                        ops, dtype)
                    rec = dict(rec, junction=name, m=m, dtype=dtype_name,
                               experts=opt.get("experts"),
                               activation=opt.get("act"),
                               bias=bool(opt.get("bias")),
                               save_preact=bool(opt.get("preact")),
                               masked_in_wrapper=bool(opt.get("bwd_act"))
                               and kernel != "csd_spmm_fwd_small",
                               block=[bp.block_in, bp.block_out],
                               fan_in=bp.d_in_b, copies=copies,
                               plan=captured_plan(runs[0]))
                    results.append(rec)
                    log(json.dumps(rec))
                    if not rec["ok"]:
                        fail(f"{kernel} disagrees with its plain version: "
                             f"{rec}")
                    if wrapper(kernel).launches == before:
                        fail(f"{name}: the wrapper did not run {kernel}")
                    del runs, plains, libs
                torch.cuda.empty_cache()
    for rows, n_out, dtype_name in ((MLP_BATCH, 100, "float32"),
                                    (MLP_BATCH, 390, "float32"),
                                    (MLP_BATCH, 39, "float32"),
                                    (77, 39, "bfloat16")):
        dtype = getattr(torch, dtype_name)
        dy = torch.randn((rows, n_out), generator=g, device=device).to(dtype)
        aux = torch.randn((rows, n_out), generator=g, device=device) \
            .to(dtype)
        rec = hold_and_time(
            "csd_mask_cotangent",
            lambda: csd_spmm.csd_mask_cotangent_cuda(dy, aux, "relu"),
            lambda: csd_spmm.mask_cotangent(dy, aux, "relu"),
            lambda: torch.ops.aten.threshold_backward(dy, aux, 0.0),
            3 * dtype.itemsize * rows * n_out, 0, dtype, exact=True)
        rec = dict(rec, junction=f"mlp hidden {n_out}", m=rows,
                   dtype=dtype_name, activation="relu",
                   library="torch.ops.aten.threshold_backward")
        results.append(rec)
        log(json.dumps(rec))
        if not rec["ok"]:
            fail(f"csd_mask_cotangent differs from its plain version: {rec}")
    torch.cuda.empty_cache()


def captured_plan(run) -> dict:
    """The kernel, grid, threads, shared memory, cluster and arguments of
    the plan ``run`` launches on this card (captured, not launched)."""
    from repro_torch.analysis.capture import capture_launch
    import torch
    plan = capture_launch(run, n_sm=torch.cuda.get_device_properties(
        0).multi_processor_count)
    ln = plan.launches[0]
    return dict(name=plan.name, kernel=ln.kernel, grid=list(ln.grid),
                threads=ln.threads, smem=ln.smem, cluster=ln.cluster[0],
                args=dict(plan.args))


# ---------------------------------------------------------------------------
# phase 3e: train the paper's MLP
# ---------------------------------------------------------------------------

MLP_EPOCHS = 3
MLP_MIN_ACC = 0.5  # the kernels' run, on held-out data; chance is 1/10, 1/39


def mlp_runs():
    """(name, MLPConfig, data) of phase 3e: Table I's sparse column, Table
    II's MNIST_4J row d_out (80, 80, 80, 10), and TIMIT at rho (0.2, 0.2)
    (1 x 2 and 2 x 1 blocks), all block_gather at the paper's widths, on
    ``synthetic_mnist(8000, 2000)`` and, for TIMIT, ``synthetic_features``
    of 39 features and 39 classes."""
    import dataclasses
    from repro_torch.configs import paper_mlp as pm
    from repro_torch.data import synthetic_features, synthetic_mnist
    from repro_torch.nn.mlp import MLPConfig
    mnist = synthetic_mnist(MLP_FULL, 2000)
    timit = synthetic_features(MLP_FULL, 2000, n_classes=39, n_features=39)
    return [
        ("table1_sparse", dataclasses.replace(pm.table1_sparse(),
                                              mode="block_gather"), mnist),
        ("table2_mnist4j_d80", MLPConfig(
            n_net=pm.MNIST_4J, rho=pm.rho_from_dout(
                pm.MNIST_4J, pm.TABLE2_MNIST[0][0]), mode="block_gather"),
         mnist),
        ("timit", MLPConfig(n_net=pm.TIMIT, rho=(0.2, 0.2),
                            mode="block_gather"), timit),
    ]


def mlp_launches_per_step(model) -> dict:
    """Every kernel's launches in one training step of a paper MLP: each
    block junction runs the small-block forward and dw once and dx once
    unless it is the first (the data needs no gradient); each block
    junction but the last fuses the hidden relu, so its backward runs the
    mask kernel once; dense junctions are ``torch.matmul``."""
    block = [l.mode.startswith("block") for l in model.layers]
    want = {"csd_spmm_fwd_small": sum(block),
            "csd_spmm_dx_small": sum(block[1:]),
            "csd_spmm_dw_small": sum(block),
            "csd_mask_cotangent": sum(block[:-1])}
    return {k: want.get(k, 0) for k in ALL_KERNELS}


def mlp_step(model, x, y, l2):
    """One step's loss tensor and every gradient (copies)."""
    import torch
    model.zero_grad(set_to_none=True)
    loss = model.loss(x, y, l2)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return loss.detach(), grads


def run_mlp(device) -> list:
    """Phase 3e: each paper MLP on the card from one init (seed 0): its
    first step with the kernels and with the plain versions (f32 gates of
    phase 7's f32 step: loss 1e-5, gradient norm 1e-4, each gradient 1e-3
    relative Frobenius), two identical steps bit-equal, one step's exact
    launches, then ``train_mlp`` for ``MLP_EPOCHS`` epochs of batch 256
    with the kernels (the launches of every step and of the held-out
    evaluation exact) and with the plain versions; both test accuracies
    recorded, the kernels' above ``MLP_MIN_ACC``; between the two runs the
    kernels' trained model evaluated in int8 (``mlp_int8``)."""
    import numpy as np
    import torch
    from repro_torch.nn.mlp import SparseMLP, train_mlp
    out = []
    for name, cfg, data in mlp_runs():
        model = SparseMLP(cfg, device=device)
        init = model.init(SEED)
        model.load_params(init)
        l2 = 1e-4 * model.density()
        idx = torch.as_tensor(np.random.default_rng(SEED).permutation(
            data[0].shape[0])[:MLP_BATCH], device=device)
        x = torch.as_tensor(data[0], device=device)[idx]
        y = torch.as_tensor(data[1], device=device)[idx]
        loss_k, grads_k = mlp_step(model, x, y, l2)
        with plain_versions():
            loss_p, grads_p = mlp_step(model, x, y, l2)
        loss_k2, grads_k2 = mlp_step(model, x, y, l2)

        def norm(gs):
            return float(torch.sqrt(sum((t.double() ** 2).sum()
                                        for t in gs.values())))
        gn_k, gn_p = norm(grads_k), norm(grads_p)
        rel = {n: float(torch.linalg.vector_norm(grads_k[n] - grads_p[n])
                        / torch.linalg.vector_norm(grads_p[n]))
               for n in grads_k}
        tol = STEP_TOL["float32"]
        chk = dict(check=f"paper MLP {name}: first step, kernels vs plain",
                   loss_kernels=float(loss_k), loss_plain=float(loss_p),
                   loss_rel_err=abs(float(loss_k) - float(loss_p))
                   / abs(float(loss_p)),
                   grad_norm_kernels=gn_k, grad_norm_plain=gn_p,
                   grad_norm_rel_err=abs(gn_k - gn_p) / gn_p,
                   grad_rel_fro_err=rel, tol=tol,
                   bit_identical_rerun=bool(torch.equal(loss_k, loss_k2))
                   and all(torch.equal(grads_k[n], grads_k2[n])
                           for n in grads_k))
        log(json.dumps(chk))
        if not math.isfinite(chk["loss_kernels"]) \
                or chk["loss_rel_err"] > tol["loss"] \
                or chk["grad_norm_rel_err"] > tol["grad_norm"] \
                or max(rel.values()) > tol["slab_grad"]:
            fail(f"paper MLP {name}: the kernels' step disagrees with "
                 f"plain: {chk}")
        if not chk["bit_identical_rerun"]:
            fail(f"paper MLP {name}: two identical steps differ: {chk}")
        per_step = mlp_launches_per_step(model)
        reset_launch_counts()
        mlp_step(model, x, y, l2)
        if launch_counts() != per_step:
            fail(f"paper MLP {name}: a step launched {launch_counts()}, "
                 f"expected {per_step}")
        steps = MLP_EPOCHS * (data[0].shape[0] // MLP_BATCH)
        reset_launch_counts()
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, acc_k = train_mlp(model, data, epochs=MLP_EPOCHS, batch=MLP_BATCH,
                             seed=SEED, params=init,
                             on_step=lambda t, l: losses.append(l))
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        launches = launch_counts()
        n_block = per_step["csd_spmm_fwd_small"]
        want = {k: v * steps + (n_block if k == "csd_spmm_fwd_small" else 0)
                for k, v in per_step.items()}
        if launches != want:
            fail(f"paper MLP {name}: training launched {launches}, "
                 f"expected {want} ({steps} steps and one evaluation)")
        int8_rec = mlp_int8(name, model, data, device)
        with plain_versions():
            t0 = time.perf_counter()
            _, acc_p = train_mlp(model, data, epochs=MLP_EPOCHS,
                                 batch=MLP_BATCH, seed=SEED, params=init)
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t0
        losses = [float(v) for v in losses]
        rec = dict(
            check=f"paper MLP {name}: train_mlp", n_net=list(cfg.n_net),
            rho=list(cfg.rho), blocks=[
                [l.pattern.block_in, l.pattern.block_out, l.pattern.d_in_b]
                if l.mode.startswith("block") else "dense"
                for l in model.layers],
            n_weights=model.n_weights(), epochs=MLP_EPOCHS,
            batch=MLP_BATCH, steps=steps, first_loss=losses[0],
            last_loss=losses[-1], test_acc_kernels=acc_k,
            test_acc_plain=acc_p, step_ms_kernels=t_k / steps * 1e3,
            step_ms_plain=t_p / steps * 1e3, launches=launches,
            launches_per_step={k: v for k, v in per_step.items() if v},
            first_step=chk, int8=int8_rec)
        log(json.dumps(dict(
            {k: v for k, v in rec.items() if k not in ("first_step", "int8")},
            launches={k: v for k, v in launches.items() if v})))
        if not all(math.isfinite(v) for v in losses) or acc_k < MLP_MIN_ACC:
            fail(f"paper MLP {name}: training failed: {rec}")
        out.append(rec)
        del model
        torch.cuda.empty_cache()
    return out


# max |kernels - plain| of the int8 MLP's test-set logits over max |plain|:
# f32 sums in another order (the int8 gate)
MLP_INT8_TOL = 1e-4


def mlp_int8(name, model, data, device) -> dict:
    """Phase 3e's int8 evaluation: a copy of the trained ``model``
    quantized by ``quantize_model`` (each block junction an int8 slab with
    per-block f32 scales), its test-set logits with the kernels and with
    the plain versions (within ``MLP_INT8_TOL`` of max |plain|), exactly one
    launch of the int8 small-block forward per block junction and no other
    junction kernel; the int8 and f32 test accuracies and the resident slab
    bytes, f32 against int8 plus scales."""
    import copy
    import torch
    from repro_torch.core.quant import quantize_model
    qmodel = quantize_model(copy.deepcopy(model))
    blocks = [(f, q) for f, q in zip(model.layers, qmodel.layers)
              if f.mode.startswith("block")]
    x = torch.as_tensor(data[2], device=device)
    y = torch.as_tensor(data[3], device=device).long()
    with torch.no_grad():
        reset_launch_counts()
        logits = qmodel.logits(x)
        torch.cuda.synchronize()
        launches = launch_counts()
        with plain_versions():
            logits_p = qmodel.logits(x)
        acc_f32 = model.accuracy(x, y)
    err = float((logits - logits_p).abs().max())
    scale = float(logits_p.abs().max())
    want = {k: len(blocks) if k == "csd_spmm_fwd_quant_small" else 0
            for k in ALL_KERNELS}
    rec = dict(
        check=f"paper MLP {name}: int8 evaluation", test_rows=x.shape[0],
        test_acc_int8=float((logits.argmax(-1) == y).float().mean()),
        test_acc_int8_plain=float((logits_p.argmax(-1) == y).float().mean()),
        test_acc_f32=acc_f32, logits_max_abs_err=err,
        logits_max_abs_ref=scale, tol=MLP_INT8_TOL,
        slab_bytes_f32=sum(f.weight.numel() * f.weight.element_size()
                           for f, _ in blocks),
        slab_bytes_int8=sum(q.weight.numel() for _, q in blocks),
        scale_bytes=sum(q.w_scale.numel() * 4 for _, q in blocks),
        launches={k: v for k, v in launches.items() if v})
    log(json.dumps(rec))
    if launches != want or not err <= MLP_INT8_TOL * scale \
            or not bool(torch.isfinite(logits).all()) \
            or any(q.weight.dtype != torch.int8 for _, q in blocks):
        fail(f"paper MLP {name}: the int8 evaluation is not as expected: "
             f"{rec}; expected launches {want}")
    return rec


# ---------------------------------------------------------------------------
# phase 3f: the LM smoke configurations (16 x 16 blocks) through the CLIs
# ---------------------------------------------------------------------------

SMOKE_STEPS, SMOKE_BATCH, SMOKE_SEQ = 3, 2, 32
# f32, 3 AdamW steps: phase 7's f32 step gates
SMOKE_TOL = {"loss": 1e-5, "grad_norm": 1e-4}
# max |kernels - plain| of the served steps' logits over max |plain|: f32
# sums in another order (``TRAIN_TOL``'s f32 gate)
SMOKE_LOGIT_TOL = 1e-4


def smoke_train(arch: str, plain: bool, extra=()) -> list:
    """``repro_torch.launch.train.main`` on the smoke configuration of
    ``arch`` on the card (with the options ``extra``); its printed metrics
    per step."""
    import ast
    import contextlib
    import io
    from repro_torch.launch import train as train_cli
    buf = io.StringIO()
    argv = ["--arch", arch, "--steps", str(SMOKE_STEPS), "--batch",
            str(SMOKE_BATCH), "--seq", str(SMOKE_SEQ), "--device", "cuda",
            *extra]
    with contextlib.redirect_stdout(buf), \
            (plain_versions() if plain else contextlib.nullcontext()):
        train_cli.main(argv)
    return [ast.literal_eval(line.split(": ", 1)[1])
            for line in buf.getvalue().splitlines()
            if line.startswith("step ")]


def trace_spans(prof_dir: Path, name: str) -> int:
    """How many host ranges named ``name`` the Chrome traces in
    ``prof_dir`` hold (on the card each also has a ``gpu_user_annotation``
    twin on the device's timeline)."""
    return sum(e.get("name") == name and e.get("cat") == "user_annotation"
               for f in sorted(prof_dir.glob("trace_*.json"))
               for e in json.loads(f.read_text())["traceEvents"])


def smoke_restart(arch: str) -> dict:
    """Phase 3f's fault-tolerance run: ``launch.train.main`` with
    ``--checkpoint-every 2 --diloco 2 --simulate-failure-at 3`` and a
    checkpoint directory, ``--metrics-jsonl`` and ``--profile-dir``, against
    the same command without the failure: the losses bit-equal, the cut
    run's checkpoints at steps 2 and 3, each JSONL stream replayed through
    ``repro_torch.obs.dump`` with its run's steps, and each Chrome trace
    naming ``train/step`` once a step."""
    import tempfile
    from repro_torch.obs import dump
    from repro_torch.train import CheckpointManager
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3f_") as tmp:
        runs = {}
        for run in ("cut", "uncut"):
            d = Path(tmp) / run
            extra = ["--checkpoint-every", "2", "--diloco", "2",
                     "--checkpoint-dir", str(d / "ckpt"), "--metrics-jsonl",
                     str(d / "m.jsonl"), "--profile-dir", str(d / "prof")]
            if run == "cut":
                extra += ["--simulate-failure-at", "3"]
            hist = smoke_train(arch, False, extra)
            replayed = dump.replay(str(d / "m.jsonl"))
            runs[run] = dict(
                losses=[h["loss"] for h in hist],
                checkpoints=CheckpointManager(str(d / "ckpt")).steps(),
                jsonl_steps=replayed.counter("train_steps_total").value(),
                trace_steps=trace_spans(d / "prof", "train/step"))
    rec = dict(check=f"{arch} smoke: launch.train.main restart, DiLoCo, "
                     f"metrics and profile", **runs)
    log(json.dumps(rec))
    cut, uncut = runs["cut"], runs["uncut"]
    if cut["losses"] != uncut["losses"] \
            or len(cut["losses"]) != SMOKE_STEPS \
            or cut["checkpoints"] != [2, 3] \
            or any(r["jsonl_steps"] != SMOKE_STEPS
                   or r["trace_steps"] != SMOKE_STEPS for r in runs.values()):
        fail(f"{arch} smoke restart run: {rec}")
    return rec


def forced_logits(model, prompt, gen, device, page_size=16, quant_kv=False):
    """The logits from which a greedy engine chose ``gen`` (B, G): the
    model's paged steps fed ``prompt`` (B, P) as one prefill chunk, then
    ``gen`` one token a step (over int8 pages with ``quant_kv``); ((B, G,
    vocab) f32, the cache the steps filled)."""
    import torch
    from repro_torch.nn.common import dtype_of
    b, p = prompt.shape
    n_gen = gen.shape[1]
    per_row = -(-(p + n_gen) // page_size)
    table = torch.arange(b * per_row, dtype=torch.int32,
                         device=device).reshape(b, per_row)
    cache = model.init_paged_cache(b * per_row, page_size,
                                   dtype_of(model.cfg), device,
                                   quant_kv=quant_kv)

    def step(toks, pos, n):
        return model.paged_step(
            torch.as_tensor(toks, device=device),
            torch.full((b,), pos, dtype=torch.int32, device=device),
            torch.full((b,), n, dtype=torch.int32, device=device), cache,
            table)[:, 0].float()

    with torch.no_grad():
        out = [step(prompt, 0, p)]
        for j in range(n_gen - 1):
            out.append(step(gen[:, j:j + 1], p + j, 1))
    return torch.stack(out, 1), cache


def state_logits(model, prompt, gen, device, page_size=16):
    """The logits of ``forced_logits``'s steps over int8 KV pages, each step
    run with the kernels and with the plain versions from one cache state
    (the plain run's): ((B, G, vocab) kernels, (B, G, vocab) plain, the
    int8 K/V entries the two wrote differently in all steps). Over int8
    pages the free-running comparison of ``forced_logits`` compares two
    caches: a K or V token quantized a level apart (an f32 rounding
    difference upstream) moves every later step by a quantization step,
    which is not the kernels' error; inside one step the new token's K and
    V are quantized too, so such a flip can still reach the step's later
    layers."""
    import torch
    from repro_torch.nn.common import dtype_of
    b, p = prompt.shape
    n_gen = gen.shape[1]
    per_row = -(-(p + n_gen) // page_size)
    table = torch.arange(b * per_row, dtype=torch.int32,
                         device=device).reshape(b, per_row)
    cache = model.init_paged_cache(b * per_row, page_size,
                                   dtype_of(model.cfg), device, quant_kv=True)

    def step(c, toks, pos, n):
        return model.paged_step(
            torch.as_tensor(toks, device=device),
            torch.full((b,), pos, dtype=torch.int32, device=device),
            torch.full((b,), n, dtype=torch.int32, device=device), c,
            table)[:, 0].float()

    kern, plain, flips = [], [], 0
    with torch.no_grad():
        for j in range(n_gen):
            toks, pos, n = (prompt, 0, p) if j == 0 \
                else (gen[:, j - 1:j], p + j - 1, 1)
            trial = [{k: t.clone() for k, t in c.items()} for c in cache]
            kern.append(step(trial, toks, pos, n))
            with plain_versions():
                plain.append(step(cache, toks, pos, n))
            flips += sum(int((a[k] != c[k]).sum())
                         for a, c in zip(trial, cache) for k in a
                         if a[k].dtype == torch.int8)
    return torch.stack(kern, 1), torch.stack(plain, 1), flips


# the smoke configurations phase 3f serves (the MoE one in int8 only, at
# the dropless capacity factor: its published one drops) and trains
SMOKE_SERVED = ("gemma3_4b", "gemma2_9b", "qwen2_7b", "granite_34b")
SMOKE_SERVED_INT8 = SMOKE_SERVED + ("granite_moe_1b_a400m",)
SMOKE_TRAINED = ("gemma3_4b", "granite_moe_1b_a400m", "gemma2_9b",
                 "qwen2_7b", "granite_34b")


def run_smoke_configs(device) -> dict:
    """Phase 3f: the smoke configurations of gemma3-4b and of the dense
    decoders (gemma2-9b, qwen2-7b, granite-34b) served through
    ``launch.serve.generate`` (4 prompts of 32 tokens, 16 new) and trained
    through ``launch.train.main`` (3 steps of 2 x 32 tokens), and
    granite-moe's trained the same way, on the card: their 16 x 16 FFN and
    expert blocks run the small-block forms (no "multiples of 64"
    refusal). Training launches exactly those of ``train_launches_per_step``
    with the junction kernels' small-block forms in place of the full-width
    ones; each run is repeated with the plain versions: the losses and
    gradient norms within ``SMOKE_TOL``. Serving is repeated with the plain
    versions: the first token of every row equal, and the logits of every
    served step, teacher-forced on the kernels' tokens, within
    ``SMOKE_LOGIT_TOL`` of the plain versions'; whole-row token agreement
    recorded. Then each is served again in int8 (``SparsityConfig.quant``:
    weights and KV), granite-moe's too at the dropless capacity factor, with
    the same checks against the int8 plain versions, through the int8
    small-block forward and the int8 paged decode; there the logits are
    compared step by step from one cache state (``state_logits``), the
    free-running teacher-forced difference recorded with the int8 KV
    entries the two runs quantized differently."""
    import torch
    from repro_torch.configs import get_config
    out = {}
    for arch in SMOKE_SERVED:
        out[f"{arch}_serve"] = smoke_serve(arch, device)
    for arch in SMOKE_SERVED_INT8:
        out[f"{arch}_serve_int8"] = smoke_serve(arch, device, quant=True)
    for arch in SMOKE_TRAINED:
        c = get_config(arch, smoke=True)
        reset_launch_counts()
        hist = smoke_train(arch, plain=False)
        launches = launch_counts()
        hist_p = smoke_train(arch, plain=True)
        want = train_launches_per_step(c)
        form = "_batched" if c.moe is not None else ""
        for op in ("fwd", "dx", "dw"):
            want[f"csd_spmm_{op}_small"] = want.pop(f"csd_spmm_{op}{form}")
        want = {k: want.get(k, 0) * SMOKE_STEPS for k in ALL_KERNELS}
        err = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                      zip(hist, hist_p)) for k in ("loss", "grad_norm")}
        rec = dict(check=f"{c.name} smoke: launch.train.main", steps=len(hist),
                   losses=[h["loss"] for h in hist],
                   losses_plain=[h["loss"] for h in hist_p],
                   grad_norms=[h["grad_norm"] for h in hist],
                   rel_err=err, tol=SMOKE_TOL, launches=launches)
        log(json.dumps(dict(rec, launches={k: v for k, v in launches.items()
                                           if v})))
        if len(hist) != SMOKE_STEPS or launches != want \
                or any(err[k] > SMOKE_TOL[k] for k in SMOKE_TOL) \
                or not all(math.isfinite(h["loss"]) for h in hist):
            fail(f"{c.name} smoke training: {rec}; expected launches "
                 f"{want}")
        out[f"{arch}_train"] = rec
        if arch == "gemma3_4b":
            rec["restart"] = smoke_restart(arch)
    torch.cuda.empty_cache()
    return out


def smoke_serve(arch: str, device, quant: bool = False) -> dict:
    """Phase 3f's served run of ``arch``'s smoke configuration (see
    ``run_smoke_configs``); with ``quant`` in int8 (weights and KV pages,
    the configuration's ``SparsityConfig.quant``, which the engine reads
    and applies at load), an MoE configuration at the dropless capacity
    factor n_routed / top_k."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve import generate
    from repro_torch.nn.model import LM
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
    if quant:
        cfg = cfg.with_(sparsity=dataclasses.replace(
            cfg.sparsity, quant=QuantConfig(weights=True, kv=True)))
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(SEED))
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                  (4, 32))
    reset_launch_counts()
    toks, tps = generate(model, prompt, 48, 16, device=device, seed=SEED)
    launches = launch_counts()
    # the engine quantized the model in place at load
    logits, cache = forced_logits(model, prompt, toks, device,
                                  quant_kv=quant)
    with plain_versions():
        toks_p, _ = generate(model, prompt, 48, 16, device=device, seed=SEED)
        logits_p, cache_p = forced_logits(model, prompt, toks, device,
                                          quant_kv=quant)
    err = float((logits - logits_p).abs().max())
    scale = float(logits_p.abs().max())
    gated = (err, scale)
    if quant:
        # int8 KV: each step from one cache state (``state_logits``); the
        # free-running difference and the int8 KV entries it rests on
        # recorded
        lk, lp, flips = state_logits(model, prompt, toks, device)
        gated = (float((lk - lp).abs().max()), float(lp.abs().max()))
        pages = [(a[k], c[k]) for a, c in zip(cache, cache_p) for k in a
                 if a[k].dtype == torch.int8]
        kv_diff = dict(
            entries=sum(int((a != c).sum()) for a, c in pages),
            of=sum(a.numel() for a, _ in pages),
            max_levels=max(int((a.int() - c.int()).abs().max())
                           for a, c in pages))
    fwd = "csd_spmm_fwd_quant_small" if quant else "csd_spmm_fwd_small"
    paged = "paged_decode_attention" + ("_quant" if quant else "") + (
        "_grouped" if cfg.n_heads // cfg.n_kv_heads > 8 else "")
    # no other junction kernel: no full-width body, no f32/bf16 forward in
    # the int8 run, nothing of training
    others = [k for k in ALL_KERNELS if k.startswith("csd_") and k != fwd
              and launches[k]]
    rec = dict(check=f"{cfg.name} smoke{' int8' if quant else ''}: "
                     f"launch.serve.generate",
               capacity_factor=None if cfg.moe is None
               else cfg.moe.capacity_factor,
               tokens=list(toks.shape), tok_per_s=tps, launches={
                   k: v for k, v in launches.items() if v},
               token_agreement=float((toks == toks_p).mean()),
               first_tokens_equal=bool((toks[:, 0] == toks_p[:, 0]).all()),
               logits_max_abs_err=err, logits_max_abs_ref=scale,
               logits_tol=SMOKE_LOGIT_TOL,
               forced_argmax_agreement=float(
                   (logits.argmax(-1).cpu().numpy() == toks).mean()))
    if quant:
        rec.update(state_logits_max_abs_err=gated[0],
                   state_logits_max_abs_ref=gated[1],
                   state_kv_int8_differ=flips,
                   free_running_kv_int8_differ=kv_diff)
    log(json.dumps(rec))
    if launches[fwd] == 0 or launches[paged] == 0 or others \
            or not rec["first_tokens_equal"] \
            or not gated[0] <= SMOKE_LOGIT_TOL * gated[1]:
        fail(f"the {cfg.name} smoke configuration did not serve as "
             f"expected: {rec}")
    rec["spec"] = smoke_spec(model, device, fwd, paged)
    return rec


def smoke_spec(model, device, fwd: str, paged: str) -> dict:
    """Phase 3f's speculative run: ``model`` (a smoke configuration, as
    ``smoke_serve`` served it) serves 4 periodic prompts of 32 tokens (16
    new each, ``generate``'s engine knobs) with ``spec_k`` = ``SPEC_K``
    and without it: the tokens must be equal, the spec-on run must draft,
    and it must launch only ``fwd`` and ``paged``."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg = model.cfg
    prompts = periodic_prompts(cfg.vocab_size, (32,) * 4)
    knobs = dict(max_slots=4, page_size=16, total_pages=12,
                 max_pages_per_seq=3, token_budget=36, prefill_chunk=64)
    toks = {}
    for spec_k in (0, SPEC_K):
        eng = ServingEngine(model, EngineConfig(spec_k=spec_k, **knobs),
                            device=device)
        reset_launch_counts()
        toks[spec_k] = [o.tolist() for o in eng.run(prompts, 16)]
    launches = {k: v for k, v in launch_counts().items() if v}
    tag = " int8" if cfg.sparsity.quant is not None else ""
    rec = dict(check=f"{cfg.name} smoke{tag}: spec_k {SPEC_K} vs 0",
               stats=dict(eng.sched.stats),
               tokens_equal=toks[0] == toks[SPEC_K], launches=launches)
    log(json.dumps(rec))
    if not rec["tokens_equal"] or not eng.sched.stats["spec_drafted"] \
            or set(launches) - {fwd, paged} or not launches.get(fwd):
        fail(f"the {cfg.name} smoke configuration's speculative run: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 3g: the port's example scripts
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_quickstart.py", "torch_train_sparse_mlp.py",
            "torch_serve_batched.py", "torch_sparse_llm_pretrain.py")
PRETRAIN = "torch_sparse_llm_pretrain.py"


def pretrain_losses(stdout: str) -> tuple:
    """(first loss, last loss, tok/s) from the pretraining example's
    ``done: a -> b (r tok/s on cuda)`` line."""
    line = next(ln for ln in stdout.splitlines() if ln.startswith("done: "))
    first, rest = line[len("done: "):].split(" -> ")
    last, rate = rest.split(" (")
    return float(first), float(last), float(rate.split()[0])


def run_examples() -> dict:
    """Each of the port's example scripts once at its defaults (the card),
    all at once, each in its own process (the pretraining example with
    ``--checkpoint-dir``): each must exit 0, the pretraining example's last
    loss below its first; their time and last lines recorded (the rates
    they print share the card). Then the pretraining example alone at
    ``--size full100m --steps 60``, its tok/s recorded."""
    import os
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_3g_") as tmp:
        for batch in ({name: [] for name in EXAMPLES},
                      {PRETRAIN: ["--size", "full100m", "--steps", "60"]}):
            t0 = time.perf_counter()
            procs = {name: subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / name), *args]
                + (["--checkpoint-dir", str(Path(tmp) / f"ckpt{len(out)}")]
                   if name == PRETRAIN else []),
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
                for name, args in batch.items()}
            try:
                for name, proc in procs.items():
                    stdout, stderr = proc.communicate(timeout=300)
                    rec = dict(check=f"examples/{name}", args=batch[name],
                               rc=proc.returncode,
                               seconds=time.perf_counter() - t0,
                               stdout=stdout.splitlines()[-6:])
                    if proc.returncode == 0 and name == PRETRAIN:
                        rec["first_loss"], rec["last_loss"], \
                            rec["tokens_per_s"] = pretrain_losses(stdout)
                    log(json.dumps(rec))
                    if proc.returncode != 0:
                        fail(f"examples/{name} exited {proc.returncode}: "
                             f"{stderr[-2000:]}")
                    if name == PRETRAIN and not batch[name] \
                            and not rec["last_loss"] < rec["first_loss"]:
                        fail(f"examples/{name}: the loss did not fall: "
                             f"{rec}")
                    out[name + (" full100m" if batch[name] else "")] = rec
            finally:
                for proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
    return out


# ---------------------------------------------------------------------------
# phase 5: serve gemma3-4b at full width
# ---------------------------------------------------------------------------

LOGIT_TOL = 5e-2  # of the largest |logit|: 34 bf16 layers of rounding
# phases 5e-5h: 4 requests of 64-128 prompt tokens, 16 new tokens each;
# gemma2-9b also serves one of GEMMA2_LONG prompt tokens, past its window
DENSE_PROMPTS, DENSE_NEW, GEMMA2_LONG = (64, 96, 112, 128), 16, 4160
NEAR_TIE_MARGIN = 0.05  # top-2 logit gap below which a flip is a near tie


def engine_config(quant=None, **knobs):
    """The serving runs' engine: 4 slots of up to 10 pages of 16 tokens
    (``knobs`` override, as phases 5e and 5f do for the 4,160-token
    request)."""
    from repro_torch.serving.engine import EngineConfig
    kw = dict(max_slots=4, page_size=16, total_pages=40,
              max_pages_per_seq=10, token_budget=256, prefill_chunk=64)
    kw.update(knobs)
    return EngineConfig(quant=quant, **kw)


def serve_kernels(cfg, quant) -> tuple:
    """The (junction, paged decode) kernels a serving run of ``cfg`` must
    launch: the expert-batched forward for an MoE model, the int8 forms
    with ``quant``, the grouped paged decode for more than 8 query heads a
    KV head."""
    fwd = "csd_spmm_fwd" + ("" if quant is None else "_quant") \
        + ("_batched" if cfg.moe is not None else "")
    paged = "paged_decode_attention" + ("" if quant is None else "_quant") \
        + ("_grouped" if cfg.n_heads // cfg.n_kv_heads > 8 else "")
    return fwd, paged


def resident_bytes(eng) -> dict:
    """Bytes on the card of the sparse junctions' slabs (FFN ``Linear``s
    and MoE expert slabs) and their scales, and of the page pool (pages
    and per-token scales)."""
    from repro_torch.nn.ffn import MoE
    from repro_torch.nn.layers import Linear
    slabs = []  # (weight, scale or None)
    for m in eng.model.modules():
        if isinstance(m, Linear) and m.is_sparse:
            slabs.append((m.weight, m.w_scale))
        elif isinstance(m, MoE):
            slabs += [(getattr(m, n), getattr(m, f"{n}_scale"))
                      for n in ("up", "gate", "down")
                      if getattr(m, f"{n}_idx") is not None]
    return dict(
        ffn_slab_bytes=sum(w.numel() * w.element_size() for w, _ in slabs),
        ffn_slab_dtype=str(slabs[0][0].dtype),
        ffn_scale_bytes=sum(sc.numel() * 4 for _, sc in slabs
                            if sc is not None),
        kv_pool_bytes=sum(t.numel() * t.element_size()
                          for c in eng.cache for t in c.values()))


@contextmanager
def plain_versions():
    """Run the model's kernels through their plain versions (on the card)
    for a reference step; the port itself has no such switch."""
    from repro_torch.kernels import csd_spmm, flash_attention
    from repro_torch.nn import attention

    def fwd_quant_plain(x, w, w_scale, block_idx, **kw):
        return csd_spmm.csd_spmm_fwd_plain(x, w, block_idx, w_scale=w_scale,
                                           **kw)

    def fwd_quant_batched_plain(x, w, w_scale, block_idx, **kw):
        return csd_spmm.csd_spmm_fwd_batched_plain(x, w, block_idx,
                                                   w_scale=w_scale, **kw)

    with mock.patch.object(csd_spmm, "csd_spmm_fwd_cuda",
                           csd_spmm.csd_spmm_fwd_plain), \
            mock.patch.object(csd_spmm, "csd_spmm_fwd_quant_cuda",
                              fwd_quant_plain), \
            mock.patch.object(csd_spmm, "csd_spmm_fwd_batched_cuda",
                              csd_spmm.csd_spmm_fwd_batched_plain), \
            mock.patch.object(csd_spmm, "csd_spmm_fwd_quant_batched_cuda",
                              fwd_quant_batched_plain), \
            mock.patch.object(flash_attention,
                              "paged_decode_attention_quant_cuda",
                              flash_attention.paged_decode_attention_plain), \
            mock.patch.object(csd_spmm, "csd_spmm_dx_cuda",
                              csd_spmm.csd_spmm_dx_plain), \
            mock.patch.object(csd_spmm, "csd_spmm_dw_cuda",
                              csd_spmm.csd_spmm_dw_plain), \
            mock.patch.object(csd_spmm, "csd_spmm_dx_batched_cuda",
                              csd_spmm.csd_spmm_dx_batched_plain), \
            mock.patch.object(csd_spmm, "csd_spmm_dw_batched_cuda",
                              csd_spmm.csd_spmm_dw_batched_plain), \
            mock.patch.object(csd_spmm, "csd_mask_cotangent_cuda",
                              csd_spmm.mask_cotangent), \
            mock.patch.object(attention, "paged_decode_attention",
                              flash_attention.paged_decode_attention_plain), \
            mock.patch.object(flash_attention, "flash_attention_cuda",
                              flash_attention.flash_attention_plain), \
            mock.patch.object(flash_attention, "flash_attention_bwd_cuda",
                              flash_attention.flash_attention_bwd_plain):
        yield


def serve(model, device, out_dir, quant=None,
          prompt_lens=(64, 96, 112, 128), n_new=32, trace="decode_trace",
          slab_bytes=None, knobs=None):
    """Serve ``model`` (phases 5, 5c, 5e, 5g and 5h; with ``quant`` 5b, 5d
    and 5f) and check it; with ``slab_bytes`` the resident slab bytes must
    be those; ``knobs`` override the engine's (``engine_config``)."""
    knobs = knobs or {}
    import numpy as np
    import torch
    from repro_torch.serving.engine import ServingEngine

    cfg = model.cfg
    tag = "int8" if quant is not None else cfg.dtype
    t0 = time.perf_counter()
    n_params = sum(p.numel() for p in model.parameters())
    warm = ServingEngine(model, engine_config(quant, **knobs),
                         device=device)
    warm.run([np.arange(16, dtype=np.int32)], 2)  # cuBLAS handles, smem attrs
    torch.cuda.synchronize()
    log(f"built {cfg.name} ({n_params / 1e9:.3f} B params, "
        f"{cfg.n_layers} layers, {tag}) and warmed up in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    lens = list(prompt_lens)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    eng = ServingEngine(model, engine_config(quant, **knobs), device=device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    run = drain(eng, prompts, n_new, t_start)
    steps, ttft = run["steps"], run["ttft"]
    t_end, t_prefilled, gen_at = run["t_end"], run["t_prefilled"], \
        run["gen_at"]
    launches = launch_counts()
    forms = paged_form_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    toks = run["tokens"]
    gen_total = toks.size
    rec = dict(model=cfg.name, n_layers=cfg.n_layers,
               d_model=cfg.d_model, vocab=cfg.vocab_size, dtype=cfg.dtype,
               quant=None if quant is None else dict(weights=quant.weights,
                                                     kv=quant.kv),
               requests=len(prompts), prompt_lens=lens, new_tokens=n_new,
               steps=steps, wall_s=t_end - t_start,
               tok_per_s=gen_total / (t_end - t_start),
               decode_tok_per_s=(gen_total - gen_at) / (t_end - t_prefilled),
               ttft_s=[ttft[i] for i in range(len(prompts))],
               peak_mem_gb=peak_gb, launches=launches,
               paged_forms=forms, **resident_bytes(eng))
    log(json.dumps(rec))
    if toks.shape != (len(prompts), n_new) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"served tokens malformed: shape {toks.shape}")
    # the run went through this configuration's kernels and no others
    want = serve_kernels(cfg, quant)
    never = [k for k in ALL_KERNELS if k not in want]
    if slab_bytes is not None and rec["ffn_slab_bytes"] != slab_bytes:
        fail(f"{cfg.name} {tag}: resident slab bytes "
             f"{rec['ffn_slab_bytes']}, expected {slab_bytes}")
    for name in want:
        if launches[name] <= 0:
            fail(f"the {tag} served run never launched {name}")
    for name in never:
        if launches[name] != 0:
            fail(f"the {tag} served run launched {name} {launches[name]} "
                 f"times")
    form = paged_form_of(cfg, quant)
    if forms != {k: launches[want[1]] if k == form else 0 for k in forms}:
        fail(f"the {tag} served run's paged decode ran {forms}, the rule "
             f"gives {form} for all {launches[want[1]]}")

    # the decode step after the prefill drain, run from one cache state with
    # the kernels and with their plain versions
    chk = ServingEngine(model, engine_config(quant, **knobs), device=device)
    for i, p in enumerate(prompts):
        chk.add_request(p, n_new, req_id=i)
    while chk.sched.waiting or any(s is not None and s.prefilling
                                   for s in chk.sched.active):
        chk.step()
    plan = chk.sched.schedule()
    if not plan.decode_slots or plan.prefills:
        fail("expected a pure decode step after the prefill drain")
    slots = chk.config.max_slots
    tokens = np.zeros((slots, 1), np.int32)
    n_new_a = np.zeros((slots,), np.int32)
    for s in plan.decode_slots:
        tokens[s, 0] = chk.sched.active[s].pending_token
        n_new_a[s] = 1
    base = [{k: v.clone() for k, v in c.items()} for c in chk.cache]

    def run_step():
        chk.cache = [{k: v.clone() for k, v in c.items()} for c in base]
        return chk._run(tokens, chk.sched.state.seq_lens, n_new_a)

    reset_launch_counts()
    logits_k, plans = launched_plans(run_step)
    per_step = {k: v for k, v in launch_counts().items() if v}
    forms_per_step = paged_form_counts()
    with plain_versions():
        logits_p = run_step()
    torch.cuda.synchronize()
    rows = list(plan.decode_slots)
    seq_lens = [int(chk.sched.state.seq_lens[r]) for r in rows]
    lk, lp = logits_k[rows, 0].float(), logits_p[rows, 0].float()
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    # how far below the plain top logit the kernels' pick lies (0 where the
    # two agree): a flip within max_abs_err is a near-tie
    gap = float((lp.max(-1).values
                 - lp.gather(-1, lk.argmax(-1, keepdim=True))[:, 0]).max())
    chk_rec = dict(check=f"{cfg.name} {tag} decode logits after the "
                         f"prefill drain, kernels vs plain versions",
                   rows=len(rows), seq_lens=seq_lens, window=cfg.attn_window,
                   max_abs_err=err, max_abs_logit=scale,
                   tol=LOGIT_TOL * scale, argmax_agreement=agree,
                   argmax_gap=gap,
                   finite=bool(torch.isfinite(lk).all()),
                   launches_per_decode_step=per_step,
                   paged_forms_per_decode_step=forms_per_step)
    if quant is not None:
        chk_rec["int8_junction_bodies"] = check_int8_decode_body(plans, tag)
    log(json.dumps(chk_rec))
    if not chk_rec["finite"] or err > LOGIT_TOL * scale:
        fail(f"decode logits disagree: {chk_rec}")
    if cfg.attn_window is not None and max(lens) > cfg.attn_window \
            and max(seq_lens) <= cfg.attn_window:
        fail(f"the checked decode step has no row past the window: "
             f"{chk_rec}")
    expect = {want[0]: 3 * cfg.n_layers, want[1]: cfg.n_layers}
    if per_step != expect:
        fail(f"{tag} decode step launched {per_step}, expected {expect}")
    if forms_per_step[form] != cfg.n_layers:
        fail(f"{tag} decode step's paged decode ran {forms_per_step}, "
             f"expected {cfg.n_layers} of {form}")
    return rec, chk_rec, profile_decode(
        model, prompts, n_new, device, out_dir, quant, trace=trace,
        knobs=knobs), toks, prompts


def drain(eng, prompts, n_new, t_start) -> dict:
    """Serve ``prompts`` (``n_new`` tokens each) on ``eng`` until it drains,
    the clock started at ``t_start``: the steps, each request's time to
    first token, when every request had its first token (``t_prefilled``)
    and how many tokens there were then (``gen_at``), the end after a
    device sync, the tokens (requests, n_new), and the paged steps by kind:
    prefill calls (one per chunk length a step), plain decode steps and
    speculative verify steps."""
    import numpy as np
    import torch
    for i, p in enumerate(prompts):
        eng.add_request(p, n_new, req_id=i)
    ttft, steps, t_prefilled, gen_at = {}, 0, None, 0
    kinds = dict(prefill_calls=0, decode_steps=0, verify_steps=0)
    while eng.sched.has_work():
        plan, _ = eng.step()  # ends in a host copy of the sampled tokens
        steps += 1
        kinds["prefill_calls"] += len(plan.prefill_groups)
        if plan.drafts:
            kinds["verify_steps"] += 1
        elif plan.decode_slots:
            kinds["decode_steps"] += 1
        now = time.perf_counter()
        for s in eng.sched.active:
            if s is not None and s.n_generated >= 1:
                ttft.setdefault(s.req.req_id, now - t_start)
        for rid in eng.outputs:
            ttft.setdefault(rid, now - t_start)
        if t_prefilled is None and len(ttft) == len(prompts):
            t_prefilled = now
            gen_at = sum(len(o) for o in eng.outputs.values()) + sum(
                s.n_generated for s in eng.sched.active if s is not None)
    torch.cuda.synchronize()
    return dict(steps=steps, ttft=ttft, t_prefilled=t_prefilled,
                gen_at=gen_at, t_end=time.perf_counter(),
                tokens=np.stack([eng.outputs.pop(i)
                                 for i in range(len(prompts))]), **kinds)


def launched_plans(fn) -> tuple:
    """(fn(), the plans of every launch it made, in order)."""
    from repro_torch.kernels import launch
    real, plans = launch.run, []

    def run(plan, buffers, call):
        plans.append(plan)
        return real(plan, buffers, call)

    launch.run = run
    try:
        out = fn()
    finally:
        launch.run = real
    return out, plans


INT8_DECODE_BODY = "csd_spmm_fwd_quant_stream_kernel"


def check_int8_decode_body(plans, tag) -> dict:
    """Fail unless every int8 junction call of a bf16 decode step (the
    plans of ``csd_spmm_fwd_quant``) is one launch of the decode body with
    no f32 partial buffer; the distinct (cluster, rows, columns) the calls
    ran, with their counts."""
    seen = {}
    for p in plans:
        if p.name != "csd_spmm_fwd_quant":
            continue
        kernels = [ln.kernel for ln in p.launches]
        if kernels != [INT8_DECODE_BODY] or "partial" in p.buffers:
            fail(f"{tag}: an int8 decode junction call ran {kernels} "
                 f"({p.args}), not one launch of {INT8_DECODE_BODY}")
        key = f"cluster {p.args['cluster']}, {p.args['tile_m']} x " \
              f"{p.args['tile_n']}, grid {list(p.launches[0].grid)}"
        seen[key] = seen.get(key, 0) + 1
    if not seen:
        fail(f"{tag}: the decode step launched no int8 junction")
    return seen


def top1_agreement(ref_model, model, prompts, gen, device, quant,
                   page_size=16):
    """Teacher-forced top-1 agreement of ``model`` (served with ``quant``)
    against ``ref_model`` (full width), counted as the JAX package's
    ``benchmarks/serving_bench.py::int8_top1_agreement`` counts it: both are
    fed the reference's tokens (``prompts`` then ``gen``), and at every
    generated position the argmaxes are compared; a flip where the
    reference's top-2 logit gap is below ``NEAR_TIE_MARGIN`` counts as a
    near tie. The rows run batched, one paged step per position."""
    import numpy as np
    import torch
    from repro_torch.nn.common import dtype_of

    b = len(prompts)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    n_gen = gen.shape[1]
    per_row = -(-(int(lens.max()) + n_gen) // page_size)
    table = torch.arange(b * per_row, dtype=torch.int32,
                         device=device).reshape(b, per_row)
    dt = dtype_of(ref_model.cfg)
    caches = [ref_model.init_paged_cache(b * per_row, page_size, dt, device),
              model.init_paged_cache(b * per_row, page_size, dt, device,
                                     quant_kv=quant.kv)]
    prompt = np.zeros((b, int(lens.max())), np.int32)
    for i, p in enumerate(prompts):
        prompt[i, :len(p)] = p

    def step(m, cache, toks, pos, n):
        return m.paged_step(
            torch.as_tensor(toks, device=device),
            torch.as_tensor(pos, dtype=torch.int32, device=device),
            torch.as_tensor(n, dtype=torch.int32, device=device), cache,
            table)[:, 0].float()

    l_ref = step(ref_model, caches[0], prompt, np.zeros(b), lens)
    l_q = step(model, caches[1], prompt, np.zeros(b), lens)
    n_same = n_tie = 0
    for j in range(n_gen):
        a_ref, a_q = l_ref.argmax(-1), l_q.argmax(-1)
        top2 = l_ref.topk(2, dim=-1).values
        same = a_ref == a_q
        n_same += int(same.sum())
        n_tie += int((~same & (top2[:, 0] - top2[:, 1]
                               < NEAR_TIE_MARGIN)).sum())
        toks = gen[:, j:j + 1]
        pos = lens + j
        l_ref = step(ref_model, caches[0], toks, pos, np.ones(b))
        l_q = step(model, caches[1], toks, pos, np.ones(b))
    n_tok = b * n_gen
    return dict(check=f"{model.cfg.name}: teacher-forced top-1 agreement, "
                      f"int8 vs bf16 engine logits (recorded, not gated)",
                raw=n_same / n_tok, gated=(n_same + n_tie) / n_tok,
                n_near_tie=n_tie, n_tok=n_tok,
                near_tie_margin=NEAR_TIE_MARGIN)


# ---------------------------------------------------------------------------
# phase 5s: speculative decode at full width
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_MOTIF, SPEC_NEW = 8, 32  # motif tokens of a periodic prompt; new tokens
# the check step's drafts per request: the spec-off continuation whole, with
# its second draft wrong, its first two, none
SPEC_CHECK_DRAFTS = ("whole", "second_wrong", "two", "none")


def periodic_prompts(vocab: int, lens, motif: int = SPEC_MOTIF) -> list:
    """One request per length: a motif of ``motif`` tokens from the seed
    tiled to that length, as ``tests/test_serving.py::_periodic_prompt``
    builds them (the prompt-lookup drafter matches such runs)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [np.tile(rng.integers(0, vocab, motif).astype(np.int32),
                    -(-n // motif))[:n] for n in lens]


def check_drafter(prompts, cont, vocab: int):
    """A drafter for the checked verify step: request i's drafts are the
    tokens ``cont[i]`` (the spec-off run's) that follow its history, shaped
    by ``SPEC_CHECK_DRAFTS[i]``."""
    def drafter(tokens, k):
        i = next(j for j, p in enumerate(prompts)
                 if list(tokens[:SPEC_MOTIF]) == p[:SPEC_MOTIF].tolist())
        n_gen = len(tokens) - len(prompts[i])
        d = [int(t) for t in cont[i][n_gen:n_gen + k]]
        kind = SPEC_CHECK_DRAFTS[i % len(SPEC_CHECK_DRAFTS)]
        if kind == "second_wrong" and len(d) > 1:
            d[1] = (d[1] + 1) % vocab
        return {"whole": d, "second_wrong": d, "two": d[:2]}.get(kind, [])
    return drafter


def verify_bodies(plans, model, slots: int, c: int, quant) -> dict:
    """Fail unless every junction call of a verify step (the plans of
    ``csd_spmm_fwd`` / ``csd_spmm_fwd_quant``) ran over the chunk's rows,
    ``slots`` x ``c`` tokens (an MoE expert: the capacity of that many), on
    the body ``launch.fwd_body`` gives for them; the (kernel, rows, tile
    columns) the calls ran, with their counts."""
    import torch
    from repro_torch.kernels import launch
    from repro_torch.nn.ffn import MoE
    n_sm = launch.sm_count(torch.device("cuda", 0))
    rows = slots * c
    moe = next((m for m in model.modules() if isinstance(m, MoE)), None)
    want_m = rows if moe is None else moe.capacity(rows)
    kernels = {launch.BODY_WGMMA: "csd_spmm_fwd_wgmma_kernel",
               launch.BODY_STREAM: "csd_spmm_fwd_quant_stream_kernel"}
    seen = {}
    for p in plans:
        if p.name not in ("csd_spmm_fwd", "csd_spmm_fwd_quant"):
            continue
        e, n_rb, d_in_b, _, br = p.buffers["w"].shape
        m = p.buffers["x"].shape[0] // e
        body = launch.fwd_body(model.cfg.dtype, e, m, n_rb, d_in_b, br,
                               n_sm, quant is not None)
        got = p.launches[0].kernel
        want = kernels.get(body[0])
        if m != want_m or (
                got != want if want else got in kernels.values()):
            fail(f"a verify junction call ran {got} over {m} rows; the "
                 f"rule gives body {body} for {rows} tokens")
        key = f"{got}, {m} rows, tile_n {body[2]}"
        seen[key] = seen.get(key, 0) + 1
    return seen


def profile_call(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: its kernels' device ms (summed
    over the CUDA kernels), wall ms, kernel launches and the top five."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total = sum(dev_us(e) for e in kernels)
    return dict(kernel_ms=total / 1e3 if total else "not measured",
                wall_ms=wall * 1e3,
                kernel_launches=sum(e.count for e in kernels),
                top=[dict(name=e.key[:70], us=dev_us(e), calls=e.count)
                     for e in sorted(kernels, key=dev_us, reverse=True)[:5]])


def logits_at(model, prompt, gen, pos, device, quant) -> "torch.Tensor":
    """The f32 logits from which a plain greedy run chose ``gen[pos]``:
    ``prompt`` as one prefill chunk, then ``gen[:pos]`` one token a decode
    step (the kernels; over int8 pages where ``quant.kv``)."""
    import torch
    from repro_torch.nn.common import dtype_of
    n = len(prompt)
    per_row = -(-(n + pos + 1) // 16)
    table = torch.arange(per_row, dtype=torch.int32, device=device)[None]
    cache = model.init_paged_cache(per_row, 16, dtype_of(model.cfg), device,
                                   quant_kv=quant is not None and quant.kv)

    def step(toks, at, k):
        return model.paged_step(
            torch.as_tensor(toks, device=device)[None],
            torch.tensor([at], dtype=torch.int32, device=device),
            torch.tensor([k], dtype=torch.int32, device=device), cache,
            table)[0, 0].float()

    out = step(prompt, 0, n)
    for j in range(pos):
        out = step(gen[j:j + 1], n + j, 1)
    return out


def spec_serve(model, device, quant=None) -> dict:
    """Phase 5s on ``model`` (served with ``quant``): periodic prompts
    (``periodic_prompts`` at ``DENSE_PROMPTS``' lengths, ``SPEC_NEW`` new
    tokens) served with ``spec_k`` = ``SPEC_K`` and without it, on, off,
    on, off, each run's launches exact for its paged steps (3 junction calls
    a layer a step, one paged decode a layer a plain decode step, none in a
    verify step) and its decode tok/s recorded; every spec-on run must
    draft; the tokens equal the spec-off run's, or first differ where the
    spec-off logits' top-2 gap lies below ``NEAR_TIE_MARGIN`` of max
    |logit|. Then one verify step (drafts from ``check_drafter``) from one
    cache state with the kernels and with the plain versions: the logits
    at every valid chunk position within ``LOGIT_TOL`` of max |logit|,
    exactly 3 junction launches a layer on the rule's body for the chunk's
    rows and nothing else, and its kernel time under the profiler."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import ServingEngine

    cfg = model.cfg
    tag = "int8" if quant is not None else cfg.dtype
    n_layers = cfg.n_layers
    fwd, paged = serve_kernels(cfg, quant)
    prompts = periodic_prompts(cfg.vocab_size, DENSE_PROMPTS)
    warm = ServingEngine(model, engine_config(quant, spec_k=SPEC_K),
                         device=device)
    warm.run(periodic_prompts(cfg.vocab_size, (16,)), 8)  # verify shapes
    runs = []
    for spec_k in (SPEC_K, 0, SPEC_K, 0):
        eng = ServingEngine(model, engine_config(quant, spec_k=spec_k),
                            device=device)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = drain(eng, prompts, SPEC_NEW, t0)
        launches = {k: v for k, v in launch_counts().items() if v}
        calls = r["prefill_calls"] + r["decode_steps"] + r["verify_steps"]
        want = {fwd: 3 * n_layers * calls}
        if r["decode_steps"]:
            want[paged] = n_layers * r["decode_steps"]
        toks = r["tokens"]
        stats = dict(eng.sched.stats)
        rec = dict(spec_k=spec_k, steps=r["steps"],
                   prefill_calls=r["prefill_calls"],
                   decode_steps=r["decode_steps"],
                   verify_steps=r["verify_steps"],
                   spec_drafted=stats["spec_drafted"],
                   spec_accepted=stats["spec_accepted"],
                   acceptance=stats["spec_accepted"] / stats["spec_drafted"]
                   if stats["spec_drafted"] else None,
                   wall_s=r["t_end"] - t0,
                   decode_tok_per_s=(toks.size - r["gen_at"])
                   / (r["t_end"] - r["t_prefilled"]),
                   launches=launches)
        log(json.dumps(dict(check=f"{cfg.name} {tag} spec_k {spec_k}",
                            **rec)))
        if toks.shape != (len(prompts), SPEC_NEW) or launches != want:
            fail(f"{cfg.name} {tag} spec_k {spec_k}: tokens {toks.shape}, "
                 f"launches {launches}, expected {want}")
        if spec_k and not stats["spec_drafted"]:
            fail(f"{cfg.name} {tag}: the spec-on run drafted nothing")
        runs.append((rec, toks))
    off = runs[1][1]
    diverged = []
    for on in (runs[0][1], runs[2][1]):
        for i in range(len(prompts)):
            diff = np.flatnonzero(on[i] != off[i])
            if not diff.size:
                continue
            pos = int(diff[0])
            lg = logits_at(model, prompts[i], off[i], pos, device, quant)
            top2 = lg.topk(2).values
            d = dict(request=i, position=pos, spec_token=int(on[i, pos]),
                     off_token=int(off[i, pos]),
                     top2_gap=float(top2[0] - top2[1]),
                     max_abs_logit=float(lg.abs().max()),
                     off_token_is_argmax=int(lg.argmax()) == int(off[i, pos]))
            diverged.append(d)
            if not d["top2_gap"] < NEAR_TIE_MARGIN * d["max_abs_logit"]:
                fail(f"{cfg.name} {tag}: spec-on tokens diverge from "
                     f"spec-off above a near tie: {d}")

    # one verify step, kernels against plain versions from one cache state
    chk = ServingEngine(model, engine_config(quant, spec_k=SPEC_K),
                        device=device)
    chk.sched.drafter = check_drafter(prompts, off, cfg.vocab_size)
    for i, p in enumerate(prompts):
        chk.add_request(p, SPEC_NEW, req_id=i)
    while chk.sched.waiting or any(s is not None and s.prefilling
                                   for s in chk.sched.active):
        chk.step()
    plan = chk.sched.schedule()
    if not plan.drafts or plan.prefills:
        fail(f"{cfg.name} {tag}: expected a verify step after the prefill "
             f"drain, got {plan}")
    slots, c = chk.config.max_slots, 1 + SPEC_K
    tokens = np.zeros((slots, c), np.int32)
    n_new = np.zeros((slots,), np.int32)
    for s in plan.decode_slots:
        row = [chk.sched.active[s].pending_token] + plan.drafts.get(s, [])
        tokens[s, :len(row)] = row
        n_new[s] = len(row)
    base = [{k: v.clone() for k, v in cc.items()} for cc in chk.cache]

    def run_step(cache=None):
        chk.cache = cache or [{k: v.clone() for k, v in cc.items()}
                              for cc in base]
        return chk._run(tokens, chk.sched.state.seq_lens, n_new,
                        all_logits=True)

    reset_launch_counts()
    logits_k, plans = launched_plans(run_step)
    per_step = {k: v for k, v in launch_counts().items() if v}
    with plain_versions():
        logits_p = run_step()
    valid = torch.as_tensor(np.arange(c)[None] < n_new[:, None],
                            device=device)
    lk, lp = logits_k.float()[valid], logits_p.float()[valid]
    err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
    bodies = verify_bodies(plans, model, slots, c, quant)
    cache = [{k: v.clone() for k, v in cc.items()} for cc in base]
    prof = profile_call(lambda: run_step(cache))
    chk_rec = dict(check=f"{cfg.name} {tag} verify step (chunk {c}, n_new "
                         f"{n_new.tolist()}), kernels vs plain versions",
                   valid_positions=int(valid.sum()), max_abs_err=err,
                   max_abs_logit=scale, tol=LOGIT_TOL * scale,
                   argmax_agreement=float(
                       (lk.argmax(-1) == lp.argmax(-1)).float().mean()),
                   finite=bool(torch.isfinite(lk).all()),
                   launches_per_verify_step=per_step, bodies=bodies,
                   profile=prof)
    log(json.dumps(chk_rec))
    if not chk_rec["finite"] or err > LOGIT_TOL * scale:
        fail(f"verify logits disagree: {chk_rec}")
    if per_step != {fwd: 3 * n_layers}:
        fail(f"{tag} verify step launched {per_step}, expected "
             f"{ {fwd: 3 * n_layers} }")
    on_recs = [runs[0][0], runs[2][0]]
    return dict(model=cfg.name, tag=tag, spec_k=SPEC_K,
                prompt_lens=list(DENSE_PROMPTS), motif=SPEC_MOTIF,
                new_tokens=SPEC_NEW, runs=[r for r, _ in runs],
                acceptance=[r["acceptance"] for r in on_recs],
                steps_on=[r["steps"] for r in on_recs],
                steps_off=[runs[1][0]["steps"], runs[3][0]["steps"]],
                decode_tok_per_s_on=[r["decode_tok_per_s"] for r in on_recs],
                decode_tok_per_s_off=[runs[1][0]["decode_tok_per_s"],
                                      runs[3][0]["decode_tok_per_s"]],
                tokens_equal=[bool((runs[j][1] == off).all())
                              for j in (0, 2)],
                off_runs_equal=bool((runs[3][1] == off).all()),
                diverged=diverged, verify_check=chk_rec)


def dev_us(e) -> float:
    """A profiler event's own device µs (the key's name moved between torch
    releases)."""
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0)


def export_trace(prof, path: Path) -> None:
    """The profiler's chrome trace, gzipped (``<path>.gz``)."""
    import gzip
    import shutil
    prof.export_chrome_trace(str(path))
    with open(path, "rb") as src, gzip.open(f"{path}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    path.unlink()


def profile_decode(model, prompts, n_new, device, out_dir, quant=None,
                   n_steps=4, trace="decode_trace", knobs=None):
    """Where a decode step's time goes: ``n_steps`` engine decode steps
    under ``torch.profiler``, kernel time summed by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, engine_config(quant, **(knobs or {})),
                        device=device)
    for i, p in enumerate(prompts):
        eng.add_request(p, n_new, req_id=i)
    while eng.sched.waiting or any(s is not None and s.prefilling
                                   for s in eng.sched.active):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    export_trace(prof, out_dir / (trace + ("" if quant is None
                                           else "_int8") + ".json"))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total_us = sum(dev_us(e) for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    rec = dict(check=f"{model.cfg.name} decode step profile"
               + ("" if quant is None else " (int8)"),
               steps=n_steps,
               wall_ms_per_step=wall * 1e3 / n_steps,
               kernel_ms_per_step=total_us / 1e3 / n_steps
               if total_us else "not measured",
               device_idle_share=1 - total_us / 1e6 / wall
               if total_us else "not measured",
               kernel_launches_per_step=sum(e.count for e in kernels)
               / n_steps,
               paged_per_layer=paged_per_layer(
                   kernels, dev_us, n_steps * model.cfg.n_layers),
               junction_per_step=junction_per_step(kernels, dev_us,
                                                   n_steps),
               top=[dict(name=e.key[:70], us_per_step=dev_us(e) / n_steps,
                         calls_per_step=e.count / n_steps) for e in top])
    log(json.dumps(rec))
    if quant is not None and any("reduce_splits" in k
                                 for k in rec["junction_per_step"]):
        fail(f"an int8 decode step ran reduce_splits_kernel: "
             f"{rec['junction_per_step']}")
    return rec


def junction_per_step(kernels, dev_us, n_steps: int) -> dict:
    """The junction forward's CUDA launches and device µs per step, by
    kernel (its bodies, the split forward's second pass), over
    ``n_steps`` steps; ``total_us`` their sum."""
    out, total = {}, 0.0
    for e in kernels:
        if "csd_spmm_fwd" in e.key or "reduce_splits" in e.key:
            name = e.key.split("(", 1)[0] if "<" not in e.key else \
                e.key[:e.key.find(">") + 1]
            name = name.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            out[name] = dict(launches=e.count / n_steps,
                             us=dev_us(e) / n_steps)
            total += dev_us(e) / n_steps
    out["total_us"] = total
    return out


def paged_per_layer(kernels, dev_us, n: int) -> dict:
    """The paged decode's CUDA launches and device µs per layer, by
    kernel (the split kernel's forms, the merge), over ``n`` layer-steps."""
    out = {}
    for e in kernels:
        if "paged_decode" in e.key:
            name = e.key.split("(", 1)[0] if "<" not in e.key else \
                e.key[:e.key.find(">") + 1]
            name = name.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            out[name] = dict(launches=e.count / n, us=dev_us(e) / n)
    return out


# ---------------------------------------------------------------------------
# phase 6: the training kernels at gemma3-4b's training shapes
# ---------------------------------------------------------------------------

TRAIN_M = 2 * 2048   # batch x sequence of phase 7
# max |kernel - plain| over max |plain|: f32 sums in another order; bf16
# one rounding of each output on top
TRAIN_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 1e-2}


def dense_of(bp, w):
    """The (n_in, n_out) dense weight of a slab (zeros off the pattern):
    what the library yardstick multiplies."""
    import torch
    d = torch.zeros((bp.n_lb, bp.block_in, bp.n_rb, bp.block_out),
                    dtype=w.dtype, device=w.device)
    for rb in range(bp.n_rb):
        for f in range(bp.d_in_b):
            d[int(bp.block_idx[rb, f]), :, rb] = w[rb, f]
    return d.reshape(bp.n_in, bp.n_out)


def hold_and_time(kernel, run, plain, lib, nbytes, ops, dtype,
                  exact=False) -> dict:
    """A kernel against its plain version on the same inputs (max |error|
    within ``TRAIN_TOL`` of max |plain|, or equal element for element with
    ``exact``), then the kernel's, the plain version's and the library
    call's times and the bound for ``nbytes`` and ``ops``. ``run``,
    ``plain`` and ``lib`` are each a call or a list of calls, one per copy
    of the inputs: held on the first copy; the kernel and the library
    timed cycling through every copy, the plain version on the first two."""
    import torch
    runs, plains, libs = ([c] if callable(c) else c
                          for c in (run, plain, lib))
    got, ref = runs[0](), plains[0]()
    torch.cuda.synchronize()
    if isinstance(got, tuple):  # (y, z) or (dw, db)
        got, ref = (torch.cat([t.float().reshape(-1) for t in o])
                    for o in (got, ref))
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = 0.0 if exact else TRAIN_TOL[str(dtype)]
    ok = (bool(torch.equal(got, ref)) if exact else err <= tol * scale) \
        and bool(torch.isfinite(got).all())
    del got, ref
    iters = max(10, len(runs))
    ms, host_ms = bench(runs, iters)
    plain_ms, _ = bench(plains[:2], 2)
    lib_ms, _ = bench(libs, iters)
    bound_ms, bound_by = bound(nbytes, ops, dtype)
    return dict(kernel=kernel, max_abs_err=err, max_abs_ref=scale, tol=tol,
                exact=exact, ok=ok, ms=ms, host_ms=host_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms)


def gelu_library(dy, z):
    """The one PyTorch call that computes the gelu-masked cotangent:
    autograd's own gelu backward (the yardstick of ``csd_mask_cotangent``,
    which the smoke runs with gelu only)."""
    import torch
    return torch.ops.aten.gelu_backward(dy, z, approximate="tanh")


def run_train_kernels(cfg, device, results):
    """Phase 6. For the gelu gate junction the backward's pieces are also
    held and timed one by one, as ``CsdMatmul`` launches them: the mask
    kernel, then dx and dw on its output g (``on_g``); the dx and dw rows
    with the activation are the wrappers' whole function, mask and
    product."""
    import torch
    from repro_torch.kernels import csd_spmm
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    up, down = junction_patterns(cfg)
    m = TRAIN_M
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, bp, act in (("gate", up, "gelu"), ("down", down, None)):
            shape = (bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
            n_w = math.prod(shape)
            x = torch.randn((m, bp.n_in), generator=g, device=device) \
                .to(dtype)
            w = (torch.randn(shape, generator=g, device=device)
                 / math.sqrt(bp.d_in_b * bp.block_in)).to(dtype)
            dy = torch.randn((m, bp.n_out), generator=g, device=device) \
                .to(dtype)
            aux = torch.randn((m, bp.n_out), generator=g, device=device) \
                .to(dtype) if act else None
            pat = {k: torch.as_tensor(getattr(bp, k), dtype=torch.int32,
                                      device=device)
                   for k in ("block_idx", "out_idx", "out_slot")}
            wd = dense_of(bp, w)
            el = dtype.itemsize
            n_x, n_y = m * bp.n_in, m * bp.n_out
            n_aux = n_y if act else 0
            idx_bytes = 4 * pat["block_idx"].numel()
            ops = 2 * m * n_w
            kbw = dict(block_in=bp.block_in, block_out=bp.block_out)
            # the training forward saves z where the backward needs it
            kfw = dict(activation=act, save_preact=act == "gelu")
            cases = [
                ("csd_spmm_fwd", False,
                 lambda: csd_spmm.csd_spmm_fwd_cuda(
                     x, w, pat["block_idx"], **kfw),
                 lambda: csd_spmm.csd_spmm_fwd_plain(
                     x, w, pat["block_idx"], **kfw),
                 lambda: torch.matmul(x, wd),
                 el * (n_x + n_w + (1 + kfw["save_preact"]) * n_y)),
                ("csd_spmm_dx", False,
                 lambda: csd_spmm.csd_spmm_dx_cuda(
                     dy, w, pat["out_idx"], pat["out_slot"], aux=aux,
                     activation=act),
                 lambda: csd_spmm.csd_spmm_dx_plain(
                     dy, w, pat["out_idx"], pat["out_slot"], aux=aux,
                     activation=act),
                 lambda: torch.matmul(dy, wd.T),
                 el * (n_y + n_aux + n_w + n_x)),
                ("csd_spmm_dw", False,
                 lambda: csd_spmm.csd_spmm_dw_cuda(
                     x, dy, pat["block_idx"], aux=aux, activation=act,
                     **kbw),
                 lambda: csd_spmm.csd_spmm_dw_plain(
                     x, dy, pat["block_idx"], aux=aux, activation=act,
                     **kbw),
                 lambda: torch.matmul(x.T, dy),
                 el * (n_x + n_y + n_aux + n_w))]
            gm = csd_spmm.mask_cotangent(dy, aux, act) if act else None
            if act:
                cases += [
                    ("csd_spmm_dx", True,
                     lambda: csd_spmm.csd_spmm_dx_cuda(
                         gm, w, pat["out_idx"], pat["out_slot"]),
                     lambda: csd_spmm.csd_spmm_dx_plain(
                         gm, w, pat["out_idx"], pat["out_slot"]),
                     lambda: torch.matmul(gm, wd.T),
                     el * (n_y + n_w + n_x)),
                    ("csd_spmm_dw", True,
                     lambda: csd_spmm.csd_spmm_dw_cuda(
                         x, gm, pat["block_idx"], **kbw),
                     lambda: csd_spmm.csd_spmm_dw_plain(
                         x, gm, pat["block_idx"], **kbw),
                     lambda: torch.matmul(x.T, gm),
                     el * (n_x + n_y + n_w))]
            for kernel, on_g, run, plain, lib, nbytes in cases:
                rec = hold_and_time(kernel, run, plain, lib,
                                    nbytes + idx_bytes, ops, dtype)
                body = fwd_body(csd_spmm.csd_spmm_fwd_cuda, x, w,
                                pat["block_idx"], **kfw) \
                    if kernel == "csd_spmm_fwd" else {}
                rec = dict(rec, junction=name, m=m, dtype=dtype_name,
                           activation=None if on_g else act, on_g=on_g,
                           save_preact=kernel == "csd_spmm_fwd"
                           and kfw["save_preact"], **body)
                results.append(rec)
                log(json.dumps(rec))
                if not rec["ok"]:
                    fail(f"{kernel} disagrees with its plain version: {rec}")
                check_training_body(rec)
            if act:
                rec = hold_and_time(
                    "csd_mask_cotangent",
                    lambda: csd_spmm.csd_mask_cotangent_cuda(dy, aux, act),
                    lambda: csd_spmm.mask_cotangent(dy, aux, act),
                    lambda: gelu_library(dy, aux), 3 * el * n_y, 0,
                    dtype, exact=True)
                rec = dict(rec, junction=name, m=m, dtype=dtype_name,
                           activation=act,
                           library="torch.ops.aten.gelu_backward")
                results.append(rec)
                log(json.dumps(rec))
                if not rec["ok"]:
                    fail(f"csd_mask_cotangent differs from its plain "
                         f"version: {rec}")
            del x, w, dy, aux, wd, gm
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6b: the expert-batched training kernels at granite-moe's shapes
# ---------------------------------------------------------------------------


def expert_capacity(cfg, tokens: int) -> int:
    """Rows per expert of an MoE step over ``tokens`` tokens (``MoE.capacity``
    of the port and of the JAX package)."""
    mc = cfg.moe
    return max(math.ceil(tokens * mc.top_k / mc.n_routed
                         * mc.capacity_factor), 1)


def run_train_kernels_batched(cfg, device, results):
    import torch
    from repro_torch.kernels import csd_spmm
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    n_exp = cfg.moe.n_routed
    m = expert_capacity(cfg, TRAIN_M)
    up, down = expert_patterns(cfg)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, bp, act in (("up/gate", up, None), ("up/gate", up, "gelu"),
                              ("down", down, None)):
            shape = (n_exp, bp.n_rb, bp.d_in_b, bp.block_in, bp.block_out)
            n_w = math.prod(shape)

            def randn(*size):
                return torch.randn(size, generator=g, device=device)
            x = randn(n_exp, m, bp.n_in).to(dtype)
            w = (randn(*shape) / math.sqrt(bp.d_in_b * bp.block_in)).to(dtype)
            dy = randn(n_exp, m, bp.n_out).to(dtype)
            aux = randn(n_exp, m, bp.n_out).to(dtype) if act else None
            pat = {k: torch.as_tensor(getattr(bp, k), dtype=torch.int32,
                                      device=device)
                   for k in ("block_idx", "out_idx", "out_slot")}
            wd = dense_of_experts(bp, w)
            el = dtype.itemsize
            n_x, n_y = n_exp * m * bp.n_in, n_exp * m * bp.n_out
            n_aux = n_y if act else 0
            sp = act == "gelu"  # the training forward saves z for gelu
            kfw = dict(activation=act, save_preact=sp)
            kdx = dict(aux=aux, activation=act)
            cases = [
                ("csd_spmm_fwd_batched", False,
                 lambda: csd_spmm.csd_spmm_fwd_batched_cuda(
                     x, w, pat["block_idx"], **kfw),
                 lambda: csd_spmm.csd_spmm_fwd_batched_plain(
                     x, w, pat["block_idx"], **kfw),
                 lambda: torch.bmm(x, wd),
                 el * (n_x + n_w + (1 + sp) * n_y)),
                ("csd_spmm_dx_batched", False,
                 lambda: csd_spmm.csd_spmm_dx_batched_cuda(
                     dy, w, pat["out_idx"], pat["out_slot"], **kdx),
                 lambda: csd_spmm.csd_spmm_dx_batched_plain(
                     dy, w, pat["out_idx"], pat["out_slot"], **kdx),
                 lambda: torch.bmm(dy, wd.transpose(1, 2)),
                 el * (n_y + n_aux + n_w + n_x))]
            for want_db in (False, True):
                kdw = dict(block_in=bp.block_in, block_out=bp.block_out,
                           aux=aux, activation=act, want_db=want_db)
                cases.append((
                    "csd_spmm_dw_batched", want_db,
                    lambda kdw=kdw: csd_spmm.csd_spmm_dw_batched_cuda(
                        x, dy, pat["block_idx"], **kdw),
                    lambda kdw=kdw: csd_spmm.csd_spmm_dw_batched_plain(
                        x, dy, pat["block_idx"], **kdw),
                    lambda: torch.bmm(x.transpose(1, 2), dy),
                    el * (n_x + n_y + n_aux + n_w)
                    + 4 * n_exp * bp.n_out * want_db))
            for kernel, want_db, run, plain, lib, nbytes in cases:
                rec = hold_and_time(kernel, run, plain, lib,
                                    nbytes + 4 * pat["block_idx"].numel(),
                                    2 * m * n_w, dtype)
                body = fwd_body(csd_spmm.csd_spmm_fwd_batched_cuda, x, w,
                                pat["block_idx"], **kfw) \
                    if kernel == "csd_spmm_fwd_batched" else {}
                rec = dict(rec, junction=name, experts=n_exp, m=m,
                           dtype=dtype_name, activation=act, want_db=want_db,
                           save_preact=kernel == "csd_spmm_fwd_batched"
                           and sp, w_shape=list(shape),
                           library="torch.bmm over the densified slabs",
                           **body)
                results.append(rec)
                log(json.dumps(rec))
                if not rec["ok"]:
                    fail(f"{kernel} disagrees with its plain version: {rec}")
                check_training_body(rec)
            if act:
                rec = hold_and_time(
                    "csd_mask_cotangent",
                    lambda: csd_spmm.csd_mask_cotangent_cuda(dy, aux, act),
                    lambda: csd_spmm.mask_cotangent(dy, aux, act),
                    lambda: gelu_library(dy, aux), 3 * el * n_y, 0,
                    dtype, exact=True)
                rec = dict(rec, junction=name, experts=n_exp, m=m,
                           dtype=dtype_name, activation=act,
                           library="torch.ops.aten.gelu_backward")
                results.append(rec)
                log(json.dumps(rec))
                if not rec["ok"]:
                    fail(f"csd_mask_cotangent differs from its plain "
                         f"version: {rec}")
            del x, w, dy, aux, wd
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6c: the full-sequence attention kernels at the training shapes
# ---------------------------------------------------------------------------

# (forward, backward) limits of the largest relative Frobenius error of a
# block of FLASH_ROWS consecutive rows of one (batch, head) of o, dq, dk and
# dv, and of the largest absolute error of lse: f32 sums in another order;
# bf16 the rounding of P (and of dS) to bf16 for the tensor-core products
# and of each output. Per block, not over the whole tensor: under causal
# attention the first rows' |o| is ~sqrt(Dh) times a late row's, so a limit
# scaled by max |plain| would be as large as a late row's values. Per block,
# not per row: a row with one visible key has dq = 0 up to rounding noise.
FLASH_TOL = {"torch.float32": (2e-5, 1e-4), "torch.bfloat16": (1e-2, 1e-2)}
FLASH_ROWS = 64
# faults the limits must catch, made from the plain math (flash_control)
FLASH_CONTROLS = {"tile_dropped": ("o", "lse", "dq", "dk", "dv"),
                  "p_ds_4bit": ("o", "dq", "dk", "dv"),
                  "p_ds_4bit_late_rows": ("o", "dq", "dk", "dv")}
FLASH_DROPPED_KEYS = slice(1024, 1088)
FLASH_LATE_ROWS = 1024  # the first query row p_ds_4bit_late_rows spoils
# (model, Hq, Hkv, Dh, windows): gemma3-4b (29 of 34 layers windowed) and
# granite-moe-1b-a400m (all global)
FLASH_SHAPES = (("gemma3-4b", 8, 4, 256, (1024, None)),
                ("granite-moe-1b-a400m", 16, 8, 64, (None,)))


def visible_pairs(s: int, window) -> int:
    """Visible (query, key) pairs of causal attention over s tokens, each
    query seeing at most ``window`` keys."""
    return sum(min(i + 1, window or s) for i in range(s))


def block_rel_err(got, ref) -> float:
    """Largest relative Frobenius error of got against ref, (B, S, H, Dh),
    over blocks of FLASH_ROWS consecutive rows of one (batch, head); a block
    whose ref is all zero must be zero."""
    import torch
    import torch.nn.functional as F
    e2 = (got.float() - ref.float()).square().sum(-1)          # (B, S, H)
    r2 = ref.float().square().sum(-1)
    pad = (-e2.shape[1]) % FLASH_ROWS
    e2, r2 = (F.pad(t, (0, 0, 0, pad)).reshape(
        t.shape[0], -1, FLASH_ROWS, t.shape[2]).sum(2) for t in (e2, r2))
    rel = torch.where(r2 > 0, (e2 / r2.clamp_min(1e-30)).sqrt(),
                      torch.where(e2 > 0, math.inf, 0.0))
    return float(rel.max())


def flash_errors(o, lse, grads, o_ref, lse_ref, grads_ref) -> dict:
    """The gated errors of each output: block_rel_err for o, dq, dk, dv,
    the largest absolute error for lse."""
    errs = dict(o=block_rel_err(o, o_ref),
                lse=float((lse - lse_ref).abs().max()))
    errs.update((n, block_rel_err(a, r))
                for n, a, r in zip(("dq", "dk", "dv"), grads, grads_ref))
    return errs


def round_significand(t, bits: int):
    """t with its significand rounded to ``bits`` bits (no range limit)."""
    import torch
    m, e = torch.frexp(t)
    return torch.ldexp(torch.round(m * 2 ** bits) / 2 ** bits, e)


def flash_control(q, k, v, do, o, lse, window, fault):
    """What a faulty kernel would return, from the plain math in f32:
    ``tile_dropped`` never sees keys FLASH_DROPPED_KEYS; ``p_ds_4bit``
    rounds P and dS to 4 significant bits where the bf16 kernels round them
    to 8, ``p_ds_4bit_late_rows`` only in query rows from FLASH_LATE_ROWS
    on, whose |o| is ~sqrt(Dh) below the first rows'. -> (o, lse, dq, dk,
    dv); the backward takes the kernel's o and lse, as the backward kernel
    does."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    g, scale = hq // hkv, dh ** -0.5
    logits, mask = fa._grouped_logits(q, k, causal=True, window=window,
                                      logit_softcap=None, scale=scale,
                                      q_offset=0)
    if fault == "tile_dropped":
        mask = mask.clone()
        mask[:, FLASH_DROPPED_KEYS] = False
    late = torch.arange(s, device=q.device)[:, None] >= (
        FLASH_LATE_ROWS if fault == "p_ds_4bit_late_rows" else 0)

    def rnd(t):  # (B, Hkv, G, Sq, Skv)
        if not fault.startswith("p_ds_4bit"):
            return t
        return torch.where(late, round_significand(t, 4), t)
    masked = torch.where(mask, logits, -1e30)
    m = masked.amax(-1, keepdim=True)
    p = torch.exp(masked - m)
    del masked
    l = p.sum(-1, keepdim=True)
    o_c = torch.einsum("bhgqk,bkhd->bqhgd", rnd(p / l), v.float())
    lse_c = (m + torch.log(l)).reshape(b, hq, s)
    p = torch.where(mask, torch.exp(logits - lse.reshape(b, hkv, g, s, 1)),
                    0.0)
    del logits
    dof = do.float().reshape(b, s, hkv, g, dh)
    delta = (dof * o.float().reshape(b, s, hkv, g, dh)).sum(-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", rnd(p), dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = rnd(p * (dp - delta.permute(0, 2, 3, 1)[..., None]))
    del p, dp
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.float().reshape(b, s, hkv, g, dh)) * scale
    return (o_c.reshape(b, s, hq, dh), lse_c,
            (dq.reshape(b, s, hq, dh), dk, dv))


def run_flash(device, results):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        fwd_tol, bwd_tol = FLASH_TOL[str(dtype)]
        for model, hq, hkv, dh, windows in FLASH_SHAPES:
            def randn(*size):
                return torch.randn(size, generator=g, device=device).to(dtype)
            q, do = randn(b, s, hq, dh), randn(b, s, hq, dh)
            k, v = randn(b, s, hkv, dh), randn(b, s, hkv, dh)
            # SDPA's layout (B, H, S, Dh), and leaves for its backward
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            for window in windows:
                kw = dict(window=window)
                o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                 **kw)
                o_ref, lse_ref = fa.flash_attention_plain(
                    q, k, v, return_lse=True, **kw)
                grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
                grads_ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                         **kw)
                torch.cuda.synchronize()

                errs = flash_errors(o, lse, grads, o_ref, lse_ref,
                                    grads_ref)
                fwd_abs = float((o.float() - o_ref.float()).abs().max())
                bwd_abs = max(float((a.float() - r.float()).abs().max())
                              for a, r in zip(grads, grads_ref))
                finite = all(bool(torch.isfinite(t).all())
                             for t in (o, lse) + tuple(grads))
                del grads
                # each control must fail the limits on every output it
                # spoils; the old measure (max |error| over max |plain|) is
                # recorded beside the gated one
                limit = dict(o=fwd_tol, lse=fwd_tol, dq=bwd_tol, dk=bwd_tol,
                             dv=bwd_tol)
                controls = {}
                for fault, spoils in FLASH_CONTROLS.items():
                    c_o, c_lse, c_grads = flash_control(q, k, v, do, o, lse,
                                                        window, fault)
                    c_errs = flash_errors(c_o, c_lse, c_grads, o_ref,
                                          lse_ref, grads_ref)
                    old = {n: float((a.float() - r.float()).abs().max()
                                    / r.float().abs().max())
                           for n, a, r in zip(
                               ("o", "lse", "dq", "dk", "dv"),
                               (c_o, c_lse) + c_grads,
                               (o_ref, lse_ref) + grads_ref)}
                    controls[fault] = dict(err=c_errs, old_measure=old)
                    del c_o, c_lse, c_grads
                    missed = [n for n in spoils if c_errs[n] <= limit[n]]
                    if missed:
                        fail(f"flash attention limits do not catch control "
                             f"{fault} on {missed}: {model} {dtype_name} "
                             f"window {window}: {controls[fault]}")
                del o_ref, lse_ref, grads_ref
                if window is None:
                    sdpa_kw = dict(is_causal=True)
                else:
                    pos = torch.arange(s, device=device)
                    sdpa_kw = dict(attn_mask=(pos[None] <= pos[:, None])
                                   & (pos[None] > pos[:, None] - window))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True, **sdpa_kw)
                out_t = sdpa()

                def sdpa_bwd():
                    return torch.autograd.grad(out_t, (qt, kt, vt), dot,
                                               retain_graph=True)
                pairs = b * hq * visible_pairs(s, window)
                el = dtype.itemsize
                n_q, n_kv = b * s * hq * dh, b * s * hkv * dh
                n_lse = 4 * b * hq * s
                timed = (
                    ("flash_attention",
                     lambda: fa.flash_attention_cuda(q, k, v, **kw),
                     lambda: fa.flash_attention_plain(q, k, v, **kw), sdpa,
                     el * (2 * n_q + 2 * n_kv) + n_lse, 4 * dh * pairs,
                     ("o", "lse"), fwd_abs, fwd_tol),
                    ("flash_attention_bwd",
                     lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                         **kw),
                     lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse,
                                                          do, **kw),
                     sdpa_bwd, el * (4 * n_q + 4 * n_kv) + n_lse,
                     10 * dh * pairs, ("dq", "dk", "dv"), bwd_abs, bwd_tol))
                for (kernel, run, plain, lib, nbytes, ops, outputs, abs_err,
                     tol) in timed:
                    err = {n: errs[n] for n in outputs}
                    ok = max(err.values()) <= tol and finite
                    ms, host_ms = bench([run], 10)
                    plain_ms, _ = bench([plain], 2)
                    lib_ms, _ = bench([lib], 10)
                    bound_ms, bound_by = bound(nbytes, ops, dtype)
                    plan = fa._flash_plan(q, k, True, window, 0,
                                          kernel.endswith("bwd"))
                    tiles = {ln.kernel: dict(
                        (what, tile) for what, _, tile, _ in ln.tiles)
                        for ln in plan.launches}
                    rec = dict(kernel=kernel, model=model, dtype=dtype_name,
                               b=b, s=s, hq=hq, hkv=hkv, dh=dh,
                               window=window, visible_pairs=pairs,
                               tiles=tiles, bound_share=bound_ms / ms,
                               max_abs_err=abs_err, err=err, tol=tol,
                               ok=ok, controls={
                                   f: dict(err={n: c["err"][n]
                                                for n in outputs},
                                           old_measure={
                                               n: c["old_measure"][n]
                                               for n in outputs})
                                   for f, c in controls.items()},
                               ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=lib_ms,
                               library="SDPA (enable_gqa, "
                               + ("causal" if window is None
                                  else "window mask")
                               + (", backward through autograd)"
                                  if kernel.endswith("bwd") else ")"))
                    results.append(rec)
                    log(json.dumps(rec))
                    if not ok:
                        fail(f"{kernel} disagrees with its plain version: "
                             f"{rec}")
                del o, lse, out_t
            del q, k, v, do, qt, kt, vt, dot
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 7 and 7b: train gemma3-4b and granite-moe-1b-a400m at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
# kernels vs plain versions, one step from the same weights. In bf16 both
# round every activation to bf16 at the same places, but sums taken in
# another order flip single roundings (2^-8 relative each), and 34 layers
# carry the flips on: the slab gradients differ by ~3% (relative Frobenius
# norm) in the first layer as in the last. The same step in f32 compute
# shows that this is rounding: there the kernels agree with the plain
# versions to f32 summation order. "slab_grad" holds each compared
# parameter's gradient: the first and last layers' FFN (or MoE) and
# attention parameters.
STEP_TOL = {"bfloat16": {"loss": 1e-2, "grad_norm": 3e-2, "slab_grad": 5e-2},
            "float32": {"loss": 1e-5, "grad_norm": 1e-4, "slab_grad": 1e-3}}


ALL_KERNELS = ("csd_spmm_fwd", "csd_spmm_fwd_quant", "csd_spmm_fwd_batched",
               "csd_spmm_fwd_quant_batched", "csd_spmm_dx",
               "csd_spmm_dx_batched", "csd_spmm_dw", "csd_spmm_dw_batched",
               "csd_mask_cotangent", "csd_spmm_fwd_small",
               "csd_spmm_dx_small", "csd_spmm_dw_small",
               "csd_spmm_fwd_quant_small",
               "paged_decode_attention", "paged_decode_attention_quant",
               "paged_decode_attention_grouped",
               "paged_decode_attention_quant_grouped",
               "flash_attention", "flash_attention_bwd",
               "csd_spmm_fwd_injected_alias")


def wrapper(kernel: str):
    """The wrapper that counts ``kernel``'s launches."""
    from repro_torch.analysis import grid_pass
    from repro_torch.kernels import csd_spmm, flash_attention
    if kernel == grid_pass.INJECTED:
        return grid_pass.csd_spmm_fwd_injected_alias_cuda
    module = csd_spmm if kernel.startswith("csd") else flash_attention
    return getattr(module, f"{kernel}_cuda")


def launch_counts() -> dict:
    return {k: wrapper(k).launches for k in ALL_KERNELS}


def reset_launch_counts():
    from repro_torch.kernels import flash_attention
    for k in ALL_KERNELS:
        wrapper(k).launches = 0
    for k in flash_attention.PAGED_FORM_LAUNCHES:
        flash_attention.PAGED_FORM_LAUNCHES[k] = 0


def paged_form_counts() -> dict:
    """The paged decode wrappers' launches by split kernel (the
    CUDA-core ``paged_decode_kernel``, the tensor-core
    ``paged_decode_mma_kernel``) since the last ``reset_launch_counts``."""
    from repro_torch.kernels import flash_attention
    return dict(flash_attention.PAGED_FORM_LAUNCHES)


def paged_form_of(cfg, quant) -> str:
    """The split kernel ``launch.paged_rule`` gives ``cfg``'s paged decode
    (bf16 q; int8 pages with ``quant``)."""
    from repro_torch.kernels import launch
    form = launch.paged_rule(cfg.n_heads // cfg.n_kv_heads, cfg.head_dim,
                             16, "bfloat16", quant is not None)
    return "paged_decode_mma_kernel" if form == "mma" \
        else "paged_decode_kernel"


def train_launches_per_step(cfg) -> dict:
    """Every kernel's launches in one training step of ``cfg``: each of the
    3 junctions of a layer runs the forward (twice with remat: the
    recompute), dx and dw once; the expert-batched forms for an MoE
    model; the junction whose epilogue carries a fused activation (one per
    layer, where the activation fuses: gelu, not silu) runs the mask
    kernel once; each layer's attention runs the flash forward (twice with
    remat) and its backward once; no other kernel."""
    from repro_torch.nn.ffn import _FUSABLE
    form = "_batched" if cfg.moe is not None else ""
    n = 3 * cfg.n_layers
    fwd = 2 if cfg.remat else 1
    want = {f"csd_spmm_fwd{form}": fwd * n,
            f"csd_spmm_dx{form}": n, f"csd_spmm_dw{form}": n,
            "csd_mask_cotangent":
                cfg.n_layers if _FUSABLE.get(cfg.act) else 0,
            "flash_attention": fwd * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    return {k: want.get(k, 0) for k in ALL_KERNELS}


@contextmanager
def routing(record=None, replay=None):
    """Patch ``torch.topk``, which in a training step only the MoE router
    calls: append each call's expert choices to ``record``, or give back
    the choices of ``replay`` in call order instead of choosing (the gates
    are then the router's probabilities at those experts), so that two
    runs route alike."""
    import torch
    topk = torch.topk
    todo = iter(replay) if replay is not None else None

    def patched(t, k, dim=-1, **kw):
        if todo is not None:
            ids = next(todo)
            return torch.gather(t, dim, ids), ids
        vals, ids = topk(t, k, dim=dim, **kw)
        record.append(ids.detach())
        return vals, ids

    with mock.patch.object(torch, "topk", patched):
        yield


def routing_differences(a: list, b: list, n_layers: int) -> dict:
    """How many (layer, token) expert sets differ between two runs' first
    forward (the captures after it are the remat recompute)."""
    tokens = sum(x.shape[0] for x in a[:n_layers])
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a[:n_layers], b[:n_layers]))
    return dict(token_layer_sets=tokens, differing=diff)


def loss_and_grads(model, batch, names):
    """One step's loss, global gradient norm and copies of the gradients
    of ``names``; the gradients are dropped afterwards."""
    import torch
    from repro_torch.optim import adam
    model.zero_grad(set_to_none=True)
    loss, _ = model.loss(batch)
    loss.backward()
    params = dict(model.named_parameters())
    gnorm = float(adam.global_norm({n: p.grad for n, p in params.items()}))
    sel = {n: params[n].grad.detach().clone() for n in names}
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return float(loss.detach()), gnorm, sel


def step_check(model, batch, cfg, dtype_name):
    """One step's loss and gradients with the kernels and with the plain
    versions, computing in ``dtype_name``; fails past ``STEP_TOL``. The
    gradients compared are the first and last layers' FFN (or MoE) and
    attention parameters. For MoE the plain versions run twice: routing on their
    own, where the routing choices that differ from the kernels' run are
    counted and the gradients recorded, and with the kernels' run's
    routing replayed, which is the run held to ``STEP_TOL``: a flipped
    choice sends a token through other experts, a difference no kernel
    tolerance describes."""
    import torch
    last = cfg.n_layers - 1
    names = [n for n, _ in model.named_parameters()
             if any(n.startswith(f"layers.{i}.{part}.") for i in (0, last)
                    for part in ("ffn", "attn"))]
    routes_k, routes_p = [], []
    moe = cfg.moe is not None
    model.cfg = cfg.with_(dtype=dtype_name)  # the compute dtype of embed_in
    try:
        t0 = time.perf_counter()
        with routing(record=routes_k):
            loss_k, gn_k, sel_k = loss_and_grads(model, batch, names)
        t_k = time.perf_counter()
        with plain_versions(), routing(record=routes_p):
            loss_p, gn_p, sel_p = loss_and_grads(model, batch, names)
        t_p = time.perf_counter()
        if moe:
            own = loss_p, gn_p, sel_p
            with plain_versions(), routing(replay=routes_k):
                loss_p, gn_p, sel_p = loss_and_grads(model, batch, names)
    finally:
        model.cfg = cfg

    def errors(loss, gn, sel):
        return dict(
            loss_plain=loss, loss_rel_err=abs(loss_k - loss) / abs(loss),
            grad_norm_plain=gn, grad_norm_rel_err=abs(gn_k - gn) / gn,
            slab_grad_rel_fro_err={
                n: float(torch.linalg.vector_norm(sel_k[n] - sel[n])
                         / torch.linalg.vector_norm(sel[n])) for n in names})

    tol = STEP_TOL[dtype_name]
    chk = dict(check=f"{cfg.name}: one training step, kernels vs plain "
                     f"versions" + (" (routing replayed)" if moe else ""),
               dtype=dtype_name, loss_kernels=loss_k, grad_norm_kernels=gn_k,
               **errors(loss_p, gn_p, sel_p), tol=tol,
               kernel_step_s=t_k - t0, plain_step_s=t_p - t_k,
               ln_vocab=math.log(cfg.vocab_size))
    if moe:
        chk["own_routing"] = dict(
            routing=routing_differences(routes_k, routes_p, cfg.n_layers),
            **errors(*own))
    log(json.dumps(chk))
    if not (math.isfinite(loss_k) and math.isfinite(gn_k)) \
            or chk["loss_rel_err"] > tol["loss"] \
            or chk["grad_norm_rel_err"] > tol["grad_norm"] \
            or max(chk["slab_grad_rel_fro_err"].values()) > tol["slab_grad"]:
        fail(f"training step with kernels disagrees with plain: {chk}")
    return chk


def determinism_check(model, batch, cfg):
    """Two identical steps with the kernels, in the compute dtype, must
    give bit-identical loss and gradients (every parameter)."""
    import torch
    model.zero_grad(set_to_none=True)
    loss_a, _ = model.loss(batch)
    loss_a.backward()
    first = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    loss_b, _ = model.loss(batch)
    loss_b.backward()
    differ = [n for n, p in model.named_parameters()
              if not torch.equal(p.grad, first[n])]
    same_loss = bool(torch.equal(loss_a.detach(), loss_b.detach()))
    del first
    model.zero_grad(set_to_none=True)
    rec = dict(check=f"{cfg.name}: two identical {cfg.dtype} steps",
               loss=float(loss_a.detach()), loss_bit_identical=same_loss,
               n_params=len(list(model.parameters())),
               grads_differing=differ)
    log(json.dumps(rec))
    if not same_loss or differ:
        fail(f"two identical training steps differ: {rec}")
    return rec


def train(device, cfg, out_dir, trace="train_trace"):
    import numpy as np
    import torch
    from repro_torch.data import BigramLM
    from repro_torch.nn.model import LM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    t0 = time.perf_counter()
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    data = BigramLM(vocab_size=cfg.vocab_size, seed=SEED)
    tc = TrainerConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=1,
                                       total_steps=TRAIN_STEPS), log_every=1)
    trainer = Trainer(model, tc, device=device)
    batch = trainer.to_device(data.batch(0, TRAIN_BATCH, TRAIN_SEQ))
    t_k = time.perf_counter()
    chk = [step_check(model, batch, cfg, cfg.dtype),
           step_check(model, batch, cfg, "float32"),
           determinism_check(model, batch, cfg)]

    params, opt = trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    hist = []
    reset_launch_counts()
    trainer.fit(data.iterate(TRAIN_BATCH, TRAIN_SEQ), TRAIN_STEPS,
                on_step=lambda s, m: (hist.append(m), log(json.dumps(
                    dict(step=s, **m)))), params=params, opt=opt)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = [tokens / h["tokens_per_s"] for h in hist]
    steady = step_s[1:] or step_s
    rec = dict(model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, n_params=n_params, dtype=cfg.dtype,
               param_dtype=cfg.param_dtype, remat=cfg.remat,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
               losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist], step_s=step_s,
               steady_step_s=sum(steady) / len(steady),
               tokens_per_s=tokens * len(steady) / sum(steady),
               peak_mem_gb=peak_gb, launches=launches,
               launches_per_step={k: v / TRAIN_STEPS
                                  for k, v in launches.items()},
               setup_s=t_k - t0)
    if cfg.moe is not None:
        rec.update(expert_blocks=[cfg.sparsity.block_in,
                                  cfg.sparsity.block_out],
                   capacity_factor=cfg.moe.capacity_factor,
                   expert_capacity=expert_capacity(cfg, tokens),
                   moe_lb=[h["moe_lb"] for h in hist],
                   moe_z=[h["moe_z"] for h in hist])
    log(json.dumps(rec))
    losses = np.asarray(rec["losses"])
    if not np.isfinite(losses).all() \
            or abs(losses[0] - math.log(cfg.vocab_size)) > 2.5:
        fail(f"training losses not finite or far from ln(vocab): {rec}")
    want = {k: v * TRAIN_STEPS for k, v in
            train_launches_per_step(cfg).items()}
    if launches != want:
        fail(f"{cfg.name}: the training run launched {launches}, expected "
             f"{want}")
    prof = profile_train(trainer, params, opt, data, out_dir, trace)
    return chk, rec, prof


# the port's kernels by the names of their CUDA functions
KERNEL_FUNCTIONS = {"csd_spmm_fwd": ("csd_spmm_fwd_kernel",
                                     "csd_spmm_fwd_wgmma_kernel"),
                    "csd_spmm_dx": ("csd_spmm_dx_wgmma_kernel",
                                    "csd_spmm_dx_f32_kernel"),
                    "csd_spmm_dw": ("csd_spmm_dw_wgmma_kernel",
                                    "csd_spmm_dw_f32_kernel"),
                    "csd_mask_cotangent": ("csd_mask_cotangent_kernel",),
                    "flash_attention": ("flash_fwd_kernel",
                                        "flash_fwd_wgmma_kernel"),
                    "flash_attention_bwd": ("flash_dq_kernel",
                                            "flash_dkv_kernel",
                                            "flash_dq_wgmma_kernel",
                                            "flash_dkv_wgmma_kernel")}


def port_kernel(name: str):
    """Which of the port's kernels a profiled CUDA function is, or None."""
    return next((k for k, fns in KERNEL_FUNCTIONS.items()
                 if any(f in name for f in fns)), None)


def kernel_kind(name: str) -> str:
    """A kernel's kind, for the step's time breakdown: the port's junction
    and attention kernels by name; library matrix products in f32 and in
    other types (projections, head); copies and casts; reductions; other
    elementwise work."""
    low = name.lower()
    kernel = port_kernel(name)
    if kernel is not None:
        return kernel
    if any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass", "gemv",
                              "dot_kernel")):
        f32 = any(t in low for t in ("f32f32", "sgemm", "<float"))
        return "matmul f32" if f32 else "matmul bf16"
    if "copy" in low:
        return "copy/cast"
    if "reduce" in low or "softmax" in low:
        return "reduction"
    return "elementwise/other"


def profile_train(trainer, params, opt, data, out_dir, trace):
    """Where a training step's time goes: one ``Trainer`` step under
    ``torch.profiler``, kernel time summed by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = trainer.to_device(data.batch(TRAIN_STEPS, TRAIN_BATCH,
                                         TRAIN_SEQ))
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    export_trace(prof, out_dir / f"{trace}.json")

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total_us = sum(dev_us(e) for e in kernels)
    by_kernel = {k: sum(dev_us(e) for e in kernels
                        if port_kernel(e.key) == k) / 1e3
                 for k in KERNEL_FUNCTIONS}
    by_kind = {}
    for e in kernels:
        kind = kernel_kind(e.key)
        ms, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (ms + dev_us(e) / 1e3, n + e.count)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    rec = dict(check="training step profile", wall_ms=wall * 1e3,
               kernel_ms=total_us / 1e3 if total_us else "not measured",
               device_idle_share=1 - total_us / 1e6 / wall
               if total_us else "not measured",
               kernel_launches=sum(e.count for e in kernels),
               port_kernel_ms=by_kernel, port_launches=launches,
               by_kind={k: dict(ms=ms, launches=n)
                        for k, (ms, n) in sorted(by_kind.items(),
                                                 key=lambda kv: -kv[1][0])},
               top=[dict(name=e.key[:70], ms=dev_us(e) / 1e3,
                         calls=e.count) for e in top])
    log(json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 7d: checkpoints, restart, DiLoCo and metrics at full width
# ---------------------------------------------------------------------------

CKPT_LAYERS = 4          # gemma3-4b's full width; the depth cut for disk
CKPT_STEPS, CKPT_EVERY, CKPT_FAIL = 4, 2, 3
DILOCO_PERIOD = 2
# the card's sync against the same formula in numpy f32 on the CPU, of the
# largest |value|: the same operations in the same order (no FMA)
DILOCO_TOL = 1e-6


def full_depth_params(cfg, model) -> int:
    """The parameter count of ``cfg`` at its full depth from ``model``, the
    same configuration at fewer layers (every layer has the same shapes)."""
    per_layer = sum(p.numel() for n, p in model.named_parameters()
                    if n.startswith("layers.0."))
    return sum(p.numel() for p in model.parameters()) \
        + (cfg.n_layers - model.cfg.n_layers) * per_layer


def diloco_formula(before: dict, lr: float, mom: float):
    """The parameter after one DiLoCo sync, computed in numpy f32 from its
    values before the sync (p, anchor, outer momentum, error feedback)."""
    import numpy as np
    f32 = np.float32
    p, a, m, e = (before[k].numpy() for k in ("p", "anchor", "outer_m", "err"))
    target = (a - p.astype(f32)) + e
    scale = f32(max(np.abs(target).max(), f32(1e-12))) / f32(127)
    q = np.clip(np.rint(target / scale), -127, 127)
    m = f32(mom) * m + q.astype(f32) * scale
    return a - f32(lr) * m


def flip_byte(path: Path, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def run_checkpointing(device, cfg) -> dict:
    """Phase 7d: gemma3-4b at full width and ``CKPT_LAYERS`` layers, bf16
    over f32 parameters, batch 2 x 2048, in a temporary directory that it
    removes. An uncut run of ``CKPT_STEPS`` ``Trainer`` steps; a fresh model
    of the same seed cut at step ``CKPT_FAIL`` through the CLI's restart
    loop (``launch.train.train_with_restarts``: checkpoints every
    ``CKPT_EVERY`` steps, keep 1) and resumed from that checkpoint: its
    losses, parameters and AdamW state bit-equal to the uncut run's; the
    device's peak allocation read around each of its saves and its restore
    may rise above the resting allocation by less than the largest tensor;
    its steps are timed (step 3 runs while step 2's save is written). A
    byte flipped in its last checkpoint makes ``restore`` raise
    ``IOError``. Two DiLoCo runs (period ``DILOCO_PERIOD``) bit-equal,
    each sync of the first and last layers' parameters against
    ``diloco_formula``, peak memory against the three state copies. One
    step with the JSONL sink and the profile directory (the stream replays
    through ``obs.dump``, the trace names ``train/step``) and one without:
    equal launches; ``train_step`` under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_7d_"))
    try:
        return checkpointing(device, cfg, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def checkpointing(device, cfg, tmp: Path) -> dict:
    import shutil
    import torch
    from repro_torch.data import BigramLM
    from repro_torch.launch.train import train_with_restarts
    from repro_torch.nn.model import LM
    from repro_torch.obs import Registry, dump
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    ccfg = cfg.with_(n_layers=CKPT_LAYERS)
    data = BigramLM(vocab_size=ccfg.vocab_size, seed=SEED)
    rec = dict(model=ccfg.name, n_layers=CKPT_LAYERS, d_model=ccfg.d_model,
               vocab=ccfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ)

    def fresh():
        return LM(ccfg, device=device,
                  generator=torch.Generator(device=device).manual_seed(SEED))

    def trainer(model, **kw):
        return Trainer(model, TrainerConfig(
            opt=AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=CKPT_STEPS),
            log_every=1, metrics=False, **kw), device=device)

    def batches(start):
        return data.iterate(TRAIN_BATCH, TRAIN_SEQ, start_step=start)

    def sync_peak():
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(device)

    # the uncut run
    model_a = fresh()
    n_params = sum(p.numel() for p in model_a.parameters())
    largest = max(p.numel() * p.element_size() for p in model_a.parameters())
    rec.update(n_params=n_params, state_bytes=12 * n_params,
               full_depth_state_bytes=12 * full_depth_params(cfg, model_a),
               largest_tensor_bytes=largest,
               free_bytes=shutil.disk_usage(tmp).free, directory=str(tmp))
    log(json.dumps(dict(check="phase 7d sizes", **rec)))
    losses_a = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    pa, oa, _ = trainer(model_a).fit(
        batches(0), CKPT_STEPS,
        on_step=lambda s, m: losses_a.append(m["loss"]))
    rec["train_peak_bytes"] = sync_peak()
    model_a.zero_grad(set_to_none=True)

    # the cut run, resumed from its checkpoint; the device's peak
    # allocation read around each save and restore
    model_b = fresh()
    tb = trainer(model_b, checkpoint_dir=str(tmp / "ckpt"),
                 checkpoint_every=CKPT_EVERY, checkpoint_keep=1)
    mgr, mem = tb.ckpt, []

    def measured(fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            rest = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            mem.append(dict(call=fn.__name__, resting_bytes=rest,
                            rise_bytes=sync_peak() - rest,
                            seconds=time.perf_counter() - t0))
            return out
        return call

    mgr.save, mgr.restore = measured(mgr.save), measured(mgr.restore)
    train_step, step_s = tb.train_step, []

    def timed_step(*args):  # step 3 runs while step 2's save is written
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    tb.train_step = timed_step
    losses_b, restarts = [], []
    pb, ob, _ = train_with_restarts(
        tb, batches, CKPT_STEPS, fail_at=CKPT_FAIL,
        on_step=lambda s, m: losses_b.append((s, m["loss"])),
        log=restarts.append)
    mgr.wait()
    model_b.zero_grad(set_to_none=True)
    differ = [n for n in pa if not torch.equal(pa[n], pb[n])] + [
        f"opt/{k}/{n}" for k in ("m", "v") for n in pa
        if not torch.equal(oa[k][n], ob[k][n])]
    resume = dict(losses=losses_a, losses_cut=[v for _, v in losses_b],
                  steps_cut=[s for s, _ in losses_b], restarts=restarts,
                  checkpoints=mgr.steps(), differing=differ,
                  saves=list(mgr.save_stats),
                  restores=list(mgr.restore_stats), memory=mem,
                  largest_tensor_bytes=largest, step_s=step_s,
                  step_in_flight_s=step_s[CKPT_EVERY])
    log(json.dumps(dict(check="phase 7d: cut at step 3, resumed", **resume)))
    if resume["losses_cut"] != losses_a or differ \
            or resume["steps_cut"] != list(range(1, CKPT_STEPS + 1)) \
            or len(restarts) != 1 or oa["step"] != ob["step"] \
            or resume["checkpoints"] != [CKPT_STEPS]:
        fail(f"the resumed run differs from the uncut run: {resume}")
    if [m["call"] for m in mem] != ["save", "save", "restore", "save"] \
            or any(m["rise_bytes"] >= largest for m in mem):
        fail(f"saves and restores raised the device allocation by the "
             f"largest tensor ({largest} bytes) or more: {mem}")
    rec["resume"] = resume
    del pa, oa, model_a
    gc.collect()
    torch.cuda.empty_cache()

    # a flipped byte in the shard
    flip_byte(tmp / "ckpt" / f"step_{CKPT_STEPS:08d}" / "shard-00000.npz",
              4096)
    try:
        mgr.restore(CKPT_STEPS, {"params": pb, "opt": ob})
    except IOError as e:
        rec["corruption"] = str(e)
    else:
        fail("restore of a corrupted shard did not raise IOError")
    log(json.dumps(dict(check="phase 7d: corrupted shard",
                        error=rec["corruption"])))
    del pb, ob, tb, mgr, model_b, train_step, timed_step
    gc.collect()
    torch.cuda.empty_cache()

    # two DiLoCo runs
    runs = []
    for capture in (True, False):
        model = fresh()
        tr = trainer(model, diloco_period=DILOCO_PERIOD)
        real_sync, syncs = tr.diloco_sync, []
        names = [n for n, _ in model.named_parameters()
                 if n.startswith(("layers.0.", f"layers.{CKPT_LAYERS - 1}."))]
        peak = [0]

        def sync(params, dstate, axis_name=None):
            before = {n: {"p": params[n].detach().to("cpu", copy=True),
                          **{k: dstate[k][n].to("cpu", copy=True)
                             for k in ("anchor", "outer_m", "err")}}
                      for n in names} if capture else None
            peak[0] = max(peak[0], sync_peak())
            rest = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            out = real_sync(params, dstate, axis_name)
            one = dict(seconds=time.perf_counter() - t0)
            one["rise_bytes"] = sync_peak() - rest
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated(device))
            if capture:
                lr, mom = (tr.cfg.diloco_outer_lr,
                           tr.cfg.diloco_outer_momentum)
                one["rel_err"] = max(
                    float((params[n].detach().cpu() - torch.from_numpy(
                        want)).abs().max()) / float(abs(want).max())
                    for n in names
                    for want in [diloco_formula(before[n], lr, mom)])
            syncs.append(one)
            return out

        tr.diloco_sync = sync
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        params, _, _ = tr.fit(batches(0), CKPT_STEPS,
                              on_step=lambda s, m: losses.append(m["loss"]))
        peak[0] = max(peak[0], sync_peak())
        model.zero_grad(set_to_none=True)
        runs.append(dict(model=model, params=params, losses=losses,
                         syncs=syncs, peak_bytes=peak[0]))
    differ = [n for n in runs[0]["params"]
              if not torch.equal(runs[0]["params"][n], runs[1]["params"][n])]
    diloco = dict(period=DILOCO_PERIOD, losses=[r["losses"] for r in runs],
                  differing=differ, syncs=[r["syncs"] for r in runs],
                  peak_bytes=[r["peak_bytes"] for r in runs],
                  state_copies_bytes=3 * 4 * n_params,
                  train_peak_bytes=rec["train_peak_bytes"], tol=DILOCO_TOL)
    log(json.dumps(dict(check="phase 7d: DiLoCo", **diloco)))
    if runs[0]["losses"] != runs[1]["losses"] or differ \
            or len(runs[0]["syncs"]) != CKPT_STEPS // DILOCO_PERIOD \
            or max(s["rel_err"] for s in runs[0]["syncs"]) > DILOCO_TOL:
        fail(f"DiLoCo runs: {diloco}")
    rec["diloco"] = diloco
    model = runs[1]["model"]
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    # one step with metrics and a profile, one without
    reg = Registry(jsonl_path=str(tmp / "m.jsonl"))
    params = dict(model.named_parameters())
    launches = {}
    for on in (True, False):
        tr = Trainer(model, TrainerConfig(
            opt=AdamWConfig(lr=3e-4), log_every=1, metrics=on,
            profile_dir=str(tmp / "prof") if on else None),
            device=device, registry=reg if on else None)
        _, opt = tr.init_state()
        reset_launch_counts()
        tr.fit(batches(0), 1, params=params, opt=opt,
               on_step=lambda s, m: None)
        torch.cuda.synchronize()
        launches[on] = launch_counts()
    reg.close()
    replayed = dump.replay(str(tmp / "m.jsonl"))
    batch = tr.to_device(data.batch(0, TRAIN_BATCH, TRAIN_SEQ))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.train_step(params, opt, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    obs = dict(launches_on={k: v for k, v in launches[True].items() if v},
               launches_off={k: v for k, v in launches[False].items() if v},
               jsonl_steps=replayed.counter("train_steps_total").value(),
               jsonl_spans=len(replayed.span_durations("train/step")),
               trace_spans=trace_spans(tmp / "prof", "train/step"),
               sync_debug="clean")
    log(json.dumps(dict(check="phase 7d: metrics and profile", **obs)))
    if launches[True] != launches[False] \
            or launches[True] != train_launches_per_step(ccfg) \
            or obs["jsonl_steps"] != 1 or obs["jsonl_spans"] != 1 \
            or obs["trace_spans"] != 1:
        fail(f"a step with metrics and a profile: {obs}")
    rec["obs"] = obs
    return rec


# ---------------------------------------------------------------------------
# phase 7c: the port's sparselint on the card
# ---------------------------------------------------------------------------

# every plan the run launched, by (plan name, its arguments): what the
# drift guard holds against the libraries' own plans
LAUNCHED_PLANS = {}


def record_plans():
    """Wrap the launch hook so that every plan launched from here on is
    kept in ``LAUNCHED_PLANS`` (the launch itself is unchanged)."""
    from repro_torch.kernels import launch
    real = launch.run

    def run(plan, buffers, call):
        LAUNCHED_PLANS.setdefault(
            (plan.name, tuple(sorted(plan.args.items()))), plan)
        return real(plan, buffers, call)

    launch.run = run


def lint_run(argv, out_dir: Path, name: str) -> tuple:
    """``python -m repro_torch.analysis.lint`` in this process: (exit code,
    report, seconds); the text report goes to ``chiprun_out/<name>``."""
    import contextlib
    import io
    from repro_torch.analysis import lint
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = lint.main(list(argv) + ["--device", "cuda", "--format", "json"])
    secs = time.perf_counter() - t0
    (out_dir / name).write_text(buf.getvalue())
    return rc, json.loads(buf.getvalue()), secs


def run_lint(out_dir: Path) -> dict:
    """Phase 7c(a): the lint on the card, clean (exit 0) and with
    ``--selftest-inject`` (exit 1 with SL101 on the race-broken kernel and
    SL206 on the whole-slab upcast and nothing else), with every kernel's
    launches counted around the two runs: the dispatch pass drives both
    models' full-width serving and training steps, the self-test launches
    the race-broken kernel once."""
    from repro_torch.analysis import grid_pass
    reset_launch_counts()
    rc, rep, secs = lint_run([], out_dir, "lint.json")
    if rc != 0:
        fail(f"lint on the card exited {rc}: "
             f"{[f['code'] + ' ' + f['subject'] for f in rep['findings']]} "
             f"errors {rep['errors']}")
    rc_i, rep_i, secs_i = lint_run(["--selftest-inject"], out_dir,
                                   "lint_selftest.json")
    launches = launch_counts()
    found = sorted((f["code"], f["subject"]) for f in rep_i["findings"]
                   if not f.get("suppressed"))
    want = [("SL101", grid_pass.INJECTED), ("SL206", "quant_inject[selftest]")]
    if rc_i != 1 or found != want or rep_i["errors"]:
        fail(f"lint --selftest-inject: exit {rc_i}, findings {found} "
             f"(expected {want}), errors {rep_i['errors']}")
    if launches[grid_pass.INJECTED] != 1:
        fail(f"the self-test launched the race-broken kernel "
             f"{launches[grid_pass.INJECTED]} times, expected 1")
    # the small-block forms run no full-width step (phases 3d-3f)
    idle = [k for k in ALL_KERNELS if launches[k] == 0
            and k not in SMALL_KERNELS]
    if idle:
        fail(f"the lint's full-width steps never launched {idle}")
    rec = dict(check="lint", exit=rc, exit_selftest=rc_i, seconds=secs,
               seconds_selftest=secs_i, covered={
                   k: len(v) for k, v in rep["covered"].items()},
               selftest_findings=[list(f) for f in found],
               selftest_notes=rep_i["notes"], launches=launches)
    log(json.dumps(rec))
    for note in rep_i["notes"]:
        log(f"lint: {note}")
    return rec


def plan_drift(device) -> dict:
    """Phase 7c(b): every plan this run launched, and every lint case's plan
    for this card's SM count, against the plan its kernel's library
    computes with the launcher's own host code (``<name>_plan``)."""
    from repro_torch.analysis import grid_pass
    from repro_torch.kernels import launch
    n_sm = launch.sm_count(device)
    plans = dict(LAUNCHED_PLANS)
    for case in grid_pass.kernel_cases() + [grid_pass.injected_alias_case()]:
        p = case.build(n_sm)
        plans.setdefault((p.name, tuple(sorted(p.args.items()))), p)
    bad = []
    for key, p in plans.items():
        lib = [(tuple(g), t, m, c)
               for g, t, m, c in launch.library_dims(p)]
        if lib != p.dims():
            bad.append(dict(plan=key, python=p.dims(), library=lib))
    if bad:
        fail(f"{len(bad)} Python plan(s) disagree with their library: "
             f"{bad[:3]}")
    rec = dict(check="plan drift", plans=len(plans),
               launched=len(LAUNCHED_PLANS),
               by_kernel={n: sum(k[0] == n for k in plans)
                          for n in sorted({k[0] for k in plans})})
    log(json.dumps(rec))
    return rec


def nan_coverage(device) -> dict:
    """Phase 7c(c): each lint case (every shipped kernel family, demo and
    full-width shapes) launched twice from random inputs into outputs and
    scratch buffers filled with NaN: nothing may stay unwritten (the
    empirical side of SL101 and SL105) and the two runs must agree bit for
    bit (no atomics, fixed summation orders)."""
    import torch
    from repro_torch.analysis import grid_pass
    from repro_torch.kernels import launch
    real = launch.run
    written = []

    def nan_run(plan, buffers, call):
        outs = {k: t for k, t in buffers.items()
                if t is not None and plan.buffers[k].role != "in"}
        for t in outs.values():
            t.fill_(float("nan"))
        real(plan, buffers, call)
        written.append((plan.name, outs))
        kernels.add(plan.launches[0].kernel)
        names.add(plan.name)

    checked, cases = 0, grid_pass.kernel_cases()
    kernels, names = set(), set()
    launch.run = nan_run
    try:
        for i, case in enumerate(cases):
            args, kw = case.args(device, SEED + 100 + i)
            runs = []
            for _ in range(2):
                written.clear()
                case.fn(*args, **kw)
                torch.cuda.synchronize()
                runs.append([(n, k, t.clone()) for n, outs in written
                             for k, t in outs.items()])
            for (n, k, a), (_, _, b) in zip(*runs):
                if bool(torch.isnan(a).any()):
                    fail(f"{case.name}: {n} left {int(torch.isnan(a).sum())}"
                         f" element(s) of {k} unwritten")
                if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                    fail(f"{case.name}: two runs of {n} differ in {k}")
                checked += 1
            del args, kw, runs
            torch.cuda.empty_cache()
    finally:
        launch.run = real
    rec = dict(check="NaN-filled outputs, two runs", cases=len(cases),
               buffers=checked, kernels=sorted(kernels), plans=sorted(names))
    log(json.dumps(rec))
    missing = ({"paged_decode_kernel", "paged_decode_mma_kernel"} - kernels) \
        | ({"csd_spmm_fwd_quant_small"} - names)
    if missing:
        fail(f"the NaN runs launched no {sorted(missing)}")
    return rec


def run_injected(device) -> dict:
    """Phase 7c(d): TPU kernel #9's counterpart at the demo shape (x (256,
    512) f32, w (4, 2, 128, 128), fan-in 2): its error against the plain
    version must exceed 10x the shipped forward's tolerance while the
    shipped forward, forced to the same split, passes on the same inputs;
    then its time beside the shipped forward's (at that split and at its
    own), the plain version's, the bound (as the forward's at this shape)
    and a dense ``torch.matmul``."""
    import torch
    from repro_torch.analysis import grid_pass
    from repro_torch.kernels import csd_spmm
    ev = grid_pass.injected_alias_evidence(device, SEED)
    if not (ev["race_shows"] and ev["shipped_within"]):
        fail(f"the race-broken kernel's error does not show as expected: "
             f"{ev}")
    bp = grid_pass._demo_pattern()
    case = grid_pass.injected_alias_case()
    (x0, w0, idx), _ = case.args(device, SEED)
    n = copies_for(x0.numel() * 4 + w0.numel() * 4)
    xs = [x0.clone() for _ in range(n)]
    ws = [w0.clone() for _ in range(n)]
    d_in_b = bp.d_in_b
    bad = grid_pass.csd_spmm_fwd_injected_alias_cuda
    ms, _ = bench([lambda i=i: bad(xs[i], ws[i], idx) for i in range(n)], 200)
    split_ms, _ = bench([lambda i=i: csd_spmm._launch_fwd(
        "csd_spmm_fwd_cuda", xs[i], ws[i], idx, None, None, False,
        batched=False, n_splits=d_in_b) for i in range(n)], 200)
    own_ms, _ = bench([lambda i=i: csd_spmm.csd_spmm_fwd_cuda(
        xs[i], ws[i], idx) for i in range(n)], 200)
    plain_ms, _ = bench([lambda i=i: csd_spmm.csd_spmm_fwd_plain(
        xs[i], ws[i], idx) for i in range(n)], 20)
    dense = [dense_of(bp, w) for w in ws]
    lib_ms, _ = bench([lambda i=i: torch.matmul(xs[i], dense[i])
                       for i in range(n)], 200)
    m = x0.shape[0]
    nbytes = 4 * (x0.numel() + w0.numel() + m * bp.n_out) + 4 * idx.numel()
    bound_ms, bound_by = bound(nbytes, 2 * m * w0.numel(), torch.float32)
    rec = dict(ev, check="race-broken forward (TPU kernel #9)", ms=ms,
               shipped_same_split_ms=split_ms, shipped_ms=own_ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    log(json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "next to this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_all = time.perf_counter()
    done_at = {}  # seconds from here to the end of each phase

    def done(phase: str) -> None:
        done_at[phase] = round(time.perf_counter() - t_all, 1)
        log(f"phase {phase} done at {done_at[phase]} s")

    # phase 2
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"built {build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    sass_rec = sass_counts()
    paged_regs = paged_registers()
    stream_regs = stream_registers()
    small_regs = small_registers()

    record_plans()

    # phases 3-4, 4b, 3c
    results = []
    cfg = get_config("gemma3_4b")
    gcfg = granite_serving_config()
    run_spmm(cfg, device, results)
    run_paged(device, results)
    run_spmm_quant(cfg, device, results)
    run_paged_quant(device, results)
    run_spmm_batched(gcfg, device, results)
    torch.cuda.empty_cache()
    done("3-3c")

    # phases 3d-3f: the small-block forms, the paper MLP, the smoke configs
    run_small_kernels(device, results)
    done("3d")
    mlp_recs = run_mlp(device)
    done("3e")
    smoke_recs = run_smoke_configs(device)
    done("3f")
    example_recs = run_examples()
    done("3g")

    # phase 5
    from repro_torch.core.quant import QuantConfig
    from repro_torch.nn.model import LM
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def fresh_model(c=cfg):  # f32 parameters from the seed
        return LM(c, device=device,
                  generator=torch.Generator(device=device).manual_seed(SEED))

    bf16_model = fresh_model()
    serve_rec, chk_rec, prof_rec, bf16_toks, prompts = serve(
        bf16_model, device, out_dir)
    done("5")

    # phase 5b: the same weights, quantized at load from f32
    quant = QuantConfig(weights=True, kv=True)
    int8_model = fresh_model()
    q_serve_rec, q_chk_rec, q_prof_rec, _, _ = serve(
        int8_model, device, out_dir, quant=quant)
    agree_rec = top1_agreement(bf16_model, int8_model, prompts, bf16_toks,
                               device, quant)
    log(json.dumps(agree_rec))
    done("5b")

    # phase 5s: speculative decode on the models phases 5, 5b and 5c serve
    spec_recs = {"gemma3-4b bf16": spec_serve(bf16_model, device),
                 "gemma3-4b int8": spec_serve(int8_model, device, quant)}
    done("5s (gemma3-4b)")
    del bf16_model, int8_model
    gc.collect()  # the serving models and their engines
    torch.cuda.empty_cache()

    # phase 5c: granite-moe-1b-a400m in its serving configuration, bf16
    g_bytes = dict(zip(("bf16", "int8"), (expert_slab_bytes(gcfg, k)
                                          for k in (2, 1))))
    g_bf16 = fresh_model(gcfg)
    g_serve_rec, g_chk_rec, g_prof_rec, g_toks, g_prompts = serve(
        g_bf16, device, out_dir, trace="decode_trace_granite",
        slab_bytes=g_bytes["bf16"][0])
    done("5c")
    spec_recs["granite-moe-1b-a400m bf16"] = spec_serve(g_bf16, device)
    done("5s (granite-moe)")

    # phase 5d: the same weights, quantized at load from f32
    g_int8 = fresh_model(gcfg)
    gq_serve_rec, gq_chk_rec, gq_prof_rec, _, _ = serve(
        g_int8, device, out_dir, quant=quant, trace="decode_trace_granite",
        slab_bytes=g_bytes["int8"][0])
    if gq_serve_rec["ffn_scale_bytes"] != g_bytes["int8"][1]:
        fail(f"int8 expert scale bytes {gq_serve_rec['ffn_scale_bytes']}, "
             f"expected {g_bytes['int8'][1]}")
    g_agree_rec = top1_agreement(g_bf16, g_int8, g_prompts, g_toks, device,
                                 quant)
    log(json.dumps(g_agree_rec))
    done("5d")
    del g_bf16, g_int8
    gc.collect()
    torch.cuda.empty_cache()

    # phases 5e-5h: the dense decoders at full width and depth, 16 new
    # tokens a request; gemma2-9b with a fifth request of 4,160 prompt
    # tokens, past its 4096 window, in bf16 (5e) and int8 (5f)
    dense = {}
    g2cfg = get_config("gemma2_9b")
    g2_knobs = dict(max_slots=5, total_pages=320,
                    max_pages_per_seq=-(-(GEMMA2_LONG + DENSE_NEW) // 16),
                    token_budget=1024, prefill_chunk=512)
    g2_lens = DENSE_PROMPTS + (GEMMA2_LONG,)
    g2_bf16 = fresh_model(g2cfg)
    dense["5e"] = serve(g2_bf16, device, out_dir, prompt_lens=g2_lens,
                        n_new=DENSE_NEW, trace="decode_trace_gemma2",
                        knobs=g2_knobs)
    done("5e")
    g2_int8 = fresh_model(g2cfg)
    dense["5f"] = serve(g2_int8, device, out_dir, quant=quant,
                        prompt_lens=g2_lens, n_new=DENSE_NEW,
                        trace="decode_trace_gemma2", knobs=g2_knobs)
    n_short = len(DENSE_PROMPTS)
    g2_agree_rec = top1_agreement(g2_bf16, g2_int8,
                                  dense["5e"][4][:n_short],
                                  dense["5e"][3][:n_short], device, quant)
    log(json.dumps(g2_agree_rec))
    done("5f")
    del g2_bf16, g2_int8
    gc.collect()
    torch.cuda.empty_cache()
    # 5g: qwen2-7b, bf16
    q2_model = fresh_model(get_config("qwen2_7b"))
    dense["5g"] = serve(q2_model, device, out_dir, prompt_lens=DENSE_PROMPTS,
                        n_new=DENSE_NEW, trace="decode_trace_qwen2")
    done("5g")
    del q2_model
    gc.collect()
    torch.cuda.empty_cache()
    # 5h: granite-34b, bf16, 88 layers, its parameters built in bf16 (in
    # f32 they would not fit the card)
    g34_model = fresh_model(get_config("granite_34b").with_(
        param_dtype="bfloat16"))
    dense["5h"] = serve(g34_model, device, out_dir,
                        prompt_lens=DENSE_PROMPTS, n_new=DENSE_NEW,
                        trace="decode_trace_granite34b")
    done("5h")
    del g34_model
    gc.collect()
    torch.cuda.empty_cache()
    dense_recs = {k: dict(serve=v[0], logits_check=v[1], profile=v[2])
                  for k, v in dense.items()}
    dense_recs["5f"]["top1_agreement_int8"] = g2_agree_rec

    # phases 6 and 6b
    run_train_kernels(cfg, device, results)
    done("6")
    tcfg = granite_training_config()
    run_train_kernels_batched(tcfg, device, results)
    torch.cuda.empty_cache()
    done("6b")
    run_flash(device, results)
    torch.cuda.empty_cache()
    done("6c")

    # phase 7
    step_chk, train_rec, train_prof = train(device, cfg, out_dir)
    gc.collect()  # the gemma3 model, its gradients and AdamW state
    torch.cuda.empty_cache()
    done("7")

    # phase 7b
    g_step_chk, g_train_rec, g_train_prof = train(
        device, tcfg, out_dir, trace="train_trace_granite")
    gc.collect()
    torch.cuda.empty_cache()
    done("7b")

    # phase 7d: checkpoints, restart, DiLoCo and metrics at full width
    ckpt_rec = run_checkpointing(device, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    done("7d")

    # phase 7c: the port's sparselint on the card, the plans against the
    # libraries, NaN-filled outputs, and TPU kernel #9's race
    lint_rec = run_lint(out_dir)
    gc.collect()
    torch.cuda.empty_cache()
    drift_rec = plan_drift(device)
    nan_rec = nan_coverage(device)
    inj_rec = run_injected(device)
    torch.cuda.empty_cache()
    done("7c")

    # phase 8: one entry per kernel: the junction kernels at the training
    # shape of the gelu gate junction, paged decode at a decode step's, the
    # int8 kernels at the decode step's down junction and attention, the
    # full-sequence attention kernels at gemma3-4b's global layer
    def pick(kernel, **want):
        return next(r for r in results if r["kernel"] == kernel and all(
            r.get(k) == v for k, v in want.items()))

    gate = dict(junction="gate", m=TRAIN_M, dtype="bfloat16", on_g=False)
    # granite's training up/gate junction: silu runs outside it, no bias
    g_up = dict(junction="up/gate", activation=None, dtype="bfloat16",
                want_db=False)
    g_up_shape = (f"granite-moe up/gate, 32 experts of "
                  f"{expert_capacity(tcfg, TRAIN_M)} rows, bf16, w (32, 2, "
                  f"4, 128, 256)")
    gate_shape = (f"gate junction (gelu), M {TRAIN_M} bf16, "
                  f"w (10, 5, 256, 1024)")
    # gemma3-4b's global-layer attention
    attn = dict(model="gemma3-4b", dtype="bfloat16", window=None)
    attn_shape = (f"gemma3-4b global layer, q ({TRAIN_BATCH}, {TRAIN_SEQ}, "
                  f"8, 256) bf16, k/v ({TRAIN_BATCH}, {TRAIN_SEQ}, 4, 256), "
                  f"causal")
    entries = []
    for name, rec, src, replaces, launches, shape in (
            ("csd_spmm_fwd", pick("csd_spmm_fwd", **gate),
             "src/repro_torch/kernels/csrc/csd_spmm_fwd.cu",
             "src/repro/kernels/csd_spmm.py:385",
             train_rec["launches"]["csd_spmm_fwd"],
             gate_shape + ", save_preact"),
            ("paged_decode_attention",
             pick("paged_decode_attention", dtype="bfloat16", window=None,
                  dh=256),
             "src/repro_torch/kernels/csrc/paged_decode.cu",
             "src/repro/kernels/flash_attention.py:214",
             serve_rec["launches"]["paged_decode_attention"],
             "q (4, 4, 2, 256) bf16, page 16, lengths [1100, 517, 0, 1040]"),
            ("csd_spmm_dx", pick("csd_spmm_dx", **gate),
             "src/repro_torch/kernels/csrc/csd_spmm_dx.cu",
             "src/repro/kernels/csd_spmm.py:539",
             train_rec["launches"]["csd_spmm_dx"], gate_shape),
            ("csd_spmm_dw", pick("csd_spmm_dw", **gate),
             "src/repro_torch/kernels/csrc/csd_spmm_dw.cu",
             "src/repro/kernels/csd_spmm.py:679",
             train_rec["launches"]["csd_spmm_dw"], gate_shape),
            ("csd_mask_cotangent",
             pick("csd_mask_cotangent", junction="gate", m=TRAIN_M,
                  dtype="bfloat16"),
             "src/repro_torch/kernels/csrc/csd_mask_cotangent.cu",
             "src/repro/kernels/csd_spmm.py:526 (the mask inside #6's "
             "_dx_kernel; :658 inside #7's _dw_kernel)",
             train_rec["launches"]["csd_mask_cotangent"],
             f"gate junction (gelu) cotangent, dy and z ({TRAIN_M}, 10240) "
             f"bf16"),
            ("csd_spmm_fwd_quant",
             pick("csd_spmm_fwd_quant", junction="down", m=4,
                  dtype="bfloat16", activation=None),
             "src/repro_torch/kernels/csrc/csd_spmm_fwd_quant.cu",
             "src/repro/kernels/csd_spmm.py:253",
             q_serve_rec["launches"]["csd_spmm_fwd_quant"],
             "down, x (4, 10240) bf16, w int8 (5, 32, 256, 512), "
             "w_scale f32 (5, 32)"),
            ("paged_decode_attention_quant",
             pick("paged_decode_attention_quant", dtype="bfloat16",
                  window=None, dh=256),
             "src/repro_torch/kernels/csrc/paged_decode.cu",
             "src/repro/kernels/flash_attention.py:214",
             q_serve_rec["launches"]["paged_decode_attention_quant"],
             "q (4, 4, 2, 256) bf16, int8 pages, page 16, lengths "
             "[1100, 517, 0, 1040]"),
            ("csd_spmm_fwd_batched",
             pick("csd_spmm_fwd_batched", junction="down", m=4,
                  dtype="bfloat16", bias=False),
             "src/repro_torch/kernels/csrc/csd_spmm_fwd.cu",
             "src/repro/kernels/csd_spmm.py:337",
             g_serve_rec["launches"]["csd_spmm_fwd_batched"],
             "granite-moe down, x (32, 4, 512) bf16, w (32, 4, 3, 128, "
             "256)"),
            ("csd_spmm_fwd_quant_batched",
             pick("csd_spmm_fwd_quant_batched", junction="down", m=4,
                  dtype="bfloat16", bias=False),
             "src/repro_torch/kernels/csrc/csd_spmm_fwd_quant.cu",
             "src/repro/kernels/csd_spmm.py:295",
             gq_serve_rec["launches"]["csd_spmm_fwd_quant_batched"],
             "granite-moe down, x (32, 4, 512) bf16, w int8 (32, 4, 3, "
             "128, 256), w_scale f32 (32, 4, 3)"),
            ("csd_spmm_dx_batched", pick("csd_spmm_dx_batched", **g_up),
             "src/repro_torch/kernels/csrc/csd_spmm_dx.cu",
             "src/repro/kernels/csd_spmm.py:539",
             g_train_rec["launches"]["csd_spmm_dx_batched"],
             g_up_shape),
            ("csd_spmm_dw_batched", pick("csd_spmm_dw_batched", **g_up),
             "src/repro_torch/kernels/csrc/csd_spmm_dw.cu",
             "src/repro/kernels/csd_spmm.py:679",
             g_train_rec["launches"]["csd_spmm_dw_batched"],
             g_up_shape),
            ("flash_attention", pick("flash_attention", **attn),
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:87",
             train_rec["launches"]["flash_attention"], attn_shape),
            ("flash_attention_bwd", pick("flash_attention_bwd", **attn),
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "no TPU kernel: the reference differentiates "
             "src/repro/nn/attention.py:70 chunked_attention through XLA",
             train_rec["launches"]["flash_attention_bwd"], attn_shape)):
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=shape, **({"body": rec["body"]} if "body" in rec else {}),
            **({"split_kernel": rec["split_kernel"]}
               if "split_kernel" in rec else {})))
    # the small-block forms at the Table I junction's batch, f32, with
    # their launches in the paper MLP's training runs (phase 3e, the three
    # configurations summed) and in the smoke configurations' (phase 3f)
    table1 = dict(junction="table1 800->100", m=MLP_BATCH, dtype="float32")
    t1_shape = ("Table I junction 800 -> 100, x (256, 800) f32, w (25, 10, "
                "16, 4)")
    for name, src_shape in (
            ("csd_spmm_fwd_small", t1_shape + ", bias + relu"),
            ("csd_spmm_dx_small", "MNIST_4J junction 100 -> 100 (the "
             "first junction runs no dx), g (256, 100) f32, w (25, 20, 4, "
             "4)"),
            ("csd_spmm_dw_small", t1_shape + ", with db")):
        rec = pick(name, **(table1 if name != "csd_spmm_dx_small" else dict(
            junction="mnist4j 100->100", m=MLP_BATCH, dtype="float32")))
        entries.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/" + (
                "csd_spmm_small_dw.cu" if name == "csd_spmm_dw_small"
                else "csd_spmm_small.cu"),
            replaces={"csd_spmm_fwd_small": "src/repro/kernels/csd_spmm.py:"
                      "385 (and :337, the expert-batched form)",
                      "csd_spmm_dx_small": "src/repro/kernels/csd_spmm.py:"
                      "539",
                      "csd_spmm_dw_small": "src/repro/kernels/csd_spmm.py:"
                      "679"}[name],
            launches=sum(r["launches"][name] for r in mlp_recs),
            launches_smoke=sum(r["launches"].get(name, 0)
                               for r in smoke_recs.values()),
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=src_shape, body=rec["plan"]["kernel"]))
    next(e for e in entries if e["name"] == "csd_mask_cotangent")[
        "launches_mlp"] = sum(r["launches"]["csd_mask_cotangent"]
                              for r in mlp_recs)
    # the int8 small-block form at the Table I junction's batch, f32 x, with
    # its launches in the paper MLPs' int8 evaluations (phase 3e) and the
    # smoke configurations' int8 serving (phase 3f)
    rec = pick("csd_spmm_fwd_quant_small", **table1)
    q_mlp = sum(r["int8"]["launches"].get("csd_spmm_fwd_quant_small", 0)
                for r in mlp_recs)
    q_smoke = sum(r["launches"].get("csd_spmm_fwd_quant_small", 0)
                  for r in smoke_recs.values())
    entries.append(dict(
        name="csd_spmm_fwd_quant_small", route="cuda",
        source="src/repro_torch/kernels/csrc/csd_spmm_small.cu",
        replaces="src/repro/kernels/csd_spmm.py:253 (and :295, the "
                 "expert-batched form)",
        launches=q_mlp + q_smoke, launches_mlp=q_mlp, launches_smoke=q_smoke,
        max_abs_err=rec["max_abs_err"], ms=rec["ms"],
        plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
        bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        shape="Table I junction 800 -> 100, x (256, 800) f32, w int8 (25, "
              "10, 16, 4), w_scale f32 (25, 10), bias + relu",
        body=rec["plan"]["kernel"]))
    entries.append(dict(
        name="csd_spmm_fwd_injected_alias", route="cuda",
        source="src/repro_torch/kernels/csrc/csd_spmm_fwd_injected_alias.cu",
        replaces="src/repro/analysis/grid_pass.py:342",
        launches=lint_rec["launches"]["csd_spmm_fwd_injected_alias"],
        launches_serve=sum(r["launches"]["csd_spmm_fwd_injected_alias"]
                           for r in (serve_rec, q_serve_rec, g_serve_rec,
                                     gq_serve_rec)) + sum(
            v[0]["launches"]["csd_spmm_fwd_injected_alias"]
            for v in dense.values()),
        launches_train=sum(r["launches"]["csd_spmm_fwd_injected_alias"]
                           for r in (train_rec, g_train_rec)),
        max_abs_err=inj_rec["max_abs_err"], ms=inj_rec["ms"],
        plain_ms=inj_rec["plain_ms"], bound_ms=inj_rec["bound_ms"],
        bound_by=inj_rec["bound_by"], library_ms=inj_rec["library_ms"],
        shape="lint self-test: x (256, 512) f32, w (4, 2, 128, 128), "
              "2 fan-in splits storing into y; launches counted around "
              "the lint phase (serving and training paths: 0)"))
    # paged decode above G 8 (the tensor-core form at granite-34b's 48
    # heads): granite-34b's decode (phase 5h) over bf16 pages; over int8
    # pages no serving phase runs it (granite-34b is served in bf16), so
    # its launches are the lint's (its dispatch pass steps granite-34b's
    # int8 decode on the card)
    for name, lrec, where in (
            ("paged_decode_attention_grouped", dense["5h"][0],
             "phase 5h (granite-34b served, bf16)"),
            ("paged_decode_attention_quant_grouped", lint_rec,
             "the lint's dispatch pass (granite-34b's int8 paged step on "
             "the card, 2 layers)")):
        rec = pick(name, model="granite-34b", dtype="bfloat16")
        entries.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces="src/repro/kernels/flash_attention.py:214",
            launches=lrec["launches"][name], launches_from=where,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            split_kernel=rec["split_kernel"],
            shape=f"q (4, 1, 48, 128) bf16, "
                  f"{'int8' if 'quant' in name else 'bf16'} pages, page 16, "
                  f"lengths [1100, 517, 0, 1040]; the tensor-core form, "
                  f"3 row tiles of 16 query heads"))
    # the dense decoders' serving launches of the forms they share with
    # the earlier models
    for e in entries:
        if e["name"] in ("csd_spmm_fwd", "paged_decode_attention",
                         "csd_spmm_fwd_quant",
                         "paged_decode_attention_quant"):
            e["launches_serve_dense"] = sum(
                v[0]["launches"][e["name"]] for v in dense.values())
    # the tensor-core form's launches in the serving runs (qwen2-7b's G 7
    # on paged_decode_attention, granite-34b's 48 on the grouped wrapper)
    for e in entries:
        if e["name"].startswith("paged_decode_attention"):
            e["launches_serve_mma"] = sum(
                r["paged_forms"]["paged_decode_mma_kernel"]
                for r in [serve_rec, q_serve_rec, g_serve_rec, gq_serve_rec]
                + [v[0] for v in dense.values()]
                if r["launches"][e["name"]])
    entries[0]["launches_serve"] = serve_rec["launches"]["csd_spmm_fwd"]
    next(e for e in entries if e["name"] == "csd_spmm_fwd_batched")[
        "launches_train"] = g_train_rec["launches"]["csd_spmm_fwd_batched"]
    for e in entries:  # phase 5s's spec-on runs, phase 3f's speculative runs
        if e["name"] in ("csd_spmm_fwd", "csd_spmm_fwd_quant",
                         "csd_spmm_fwd_batched", "paged_decode_attention",
                         "paged_decode_attention_quant"):
            e["launches_spec"] = sum(
                r["launches"].get(e["name"], 0) for v in spec_recs.values()
                for r in v["runs"] if r["spec_k"])
            e["launches_per_verify_step"] = {
                k: v["verify_check"]["launches_per_verify_step"].get(
                    e["name"], 0) for k, v in spec_recs.items()}
        if e["name"].endswith("_small") and "fwd" in e["name"]:
            e["launches_smoke_spec"] = sum(
                r["spec"]["launches"].get(e["name"], 0)
                for k, r in smoke_recs.items() if "spec" in r)
    for e in entries:  # the attention kernels in granite's training
        if e["name"] in ("flash_attention", "flash_attention_bwd"):
            e["launches_train_granite"] = g_train_rec["launches"][e["name"]]
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, cases=results,
             serve=serve_rec, logits_check=chk_rec, profile=prof_rec,
             serve_int8=q_serve_rec, logits_check_int8=q_chk_rec,
             profile_int8=q_prof_rec, top1_agreement_int8=agree_rec,
             granite_serve=g_serve_rec, granite_logits_check=g_chk_rec,
             granite_profile=g_prof_rec, granite_serve_int8=gq_serve_rec,
             granite_logits_check_int8=gq_chk_rec,
             granite_profile_int8=gq_prof_rec,
             granite_top1_agreement_int8=g_agree_rec,
             train_step_check=step_chk, train=train_rec,
             train_profile=train_prof, granite_train_step_check=g_step_chk,
             granite_train=g_train_rec, granite_train_profile=g_train_prof,
             checkpointing=ckpt_rec,
             sass=sass_rec, paged_registers=paged_regs,
             int8_decode_registers=stream_regs,
             small_gather_registers=small_regs, lint=lint_rec,
             plan_drift=drift_rec,
             nan_coverage=nan_rec,
             injected_alias=inj_rec, paper_mlp=mlp_recs,
             smoke_configs=smoke_recs, dense_decoders=dense_recs,
             examples=example_recs, spec=spec_recs, done_at_s=done_at,
             kernels=entries),
        indent=1))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"phase_done_at_s": done_at}))
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
