"""Serving driver: batched generation through the continuous-batching engine.

    python -m repro_torch.launch.serve --arch gemma3_4b --full

runs random-init weights (from ``--seed``) at the full configuration on the
card; without ``--full`` it serves the smoke configuration. ``--device cpu``
runs the plain versions of the kernels on the CPU. The model is built in
its compute dtype (bf16 at full width: the values of an f32 build cast
once), so ``--full`` serves on one 80 GB card

* ``--arch gemma3_4b``: ~2.8 B parameters, ~5.6 GB;
* ``--arch gemma2_9b``: alternating 4096-window and global layers,
  attention softcap 50 and final softcap 30, ~6.5 B parameters, ~13 GB;
* ``--arch qwen2_7b``: QKV bias, untied head, 7 query heads a KV head, its
  FFN patterns dense at full width (coprime block counts), ~7.6 B, ~15 GB;
* ``--arch granite_34b``: 88 layers, 48 query heads over one KV head (the
  grouped form of the paged decode kernel), untied head, ~29.5 B, ~59 GB
  (its f32 parameters, ~118 GB, would not fit);
* ``--arch mamba2_130m``: 24 Mamba2 layers, no attention, 0.129 B
  parameters, ~0.26 GB, 19.4 MB of f32 SSM state a slot;
* ``--arch zamba2_1p2b``: 38 Mamba2 layers and a shared attention block
  applied after every 6 (6 page pools), 1.130 B, ~2.26 GB, 41.8 MB of SSM
  state a slot.

Served with 4 slots on an NVIDIA H100 80GB HBM3 (``chip_smoke.py`` phases
5k and 5l) the two peaked at 0.52 and 2.87 GB of device memory.

``--arch granite_moe_1b_a400m`` and ``--arch deepseek_moe_16b`` (28
layers, a dense layer 0, 64 routed experts top-6 and 2 shared experts,
~11.2 B parameters at the card's 64 x 64 blocks, ~16.4 B at the published
dense ones) are accepted, but their published expert capacity
(``capacity_factor`` 1.25) is not dropless, so the engine refuses them;
the JAX CLI falls back to its dense-cache loop there, which is not
ported. ``chip_smoke.py`` serves both at the dropless capacity
(``n_routed / top_k``) with the blocks their ``card_config`` sets.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..serving.engine import EngineConfig, ServingEngine, resolve_device


def generate(model, prompt, s_max: int, steps: int, *, greedy: bool = True,
             device=None, page_size: int = 16, seed: int = 0):
    """Batched generation through ``ServingEngine``; returns
    (tokens (B, steps) int32 array, tokens/s). The rate covers the tokens
    decoded after every prompt has been prefilled. Raises RuntimeError if
    the prefill has not drained after 10,000 steps or the engine after
    100,000 more."""
    prompt = np.asarray(prompt, np.int32)
    b, prompt_len = prompt.shape
    pages_per_seq = -(-s_max // page_size)
    eng = ServingEngine(
        model,
        EngineConfig(max_slots=b, page_size=page_size,
                     total_pages=b * pages_per_seq,
                     max_pages_per_seq=pages_per_seq,
                     token_budget=b + max(prompt_len, 1),
                     prefill_chunk=64, greedy=greedy),
        device=device, seed=seed)
    for i in range(b):
        eng.add_request(prompt[i], steps, req_id=i)
    guard = 0
    while any(s is not None and s.prefilling for s in eng.sched.active) \
            or eng.sched.waiting:
        eng.step()
        guard += 1
        if guard > 10_000:
            raise RuntimeError("prefill failed to drain")
    # tokens decoded while other rows were still prefilling are not timed
    pre = sum(len(o) for o in eng.outputs.values()) \
        + sum(s.n_generated for s in eng.sched.active if s is not None)
    _sync(eng.device)
    t0 = time.perf_counter()
    steps_run = 0
    while eng.sched.has_work():
        eng.step()
        steps_run += 1
        if steps_run > 100_000:
            raise RuntimeError("engine failed to drain")
    _sync(eng.device)
    dt = time.perf_counter() - t0
    toks = np.stack([eng.outputs[i] for i in range(b)])
    return toks, max(b * steps - pre, 0) / max(dt, 1e-9)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from ..configs import get_config
    from ..nn.model import LM

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    cfg = cfg.with_(param_dtype=cfg.dtype)  # what the engine serves in
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = LM(cfg, device=device, generator=gen)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    toks, tps = generate(model, prompt, args.prompt_len + args.gen, args.gen,
                         device=device, seed=args.seed)
    print(f"generated {toks.shape} tokens at {tps:.1f} tok/s on {device}")
    print(toks[0])


if __name__ == "__main__":
    main()
