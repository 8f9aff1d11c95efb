"""Serving entry point: batched generation through the continuous-batching
engine, or the dense-cache loop where the engine cannot serve the model.

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
  state a slot;
* ``--arch seamless_m4t_medium``: an encoder-decoder of 12 + 12 layers
  reading stub frontend frames (``--enc-len`` of them, 1024 wide; the
  decoder prompt is ``--prompt-len`` tokens), 0.565 B parameters (0.262 B
  the tied 256,206-token embedding), ~1.13 GB;
* ``--arch llava_next_34b``: 60 layers, 56 query heads over 8 KV heads,
  the prompt ``--prompt-len`` stub patch embeddings (1024 wide) through
  the projector, 25.64 B parameters, ~51.3 GB.

On an NVIDIA H100 80GB HBM3 at 700.00 W, served 4 requests each
(``chip_smoke.py`` phases 5k, 5l, 5n and 5o), mamba2-130m and zamba2-1.2b
peaked at 0.52 and 2.87 GB of device memory, seamless-m4t-medium (750
frames, 32 new tokens) at 1.53 GB and llava-next-34b (576 patches, 16 new
tokens) at 52.54 GB.

``generate`` serves through the engine; like the JAX ``generate`` it falls
back to ``generate_cached``, the dense-cache loop (``prefill``, then one
``decode_step`` a token over per-request caches), for encoder-decoders,
stub-frontend (``input_mode="embeddings"``) models and MoE models whose
expert capacity is not dropless (``capacity_factor * top_k < n_routed``:
granite-moe-1b-a400m and deepseek-moe-16b at their published 1.25, which
the engine refuses). Greedy tokens are the JAX loop's; sampled tokens are
drawn from a ``torch.Generator`` of the seed and differ from the JAX
package's ``jax.random`` draws.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..nn.common import dtype_of
from ..serving.engine import (EngineConfig, ServingEngine, load,
                              resolve_device)


def _pick(logits: torch.Tensor, greedy: bool,
          gen: Optional[torch.Generator]) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32 tokens: the argmax, or a draw."""
    if greedy:
        return logits.argmax(-1).to(torch.int32)
    probs = torch.softmax(logits[:, 0].float(), dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


def generate_cached(model, prompt, s_max: int, steps: int, *,
                    greedy: bool = True, seed: int = 0,
                    extra_batch: Optional[dict] = None, device=None):
    """Batched generation through the dense-cache loop (port of the JAX
    ``generate_cached``): the model moved to ``device`` in its compute
    dtype (``serving.engine.load``), one ``prefill`` of the prompt (B, P)
    int (with ``extra_batch``: a stub frontend's {"embeds"}), then
    ``steps - 1`` ``decode_step``s; returns (tokens (B, steps) int32
    array, tokens/s over the decode loop)."""
    device = resolve_device(device)
    model = load(model, device, dtype_of(model.cfg))
    batch = {"tokens": torch.as_tensor(np.asarray(prompt, np.int32),
                                       device=device)}
    for k, v in (extra_batch or {}).items():
        batch[k] = torch.as_tensor(np.asarray(v), device=device)
    gen = None if greedy else torch.Generator(device=device).manual_seed(
        seed)
    b = batch["tokens"].shape[0]
    with torch.no_grad():
        logits, cache = model.prefill(batch, s_max)
        tok = _pick(logits, greedy, gen)
        out = [tok]
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            logits, cache = model.decode_step(tok, cache)
            tok = _pick(logits, greedy, gen)
            out.append(tok)
        toks = torch.cat(out, dim=1).cpu().numpy()
        _sync(device)
    dt = time.perf_counter() - t0
    return toks, b * max(steps - 1, 1) / max(dt, 1e-9)


def needs_dense_loop(cfg) -> bool:
    """Whether ``generate`` serves ``cfg`` through ``generate_cached``, as
    the JAX ``generate`` does: an encoder-decoder, a stub frontend, or MoE
    with a finite expert capacity (which the engine refuses)."""
    moe = cfg.moe
    return cfg.enc_dec is not None or cfg.input_mode != "tokens" or (
        moe is not None and moe.capacity_factor * moe.top_k < moe.n_routed)


def generate(model, prompt, s_max: int, steps: int, *, greedy: bool = True,
             device=None, page_size: int = 16, seed: int = 0,
             extra_batch: Optional[dict] = None):
    """Batched generation through ``ServingEngine``; returns
    (tokens (B, steps) int32 array, tokens/s). The rate covers the tokens
    decoded after every prompt has been prefilled. Falls back to
    ``generate_cached`` where ``extra_batch`` is given or
    ``needs_dense_loop``. Raises RuntimeError if the prefill has not
    drained after 10,000 steps or the engine after 100,000 more."""
    if extra_batch or needs_dense_loop(model.cfg):
        return generate_cached(model, prompt, s_max, steps, greedy=greedy,
                               seed=seed, extra_batch=extra_batch,
                               device=device)
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
    ap.add_argument("--enc-len", type=int, default=None,
                    help="encoder frames for enc-dec archs "
                         "(default: --prompt-len)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from ..configs import get_config
    from ..nn.model import build_model

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    cfg = cfg.with_(param_dtype=cfg.dtype)  # what the model serves in
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, device=device, generator=gen)
    rng = np.random.default_rng(args.seed)
    # the decoder prompt (text tokens); for an enc-dec arch it seeds the
    # decoder while the stub frontend's frames feed the encoder
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))

    def frames(length):
        return rng.normal(size=(args.batch, length,
                                cfg.frontend_dim)).astype(np.float32)

    extra = None
    if cfg.enc_dec is not None:
        extra = {"embeds": frames(args.enc_len or args.prompt_len)}
    elif cfg.input_mode == "embeddings":
        # the prefill reads embeddings over the prompt's span; decode
        # embeds the generated text tokens
        extra = {"embeds": frames(args.prompt_len)}
    toks, tps = generate(model, prompt, args.prompt_len + args.gen, args.gen,
                         device=device, seed=args.seed, extra_batch=extra)
    print(f"generated {toks.shape} tokens at {tps:.1f} tok/s on {device}")
    print(toks[0])


if __name__ == "__main__":
    main()
