"""End-to-end example #3 on the PyTorch port: continuous-batching serving
(counterpart of ``examples/serve_batched.py``).

Builds a smoke-scale architecture of the port and serves a batch of
*mixed-length* prompts through ``repro_torch.serving.ServingEngine``:
chunked prefill interleaves with decode under a per-step token budget, KV
lives in a paged cache, and short requests finish (and free their pages)
while long ones are still decoding. On the card every FFN junction runs the
small-block junction kernel and every decode step the paged decode kernel;
``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples/torch_serve_batched.py --arch gemma3-4b \
        [--batch 4 --prompt-len 32 --gen 24 --sample --device cpu]

``--no-engine`` runs the legacy dense-cache loop instead
(``repro_torch.launch.serve.generate_cached``: one prefill, then one
decode step a token over per-request caches), and so do the architectures
that only that loop serves: the stub-frontend (llava-next-34b, its prompt
the frontend's embeddings) and encoder-decoder (seamless-m4t-medium, frames
for its encoder) ones and capacity-constrained MoE (granite-moe-1b-a400m at
its own capacity factor).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import generate_cached, needs_dense_loop
from repro_torch.nn.common import resolve_device
from repro_torch.nn.model import build_model
from repro_torch.serving.engine import EngineConfig, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="longest prompt; engine mode mixes lengths "
                         "down to prompt-len/4")
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--no-engine", action="store_true",
                    help="legacy dense-cache loop (A/B baseline)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--token-budget", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=True)
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(0))
    rng = np.random.default_rng(0)

    legacy_only = needs_dense_loop(cfg)
    if args.no_engine or legacy_only:
        if legacy_only and not args.no_engine:
            print(f"{args.arch}: stub-frontend/enc-dec/capacity-"
                  f"constrained MoE — legacy path")
        prompt = rng.integers(0, cfg.vocab_size,
                              (args.batch, args.prompt_len))
        extra = None
        if cfg.input_mode == "embeddings":
            extra = {"embeds": rng.normal(size=(
                args.batch, args.prompt_len, cfg.frontend_dim)).astype(
                    np.float32)}
        toks, tps = generate_cached(
            model, prompt, args.prompt_len + args.gen, args.gen,
            greedy=not args.sample, seed=1, extra_batch=extra,
            device=device)
        print(f"{args.arch} [legacy]: {toks.shape[1]} tokens x "
              f"{toks.shape[0]} sequences at {tps:.1f} tok/s")
        for i in range(min(2, args.batch)):
            print(f"  seq{i}: {toks[i][:16]} ...")
        return

    # mixed prompt lengths: the whole point of continuous batching
    lens = [max(4, args.prompt_len * (i % 4 + 1) // 4)
            for i in range(args.batch)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    pages_per_seq = -(-(max(lens) + args.gen) // args.page_size)
    eng = ServingEngine(
        model,
        EngineConfig(max_slots=min(args.batch, 8),
                     page_size=args.page_size,
                     total_pages=args.batch * pages_per_seq,
                     max_pages_per_seq=pages_per_seq,
                     token_budget=args.token_budget,
                     prefill_chunk=32, greedy=not args.sample),
        device=device, seed=1)
    # the port's engine keeps no metrics registry: time to first token is
    # read off the steps here
    ids = [eng.add_request(p, args.gen) for p in prompts]
    t0 = time.time()
    ttft = {}
    while eng.sched.has_work():
        eng.step()
        now = time.time()
        for s in eng.sched.active:
            if s is not None and s.n_generated >= 1:
                ttft.setdefault(s.req.req_id, now - t0)
        for rid in eng.outputs:
            ttft.setdefault(rid, now - t0)
    dt = time.time() - t0
    outs = [eng.outputs.pop(i) for i in ids]
    n_tok = sum(len(o) for o in outs)
    print(f"{args.arch} [engine]: {n_tok} tokens over {args.batch} "
          f"requests (prompt lens {lens}) at {n_tok / dt:.1f} tok/s; "
          f"stats={eng.sched.stats}")
    if ttft:
        print(f"  mean time-to-first-token: "
              f"{1e3 * sum(ttft.values()) / len(ttft):.1f} ms")
    for i in range(min(2, args.batch)):
        print(f"  req{i} (len {lens[i]}): {outs[i][:16]} ...")


if __name__ == "__main__":
    main()
