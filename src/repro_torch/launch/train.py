"""Training entry point (port of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch gemma3_4b --full --steps 4 \\
        --batch 2 --seq 2048

trains the published configuration from random weights (seed 0) on
``BigramLM`` batches on the card, printing each step's metrics; without
``--full`` it trains the smoke configuration. ``--device cpu`` runs the
plain versions of the kernels on the CPU. The JAX CLI's mesh, DiLoCo,
checkpoint and restart options are not ported yet.
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="the published configuration")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--rho", type=float, default=None,
                    help="override FFN sparsity density (paper's rho)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..data import BigramLM
    from ..nn.common import SparsityConfig, resolve_device
    from ..nn.model import LM
    from ..optim import AdamWConfig
    from ..train import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    if args.rho is not None:
        sp = cfg.sparsity
        cfg = cfg.with_(sparsity=SparsityConfig(
            enabled=args.rho < 1.0,
            rho_ffn=(args.rho, min(1.0, args.rho * 1.5)),
            block_in=sp.block_in, block_out=sp.block_out))
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))
    tc = TrainerConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps),
        grad_accum=args.grad_accum, log_every=1)
    trainer = Trainer(model, tc, device=device)
    data = BigramLM(vocab_size=cfg.vocab_size, seed=0)
    trainer.fit(data.iterate(args.batch, args.seq), args.steps,
                on_step=lambda s, m: print(f"step {s}: {m}", flush=True))
    print("training done", flush=True)


if __name__ == "__main__":
    main()
