"""Training entry point (port of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch gemma3_4b --full --steps 4 \\
        --batch 2 --seq 2048

trains the published configuration from random weights (seed 0) on
``BigramLM`` batches on the card, printing each step's metrics; without
``--full`` it trains the smoke configuration. ``--device cpu`` runs the
plain versions of the kernels on the CPU.

Fault tolerance: with ``--checkpoint-dir`` the run resumes from the latest
committed checkpoint there (the data iterator restarts at its step) and
any ``RuntimeError`` (a lost device; ``--simulate-failure-at N`` raises one
after saving step N) restores the latest checkpoint and continues, at most
3 times. ``--diloco K`` runs the DiLoCo outer step every K steps (locally:
no pods), ``--profile-dir`` captures a torch.profiler Chrome trace of the
run and ``--metrics-jsonl`` appends the obs registry's events to a file.
The JAX CLI's ``--mesh`` waits for the multi-device slice.
"""
from __future__ import annotations

import argparse
import gc

import torch

MAX_RETRIES = 3  # restores after a failure before the error is raised


def train_with_restarts(trainer, make_iter, steps: int, *, fail_at: int = 0,
                        on_step=None, log=print):
    """``trainer.fit`` to ``steps`` from the latest committed checkpoint
    (``make_iter(start)`` gives the batches from step ``start``). With
    ``fail_at`` the first run stops after saving step ``fail_at`` and raises
    a ``RuntimeError``; with a checkpoint directory each ``RuntimeError`` is
    followed by a restore and resume, ``MAX_RETRIES`` times at most.
    Returns (params, opt, history) of the run that finished."""
    state = {"failed": False, "result": None}

    def run():
        start = (trainer.ckpt.latest_step() or 0) if trainer.ckpt else 0
        it = make_iter(start)
        if fail_at and not state["failed"] and start < fail_at <= steps:
            state["failed"] = True
            # run to the failure point, then raise like a lost device
            trainer.fit(it, fail_at, on_step=on_step, resume=True)
            raise RuntimeError("simulated device loss")
        state["result"] = trainer.fit(it, steps, on_step=on_step,
                                      resume=True)

    if trainer.ckpt is None:
        run()
        return state["result"]
    tries = 0
    while True:
        try:
            run()
            return state["result"]
        except RuntimeError as e:
            tries += 1
            log(f"[restart] {e} — resuming from checkpoint "
                f"(attempt {tries})")
            if tries > MAX_RETRIES:
                raise
        gc.collect()  # the failed run's optimizer state


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
    ap.add_argument("--diloco", type=int, default=0,
                    help="DiLoCo outer step every K steps (0: none)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--simulate-failure-at", type=int, default=0)
    ap.add_argument("--rho", type=float, default=None,
                    help="override FFN sparsity density (paper's rho)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the run here")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append obs registry events to this JSONL file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..data import BigramLM
    from ..nn.common import SparsityConfig, resolve_device
    from ..nn.model import LM
    from ..obs import get_registry
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
        grad_accum=args.grad_accum, log_every=1,
        diloco_period=args.diloco,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        profile_dir=args.profile_dir)
    trainer = Trainer(model, tc, device=device)
    data = BigramLM(vocab_size=cfg.vocab_size, seed=0)
    if args.metrics_jsonl:
        get_registry().set_jsonl(args.metrics_jsonl)
    try:
        params, opt, _ = train_with_restarts(
            trainer,
            lambda start: data.iterate(args.batch, args.seq,
                                       start_step=start),
            args.steps, fail_at=args.simulate_failure_at,
            on_step=lambda s, m: print(f"step {s}: {m}", flush=True),
            log=lambda msg: print(msg, flush=True))
    finally:
        if args.metrics_jsonl:
            get_registry().set_jsonl(None)
    print("training done", flush=True)
    return params, opt


if __name__ == "__main__":
    main()
