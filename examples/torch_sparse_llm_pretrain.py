"""Pretrain a ~100M-parameter LM with pre-defined sparse FFN junctions on
the PyTorch port (counterpart of ``examples/sparse_llm_pretrain.py``).

The paper's technique applied at LM scale: every FFN junction is a
block-sparse matrix of 64 x 64 blocks at densities (0.5, 0.75), trained
through the port's junction kernels (forward, backward-data and
backward-weights) on the card, with the full training path (AdamW,
gradient clipping, cosine schedule, checkpointing). ``--device cpu`` runs
the kernels' plain versions on the CPU.

    PYTHONPATH=src python examples/torch_sparse_llm_pretrain.py \\
        [--steps 300] [--dense] [--size full100m|small] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.data import BigramLM
from repro_torch.nn.common import ModelConfig, SparsityConfig, resolve_device
from repro_torch.nn.model import LM
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


def make_config(size: str, dense: bool) -> ModelConfig:
    sp = SparsityConfig(enabled=not dense, rho_ffn=(0.5, 0.75),
                        block_in=64, block_out=64)
    if size == "full100m":
        # ~100M params: 12L x d512 x ffn2048, 32k vocab
        return ModelConfig(
            name="sparse-llm-100m", n_layers=12, d_model=512, n_heads=8,
            n_kv_heads=4, d_ff=2048, vocab_size=32768, sparsity=sp,
            loss_chunk=256, dtype="float32", remat=False)
    return ModelConfig(
        name="sparse-llm-small", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab_size=2048, sparsity=sp,
        loss_chunk=128, dtype="float32", remat=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--size", default="small",
                    choices=["small", "full100m"])
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = make_config(args.size, args.dense)
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name}  params={n / 1e6:.1f}M  "
          f"sparsity={'off' if args.dense else cfg.sparsity.rho_ffn}")

    tc = TrainerConfig(
        opt=AdamWConfig(lr=6e-4, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps, weight_decay=0.05),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=max(args.steps // 4, 1),
        log_every=max(args.steps // 20, 1))
    trainer = Trainer(model, tc, device=device)
    data = BigramLM(vocab_size=cfg.vocab_size, branching=8, noise=0.05,
                    seed=0)
    start = (trainer.ckpt.latest_step() or 0) if trainer.ckpt else 0
    t0 = time.perf_counter()
    _, _, hist = trainer.fit(
        data.iterate(args.batch, args.seq, start_step=start),
        steps=args.steps,
        on_step=lambda s, m: print(
            f"step {s:5d}  loss {m['loss']:.4f}  "
            f"gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}", flush=True))
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not hist:
        print(f"done: {args.checkpoint_dir} already holds step {start}")
        return
    toks = (args.steps - start) * args.batch * args.seq
    print(f"done: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({toks / dt:.0f} tok/s on {device})")


if __name__ == "__main__":
    main()
