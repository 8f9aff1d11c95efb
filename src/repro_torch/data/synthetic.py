"""Deterministic, resumable synthetic data (port of ``repro.data.synthetic``).

``BigramLM``: tokens follow a fixed random bigram transition table with
noise, a learnable distribution. Every batch is a pure function of
(seed, step), made with numpy exactly as the JAX package makes it, so the
two packages train on identical batches.

``synthetic_mnist`` and ``synthetic_features``: the procedural stand-ins
for the paper's MLP datasets (MNIST, and Reuters/TIMIT), numpy copies of
the JAX package's that give its arrays bit for bit from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class BigramLM:
    vocab_size: int = 1024
    branching: int = 8         # candidate successors per token
    noise: float = 0.05        # probability of a uniform-random token
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.table = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branching))

    def batch(self, step: int, batch_size: int, seq_len: int,
              process_index: int = 0, process_count: int = 1) -> dict:
        """Global batch ``step``, sliced for this process: {"tokens",
        "labels"}, (batch_size / process_count, seq_len) int32 numpy."""
        if batch_size % process_count:
            raise ValueError("batch_size must divide over the processes")
        local = batch_size // process_count
        rng = np.random.default_rng((self.seed, step, process_index))
        tokens = np.empty((local, seq_len + 1), np.int32)
        tokens[:, 0] = rng.integers(0, self.vocab_size, local)
        choice = rng.integers(0, self.branching, (local, seq_len))
        noise_mask = rng.random((local, seq_len)) < self.noise
        noise_tok = rng.integers(0, self.vocab_size, (local, seq_len))
        for t in range(seq_len):
            nxt = self.table[tokens[:, t], choice[:, t]]
            tokens[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t],
                                        nxt)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def iterate(self, batch_size: int, seq_len: int, start_step: int = 0,
                process_index: int = 0, process_count: int = 1
                ) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, batch_size, seq_len, process_index,
                             process_count)
            step += 1


def _smooth_field(rng: np.random.Generator, side: int, cutoff: int
                  ) -> np.ndarray:
    """Low-frequency random image via truncated DCT-like basis."""
    coef = rng.normal(size=(cutoff, cutoff))
    xs = np.arange(side)
    basis = np.stack([np.cos(np.pi * (xs + 0.5) * k / side)
                      for k in range(cutoff)])  # (cutoff, side)
    img = basis.T @ coef @ basis
    img = (img - img.min()) / (np.ptp(img) + 1e-9)
    return img


def synthetic_mnist(
    n_train: int = 8000,
    n_test: int = 2000,
    n_classes: int = 10,
    side: int = 28,
    pad_to: int = 800,
    noise: float = 0.35,
    max_shift: int = 2,
    seed: int = 0,
    n_features: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x_train, y_train, x_test, y_test): class prototypes from a seeded
    low-frequency random field, shifted by up to ``max_shift`` pixels, plus
    pixel noise; features in [0, 1.5], zero-padded to ``pad_to`` (the
    paper's footnote 8). ``n_features`` crops after flattening (the
    reduced-redundancy experiments, paper section IV-C)."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_smooth_field(rng, side, 6) for _ in range(n_classes)])

    def make(n, rng):
        y = rng.integers(0, n_classes, n)
        imgs = protos[y].copy()
        sx = rng.integers(-max_shift, max_shift + 1, n)
        sy = rng.integers(-max_shift, max_shift + 1, n)
        for i in range(n):
            imgs[i] = np.roll(np.roll(imgs[i], sx[i], 0), sy[i], 1)
        imgs += noise * rng.normal(size=imgs.shape)
        x = imgs.reshape(n, side * side).astype(np.float32)
        x = np.clip(x, 0.0, 1.5)
        if n_features is not None:
            x = x[:, :n_features]
        elif pad_to > x.shape[1]:
            x = np.pad(x, ((0, 0), (0, pad_to - x.shape[1])))
        return x, y.astype(np.int32)

    x_tr, y_tr = make(n_train, np.random.default_rng(seed + 1))
    x_te, y_te = make(n_test, np.random.default_rng(seed + 2))
    return x_tr, y_tr, x_te, y_te


def synthetic_features(
    n_train: int = 8000,
    n_test: int = 2000,
    n_classes: int = 50,
    n_features: int = 2000,
    informative: int = 60,
    noise: float = 1.0,
    seed: int = 0,
    redundancy: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reuters/TIMIT-style stand-in: class means live in an
    ``informative``-dim subspace, expanded through a random mixing matrix
    that keeps about ``redundancy`` of every ``informative`` entries (how
    spread the information is: the knob of the section IV-C experiments)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n_classes, informative)) * 2.0
    mix = rng.normal(size=(informative, n_features)) / np.sqrt(informative)
    keep = rng.random((informative, n_features)) < (redundancy / informative)
    mix = mix * keep

    def make(n, rng):
        y = rng.integers(0, n_classes, n)
        z = means[y] + rng.normal(size=(n, informative)) * noise
        x = z @ mix + 0.1 * rng.normal(size=(n, n_features))
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = make(n_train, np.random.default_rng(seed + 1))
    x_te, y_te = make(n_test, np.random.default_rng(seed + 2))
    return x_tr, y_tr, x_te, y_te
