"""Deterministic, resumable synthetic data (port of ``repro.data.synthetic``).

``BigramLM``: tokens follow a fixed random bigram transition table with
noise, a learnable distribution. Every batch is a pure function of
(seed, step), made with numpy exactly as the JAX package makes it, so the
two packages train on identical batches. ``synthetic_mnist`` arrives with
the paper-MLP slice.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

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
