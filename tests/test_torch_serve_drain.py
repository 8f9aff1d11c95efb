"""``repro_torch.launch.serve.generate``'s drain guards, as the JAX
``generate`` has them: an engine whose step makes no progress raises
``RuntimeError("prefill failed to drain")`` after 10,000 prefill steps,
and one that drains its prefill but never finishes raises
``RuntimeError("engine failed to drain")`` after 100,000 steps."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.nn.model import LM
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import Scheduler


def _generate():
    cfg = get_config("mamba2_130m", smoke=True).with_(n_layers=1)
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4))
    return serve.generate(model, prompt, 8, 2, device="cpu")


def test_generate_raises_when_prefill_never_drains(monkeypatch):
    calls = []
    monkeypatch.setattr(ServingEngine, "step",
                        lambda self: calls.append(1) or (None, []))
    with pytest.raises(RuntimeError, match="^prefill failed to drain$"):
        _generate()
    assert len(calls) == 10_001


def test_generate_raises_when_the_engine_never_drains(monkeypatch):
    calls = []

    def stuck(self):  # drops the queue: no prefill left, nothing finishes
        calls.append(1)
        self.sched.waiting.clear()
        return None, []

    monkeypatch.setattr(ServingEngine, "step", stuck)
    monkeypatch.setattr(Scheduler, "has_work", lambda self: True)
    with pytest.raises(RuntimeError, match="^engine failed to drain$"):
        _generate()
    assert len(calls) == 1 + 100_001
