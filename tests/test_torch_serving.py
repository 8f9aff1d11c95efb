"""The port's serving engine against the JAX package's engine: identical
greedy tokens for mixed-length requests, with and without preemption."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn import build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.nn.model import LM
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineConfig, ServingEngine

N_NEW = 8
# total_pages=7 cannot hold the three sequences at once (4 + 5 + 4 pages),
# so the scheduler has to preempt and recompute
POOLS = {"roomy": 24, "preempting": 7}


# two layers of gemma3's pattern are both local (windowed), so the engines
# also reclaim pages that every window has left
N_LAYERS = 2


@pytest.mark.parametrize("pool", list(POOLS))
def test_greedy_tokens_match_reference_engine(pool):
    jcfg = jax_get_config("gemma3_4b", smoke=True).with_(n_layers=N_LAYERS)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.key(1))
    tmodel = LM(get_config("gemma3_4b", smoke=True).with_(n_layers=N_LAYERS),
                device="cpu", generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), tmodel),
        strict=False)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 5)]
    knobs = dict(max_slots=3, page_size=4, total_pages=POOLS[pool],
                 max_pages_per_seq=6, token_budget=8, prefill_chunk=8)
    ref_eng = JaxServingEngine(jmodel, params,
                               JaxEngineConfig(backend="xla", **knobs))
    ref = ref_eng.run(prompts, N_NEW)
    eng = ServingEngine(tmodel, EngineConfig(**knobs), device="cpu")
    got = []
    for i, p in enumerate(prompts):
        eng.add_request(p, N_NEW, req_id=i)
    while eng.sched.has_work():
        eng.step()
        eng.sched.check_invariants()
    got = [eng.outputs[i] for i in range(len(prompts))]
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    assert eng.sched.stats["preempted"] == ref_eng.sched.stats["preempted"]
    assert (eng.sched.stats["preempted"] > 0) == (pool == "preempting")
    assert eng.sched.stats["reclaimed_pages"] \
        == ref_eng.sched.stats["reclaimed_pages"] > 0


def test_engine_defaults_to_the_card(monkeypatch):
    """Without ``device=`` the engine runs on the card, and where there is
    none it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = LM(get_config("gemma3_4b", smoke=True).with_(n_layers=1),
               device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine_mod.resolve_device(None)
    assert engine_mod.resolve_device("cpu") == torch.device("cpu")


def _small_model(n_layers=2):
    return LM(get_config("gemma3_4b", smoke=True).with_(n_layers=n_layers),
              device="cpu", generator=torch.Generator().manual_seed(0))


def test_sampled_decode_is_reproducible_per_seed():
    """Sampling draws from one stream per (seed, request, position)."""
    model = _small_model()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (6, 9, 4)]

    def run(seed):
        eng = ServingEngine(model, EngineConfig(
            max_slots=3, page_size=4, total_pages=24, max_pages_per_seq=6,
            token_budget=8, prefill_chunk=8, greedy=False, temperature=0.8),
            device="cpu", seed=seed)
        return [o.tolist() for o in eng.run(prompts, 6)]

    first = run(3)
    assert run(3) == first
    assert run(4) != first
    assert all(0 <= t < 512 for row in first for t in row)


def test_generate_matches_engine_greedy_tokens():
    from repro_torch.launch.serve import generate
    model = _small_model()
    prompt = np.random.default_rng(6).integers(0, 512, (2, 5))
    toks, tps = generate(model, prompt, 12, 4, device="cpu")
    eng = ServingEngine(model, EngineConfig(
        max_slots=2, page_size=4, total_pages=8, max_pages_per_seq=4),
        device="cpu")
    assert toks.tolist() == [o.tolist() for o in eng.run(list(prompt), 4)]
    assert tps > 0
