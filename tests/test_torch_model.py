"""The port's LM against the JAX package's LM, through one paged serving
step sequence (a prefill chunk, then single-token decodes), with the JAX
parameters moved over by ``repro_torch.convert.from_jax_params``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn import build_model
from repro.serving import kv_cache as jax_kv
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.nn.model import LM, layer_seeds

TOL = 1e-4  # f32 end to end; sums taken in another order than XLA's

# 14 layers of gemma3's 5 local : 1 global = two scanned groups of six plus
# two epilogue layers, so both seed rules and the unstacking are exercised
N_LAYERS = 14


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_config_matches_reference(smoke):
    ref = jax_get_config("gemma3_4b", smoke=smoke)
    got = get_config("gemma3_4b", smoke=smoke)
    for f in dataclasses.fields(got):
        want = getattr(ref, f.name)
        if f.name == "sparsity":
            for g in dataclasses.fields(want.__class__):
                if hasattr(got.sparsity, g.name):
                    assert getattr(got.sparsity, g.name) == getattr(want, g.name)
        else:
            assert getattr(got, f.name) == want, f.name
    assert got.layer_kinds == ref.layer_kinds


def test_layer_seeds_match_reference_stack():
    cfg = jax_get_config("gemma3_4b").with_(n_layers=N_LAYERS)
    stack = build_model(cfg).stack
    assert stack.n_groups == 2 and len(stack.epilogue) == 2
    assert layer_seeds(cfg.layer_kinds)[:6] == [1, 11, 21, 31, 41, 51]
    assert layer_seeds(cfg.layer_kinds)[12:] == [2000, 2010]
    full = jax_get_config("gemma3_4b")
    assert layer_seeds(full.layer_kinds)[30:] == [2000, 2010, 2020, 2030]


def test_paged_step_logits_match_reference():
    jcfg = jax_get_config("gemma3_4b", smoke=True).with_(n_layers=N_LAYERS)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tcfg = get_config("gemma3_4b", smoke=True).with_(n_layers=N_LAYERS)
    tmodel = LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    # every sparse junction got the reference's pattern
    for u, blk in enumerate(jmodel.stack.unit_blocks):
        for name in ("up", "gate", "down"):
            np.testing.assert_array_equal(
                getattr(tmodel.layers[6 + u].ffn, name).pattern.block_idx,
                getattr(blk.ffn, name).pattern.block_idx)
    tmodel.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), tmodel),
        strict=False)

    rng = np.random.default_rng(0)
    b, page, total_pages, per_seq = 2, 4, 10, 5
    prompt_lens = np.asarray([8, 5], np.int32)
    chunk = rng.integers(0, jcfg.vocab_size, (b, 8)).astype(np.int32)
    st = jax_kv.init_page_state(b, total_pages, per_seq)
    for i in range(b):
        st = jax_kv.alloc_pages(st, i, per_seq)
    table = np.array(st.page_table)
    jcache = jmodel.stack.init_paged_cache(b, total_pages, page, jnp.float32)
    tcache = tmodel.init_paged_cache(total_pages, page, torch.float32)

    jstep = jax.jit(functools.partial(jmodel.paged_step, backend="xla"))

    def step(tokens, pos, n_new):
        nonlocal jcache
        jl, jcache = jstep(
            params, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(n_new),
            jcache, jnp.asarray(table), jnp.arange(b, dtype=jnp.int32))
        tl = tmodel.paged_step(torch.from_numpy(tokens), torch.from_numpy(pos),
                               torch.from_numpy(n_new), tcache,
                               torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=TOL, rtol=TOL)
        return np.asarray(jl)

    logits = step(chunk, np.zeros(b, np.int32), prompt_lens)
    pos = prompt_lens.copy()
    for _ in range(4):
        tok = logits[:, 0].argmax(-1).astype(np.int32)[:, None]
        logits = step(tok, pos, np.ones(b, np.int32))
        pos += 1
