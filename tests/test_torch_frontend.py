"""llava-next-34b (a stub-frontend LM) on the port against the JAX package
on the CPU, and ``generate``'s fallback to the dense-cache loop.

The configuration field for field and the full-width junction patterns; on
the smoke configuration (4 layers, G 2, f32) with the JAX parameters moved
over by ``repro_torch.convert.from_jax_params`` (the projector ``proj_in``
and ``proj_mid`` and the untied head among them): every layer seed and
junction pattern against the JAX ``LM``, the prefill logits from the
frontend's embeddings and the caches, 8 teacher-forced ``decode_step``s
(the first from frontend embeddings, the rest from token ids), and
``generate_cached``'s greedy tokens. ``generate`` serves granite-moe's
smoke configuration at its own capacity factor 1.5 (not dropless, which
the engine refuses) through the dense-cache loop: its greedy tokens equal
the JAX ``generate``'s, which falls back the same way. The JAX junctions
run on their XLA backend, the plain reference of the Pallas kernels."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.block_pattern import fit_block_pattern as jax_fit
from repro.launch.serve import generate as jax_generate
from repro.launch.serve import generate_cached as jax_generate_cached
from repro.nn import build_model as jax_build_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.block_pattern import fit_block_pattern
from repro_torch.launch.serve import (generate, generate_cached,
                                      needs_dense_loop)
from repro_torch.nn.model import build_model, layer_seeds
from repro_torch.serving.engine import ServingEngine

ARCH = "llava_next_34b"
BATCH, PROMPT, S_MAX, N_DECODE = 2, 6, 16, 8
LOGIT_TOL = 1e-4    # logits, of max |JAX| (tests/test_torch_model.py)
CACHE_TOL = 1e-5    # the caches, of max |JAX|

# the full-width FFN junctions: (n_in, n_out, rho, pattern seed: the scan
# slot's 1 + 11 up, + 12 gate, + 13 down) -> (n_lb, n_rb, fan-in)
FULL_JUNCTIONS = {
    "up": (7168, 20480, 0.5, 1 + 11, (28, 20, 14)),
    "gate": (7168, 20480, 0.5, 1 + 12, (28, 20, 14)),
    "down": (20480, 7168, 0.75, 1 + 13, (80, 7, 80)),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _models(arch=ARCH):
    """(JAX model, its parameters, the port's model with them)."""
    cfg = jax_get_config(arch, smoke=True)
    jmodel = jax_build_model(cfg.with_(sparsity=dataclasses.replace(
        cfg.sparsity, backend="xla")))
    params = jmodel.init(jax.random.key(0))
    tmodel = build_model(get_config(arch, smoke=True), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np(params), tmodel),
                           strict=False)
    return jmodel, params, tmodel


def _inputs():
    rng = np.random.default_rng(2)
    cfg = get_config(ARCH, smoke=True)
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(
            np.int32),
        embeds=rng.normal(size=(BATCH, PROMPT, cfg.frontend_dim)).astype(
            np.float32),
        step_embeds=rng.normal(size=(BATCH, 1, cfg.frontend_dim)).astype(
            np.float32),
        feed=rng.integers(0, cfg.vocab_size, (N_DECODE, BATCH, 1)).astype(
            np.int32))


def _feed(x, i, lib):
    """Decode step i's input: frontend embeddings at step 0, else ids."""
    return lib(x["step_embeds"] if i == 0 else x["feed"][i])


@functools.lru_cache(maxsize=None)
def _runs():
    """Prefill and N_DECODE teacher-forced decode steps of both models:
    {"jax"/"port": (prefill logits, caches after prefill, [decode
    logits])}."""
    jmodel, params, tmodel = _models()
    x = _inputs()
    jbatch = {"tokens": jnp.asarray(x["tokens"]),
              "embeds": jnp.asarray(x["embeds"])}
    logits, cache = jax.jit(
        lambda p, b: jmodel.prefill(p, b, S_MAX))(params, jbatch)
    jcache = _np(cache["layers"])
    step = jax.jit(jmodel.decode_step)
    jdec = []
    for i in range(N_DECODE):
        lg, cache = step(params, _feed(x, i, jnp.asarray), cache)
        jdec.append(np.asarray(lg))
    tlogits, tcache = tmodel.prefill(
        {k: torch.from_numpy(x[k]) for k in ("tokens", "embeds")}, S_MAX)
    tcache0 = [{n: t.clone().numpy() for n, t in c["self"].items()}
               for c in tcache["layers"]]
    tdec = [tmodel.decode_step(_feed(x, i, torch.from_numpy), tcache)[0]
            .numpy() for i in range(N_DECODE)]
    return {"jax": (np.asarray(logits), jcache, jdec),
            "port": (tlogits.numpy(), tcache0, tdec)}


# ---------------------------------------------------------------------------
# configuration, seeds and patterns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_config_matches_reference(smoke):
    """Field for field, the sparsity config too; the JAX smoke config's
    ``attn_chunk`` has no field in the port."""
    assert ARCH in ARCHS
    ref = jax_get_config(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(got):
        want, have = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "sparsity":
            for g in dataclasses.fields(have):
                assert getattr(have, g.name) == getattr(want, g.name), g.name
        else:
            assert have == want, f.name
    assert got.input_mode == "embeddings" and needs_dense_loop(got)


@pytest.mark.parametrize("junction", list(FULL_JUNCTIONS))
def test_full_width_patterns_match_reference(junction):
    n_in, n_out, rho, seed, want = FULL_JUNCTIONS[junction]
    got = fit_block_pattern(n_in, n_out, rho, get_config(ARCH).sparsity,
                            seed=seed)
    ref = jax_fit(n_in, n_out, rho, jax_get_config(ARCH).sparsity,
                  seed=seed)
    np.testing.assert_array_equal(got.block_idx, ref.block_idx)
    assert (got.n_lb, got.n_rb, got.d_in_b) == want


def test_seeds_patterns_and_projector_match_reference():
    jmodel, _, tmodel = _models()
    stack = jmodel.stack
    assert (stack.unit_len, stack.n_groups) == (1, 4)
    assert layer_seeds(tmodel.cfg.layer_kinds) == [1] * 4
    for tblk in tmodel.layers:
        for j in ("up", "gate", "down"):
            np.testing.assert_array_equal(
                getattr(tblk.ffn, j).pattern.block_idx,
                getattr(stack.unit_blocks[0].ffn, j).pattern.block_idx)
        assert tblk.cross_attn is None
    cfg = tmodel.cfg
    assert (tmodel.proj_in.n_in, tmodel.proj_in.n_out) == (cfg.frontend_dim,
                                                           cfg.d_model)
    assert tmodel.proj_mid.bias is not None and not tmodel.proj_mid.is_sparse
    assert tmodel.head is not None


# ---------------------------------------------------------------------------
# prefill, caches, decode, greedy tokens
# ---------------------------------------------------------------------------


def test_prefill_logits_and_caches_match_reference():
    jlogits, jcache, _ = _runs()["jax"]
    tlogits, tcache, _ = _runs()["port"]
    assert tlogits.shape == jlogits.shape == (BATCH, 1, 512)
    assert _rel_err(tlogits, jlogits) <= LOGIT_TOL
    scan = jcache["scan"][0]["self"]
    assert len(tcache) == scan["k"].shape[0] == 4
    for g, c in enumerate(tcache):
        for n in ("k", "v"):
            assert c[n].shape[1] == 16 and not c[n][:, S_MAX:].any()
            assert _rel_err(c[n][:, :S_MAX], scan[n][g]) <= CACHE_TOL, (g, n)


def test_decode_steps_from_embeddings_and_tokens_match_reference():
    jdec = _runs()["jax"][2]
    tdec = _runs()["port"][2]
    for i, (got, want) in enumerate(zip(tdec, jdec)):
        assert got.shape == (BATCH, 1, 512)
        assert _rel_err(got, want) <= LOGIT_TOL, i


def test_generate_cached_greedy_tokens_match_reference():
    jmodel, params, tmodel = _models()
    x = _inputs()
    want, _ = jax_generate_cached(
        jmodel, params, jnp.asarray(x["tokens"]), S_MAX, 10,
        extra_batch={"embeds": jnp.asarray(x["embeds"])})
    got, _ = generate_cached(tmodel, x["tokens"], S_MAX, 10,
                             extra_batch={"embeds": x["embeds"]},
                             device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_frontend_model_has_no_paged_step():
    tmodel = _models()[2]
    with pytest.raises(NotImplementedError, match="token inputs"):
        tmodel.paged_step(torch.zeros((1, 1), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32), [], None)


def test_generate_falls_back_for_capacity_constrained_moe():
    """granite-moe's smoke config at its capacity 1.5 (top-2 of 8: not
    dropless): the engine refuses it, ``generate`` serves it through the
    dense-cache loop, with the JAX ``generate``'s greedy tokens."""
    arch = "granite_moe_1b_a400m"
    jmodel, params, tmodel = _models(arch)
    moe = tmodel.cfg.moe
    assert moe.capacity_factor * moe.top_k < moe.n_routed
    assert needs_dense_loop(tmodel.cfg)
    with pytest.raises(NotImplementedError, match="capacity"):
        ServingEngine(tmodel, device="cpu")
    prompt = np.random.default_rng(4).integers(
        0, tmodel.cfg.vocab_size, (BATCH, 7)).astype(np.int32)
    want, _ = jax_generate(jmodel, params, jnp.asarray(prompt), 20, 12)
    got, _ = generate(tmodel, prompt, 20, 12, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
