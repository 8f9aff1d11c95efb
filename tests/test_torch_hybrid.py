"""mamba2-130m and zamba2-1.2b on the port against the JAX package on the
CPU.

The configurations field for field and the full-width junction patterns;
on both smoke configurations (mamba2: 4 mamba layers; zamba2: 2 groups of
2 mamba layers, each followed by the shared attention block, and one
epilogue layer) with the JAX parameters moved over by
``repro_torch.convert.from_jax_params``: every layer seed and junction
pattern against the JAX ``Stack`` (zamba2's epilogue and shared block
included), the forward logits, the loss and every gradient, 13 paged
steps (a prefill chunk, then 12 greedy decodes), a step on a subset of the
slots through ``slot_ids``, the engine's greedy tokens with preemption and
slot reuse, the clamp of ``spec_k`` and the window-reclaim rule, and a
``quantize_tree``d zamba2 tree loaded bit for bit into a
``quantize_model``d model with its int8 paged logits. The JAX junctions
run on their XLA backend, the plain reference of the Pallas kernels."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import quant as jquant
from repro.core.block_pattern import fit_block_pattern as jax_fit
from repro.data import BigramLM as JaxBigramLM
from repro.nn import build_model
from repro.nn.transformer import MambaLayer as JaxMambaLayer
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import kv_cache as jax_kv
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.block_pattern import fit_block_pattern
from repro_torch.core.quant import quantize_model
from repro_torch.nn.model import LM, layer_seeds, repeat_unit
from repro_torch.nn.transformer import MambaLayer
from repro_torch.serving.engine import EngineConfig, ServingEngine

HYBRID = ("mamba2_130m", "zamba2_1p2b")
SEQ, BATCH = 48, 2
LOGIT_TOL = 1e-4   # f32 end to end (tests/test_torch_model.py)
LOSS_RTOL = 1e-5   # tests/test_torch_train.py
GRAD_TOL = 1e-4    # each gradient, relative to max |JAX|

# the full-width junctions: (arch, n_in, n_out, rho, pattern seed: the
# first scan slot's block seed 1, +21/+22 the mixer's in/out_proj; the
# shared block's seed 501, +11/+13 its FFN) and (n_lb, n_rb, block_in,
# block_out, fan-in), or None for a dense junction
FULL_JUNCTIONS = {
    "mamba2-in_proj": ("mamba2_130m", 768, 3352, 0.5, 1 + 21, None),
    "mamba2-out_proj": ("mamba2_130m", 1536, 768, 0.75, 1 + 22,
                        (6, 1, 256, 768, 6)),
    "zamba2-in_proj": ("zamba2_1p2b", 2048, 8384, 0.5, 1 + 21,
                       (8, 131, 256, 64, 8)),
    "zamba2-out_proj": ("zamba2_1p2b", 4096, 2048, 0.75, 1 + 22,
                        (16, 2, 256, 1024, 16)),
    "zamba2-shared-up": ("zamba2_1p2b", 2048, 8192, 0.5, 501 + 11,
                         (8, 8, 256, 1024, 4)),
    "zamba2-shared-down": ("zamba2_1p2b", 8192, 2048, 0.75, 501 + 13,
                           (32, 2, 256, 1024, 32)),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(arch):
    cfg = jax_get_config(arch, smoke=True)
    return cfg.with_(sparsity=dataclasses.replace(cfg.sparsity,
                                                  backend="xla"))


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX model, its parameters, the port's model with them)."""
    jmodel = build_model(_jax_cfg(arch))
    params = jmodel.init(jax.random.key(0))
    tmodel = LM(get_config(arch, smoke=True), device="cpu",
                generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np(params), tmodel),
                           strict=False)
    return jmodel, params, tmodel


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# configuration, full-width patterns, seeds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", HYBRID)
def test_config_matches_reference(arch, smoke):
    """Field for field, the nested SSM, hybrid and sparsity configs too;
    the JAX zamba2 smoke config's ``attn_chunk`` has no field in the
    port."""
    assert arch in ARCHS
    ref = jax_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    for f in dataclasses.fields(got):
        want, have = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "sparsity":
            for g in dataclasses.fields(have):
                assert getattr(have, g.name) == getattr(want, g.name), g.name
        elif f.name in ("ssm", "hybrid") and have is not None:
            assert dataclasses.asdict(have) == dataclasses.asdict(want)
        else:
            assert have == want, f.name
    assert got.layer_kinds == ref.layer_kinds == ("mamba",) * got.n_layers


@pytest.mark.parametrize("junction", list(FULL_JUNCTIONS))
def test_full_width_patterns_match_reference(junction):
    arch, n_in, n_out, rho, seed, want = FULL_JUNCTIONS[junction]
    got = fit_block_pattern(n_in, n_out, rho, get_config(arch).sparsity,
                            seed=seed)
    ref = jax_fit(n_in, n_out, rho, jax_get_config(arch).sparsity,
                  seed=seed)
    if want is None:
        assert got is None and ref is None
        return
    np.testing.assert_array_equal(got.block_idx, ref.block_idx)
    assert (got.n_lb, got.n_rb, got.block_in, got.block_out,
            got.d_in_b) == want


def test_full_zamba2_layout_matches_reference_stack():
    """38 layers: 6 groups of 6 slots (seeds 10 u + 1), 2 epilogue layers
    (2000, 2010), the shared block after each group; ``detect_unit`` alone
    would make every layer slot 0."""
    cfg = get_config("zamba2_1p2b")
    stack = build_model(jax_get_config("zamba2_1p2b")).stack
    assert repeat_unit(cfg) == stack.unit_len == 6
    assert stack.n_groups == 6 and len(stack.epilogue) == 2
    seeds = layer_seeds(cfg.layer_kinds, 0, repeat_unit(cfg))
    assert seeds == [1, 11, 21, 31, 41, 51] * 6 + [2000, 2010]
    assert layer_seeds(cfg.layer_kinds) == [1] * 38
    model = LM(cfg, device="meta")
    assert model.shared_after == {6 * g + 5: g for g in range(6)}


def _jax_layers(stack):
    """The JAX stack's blocks in the port's flat layer order."""
    return ([b for _ in range(stack.n_groups) for b in stack.unit_blocks]
            + list(stack.epilogue))


@pytest.mark.parametrize("arch", HYBRID)
def test_layer_seeds_and_patterns_match_reference_stack(arch):
    jmodel, _, tmodel = _models(arch)
    stack = jmodel.stack
    cfg = tmodel.cfg
    want_groups = {"mamba2_130m": (4, 0), "zamba2_1p2b": (2, 1)}[arch]
    assert (stack.n_groups, len(stack.epilogue)) == want_groups
    assert layer_seeds(cfg.layer_kinds, 0, repeat_unit(cfg)) == {
        "mamba2_130m": [1] * 4, "zamba2_1p2b": [1, 11, 1, 11, 2000]}[arch]
    jlayers = _jax_layers(stack)
    assert len(jlayers) == len(tmodel.layers)
    for i, (tl, jl) in enumerate(zip(tmodel.layers, jlayers)):
        assert isinstance(tl, MambaLayer) and isinstance(jl, JaxMambaLayer)
        for name in ("in_proj", "out_proj"):
            got = getattr(tl.mixer, name).pattern
            want = getattr(jl.mixer, name).pattern
            assert (got is None) == (want is None), (i, name)
            if got is not None:
                np.testing.assert_array_equal(got.block_idx, want.block_idx)
    assert (tmodel.shared is None) == (stack.shared is None)
    if stack.shared is not None:
        assert tmodel.shared_after == {1: 0, 3: 1}
        for name in ("up", "gate", "down"):
            np.testing.assert_array_equal(
                getattr(tmodel.shared.ffn, name).pattern.block_idx,
                getattr(stack.shared.ffn, name).pattern.block_idx)
        assert tmodel.shared.attn.wq.n_in == 2 * cfg.d_model
        assert tmodel.shared.attn.wo.n_out == cfg.d_model


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", HYBRID)
def test_forward_loss_and_every_gradient_match_reference(arch):
    jmodel, params, tmodel = _models(arch)
    batch = JaxBigramLM(vocab_size=jmodel.cfg.vocab_size, seed=1).batch(
        0, BATCH, SEQ)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}

    def jlogits(p):
        return jmodel.logits_fn(p, jmodel.forward(p, jbatch)[0])
    want = jax.jit(jlogits)(params)
    with torch.no_grad():
        got = tmodel.logits_fn(tmodel.forward(tbatch["tokens"])[0])
    assert _rel_err(got, want) <= LOGIT_TOL

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jbatch)
    tmodel.zero_grad(set_to_none=True)
    loss, _ = tmodel.loss(tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want_g = from_jax_params(_np(jgrads), tmodel)
    names = {n for n, _ in tmodel.named_parameters()}
    assert "layers.0.mixer.a_log" in names
    assert ("shared.attn.wq.weight" in names) == (arch == "zamba2_1p2b")
    for name, p in tmodel.named_parameters():
        assert p.grad is not None, name
        assert _rel_err(p.grad, want_g[name]) <= GRAD_TOL, name
    tmodel.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _paged_steps(jmodel, params, tmodel, quant_kv=False, n_decode=12):
    """A prefill chunk, then ``n_decode`` greedy decode steps, through the
    JAX paged step and the port's (2 slots, rows = slots); the largest
    |port - JAX| of each step's logits over the largest |JAX|."""
    cfg = jmodel.cfg
    rng = np.random.default_rng(0)
    b, page, total_pages, per_seq = 2, 4, 14, 7
    prompt_lens = np.asarray([8, 5], np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (b, 8)).astype(np.int32)
    st = jax_kv.init_page_state(b, total_pages, per_seq)
    for i in range(b):
        st = jax_kv.alloc_pages(st, i, per_seq)
    table = np.array(st.page_table)
    jcache = jmodel.stack.init_paged_cache(b, total_pages, page, jnp.float32,
                                           quant_kv=quant_kv)
    tcache = tmodel.init_paged_cache(total_pages, page, torch.float32,
                                     quant_kv=quant_kv, slots=b)
    jstep = jax.jit(functools.partial(jmodel.paged_step, backend="xla"))
    errs = []

    def step(tokens, pos, n_new):
        nonlocal jcache
        jl, jcache = jstep(
            params, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(n_new),
            jcache, jnp.asarray(table), jnp.arange(b, dtype=jnp.int32))
        tl = tmodel.paged_step(torch.from_numpy(tokens), torch.from_numpy(pos),
                               torch.from_numpy(n_new), tcache,
                               torch.from_numpy(table))
        errs.append(_rel_err(tl.numpy(), jl))
        return np.asarray(jl)

    logits = step(chunk, np.zeros(b, np.int32), prompt_lens)
    pos = prompt_lens.copy()
    for _ in range(n_decode):
        tok = logits[:, 0].argmax(-1).astype(np.int32)[:, None]
        logits = step(tok, pos, np.ones(b, np.int32))
        pos += 1
    return errs, jcache, tcache


@pytest.mark.parametrize("arch", HYBRID)
def test_paged_step_logits_match_reference(arch):
    """13 paged steps through the mixers' chunked and decode forms (and
    zamba2's shared block over its own page pools); the final SSM state of
    every layer matches too."""
    jmodel, params, tmodel = _models(arch)
    errs, jcache, tcache = _paged_steps(jmodel, params, tmodel)
    assert len(errs) == 13 and max(errs) <= LOGIT_TOL, errs
    n = len(tmodel.layers)
    assert len(tcache) == n + len(tmodel.shared_after)
    jscan = jcache["scan"]
    unit = repeat_unit(tmodel.cfg)
    for i in range(jmodel.stack.n_groups * unit):
        for k in ("ssd", "conv"):
            want = np.asarray(jscan[i % unit][k][i // unit])
            assert _rel_err(tcache[i][k], want) <= LOGIT_TOL, (i, k)


def test_slot_ids_step_only_their_slots():
    """A one-row prefill chunk for slot 1 of 2 (``slot_ids``) against the
    JAX step with the same ``slot_ids``: equal logits, slot 0's state left
    as it was."""
    jmodel, params, tmodel = _models("zamba2_1p2b")
    rng = np.random.default_rng(4)
    page, total_pages = 4, 8
    tokens = rng.integers(0, 512, (1, 6)).astype(np.int32)
    table = np.arange(4, 8, dtype=np.int32)[None]
    jcache = jmodel.stack.init_paged_cache(2, total_pages, page,
                                           jnp.float32)
    tcache = tmodel.init_paged_cache(total_pages, page, torch.float32,
                                     slots=2)
    g = torch.Generator().manual_seed(5)
    for i, layer in enumerate(tmodel.layers):
        for c in tcache[i].values():
            c.copy_(torch.randn(c.shape, generator=g))
    before = [{k: t.clone() for k, t in c.items()} for c in tcache]
    unit = repeat_unit(tmodel.cfg)
    scan = [dict(s) for s in jcache["scan"]]
    for i in range(jmodel.stack.n_groups * unit):
        for k in ("ssd", "conv"):
            scan[i % unit][k] = scan[i % unit][k].at[i // unit].set(
                before[i][k].numpy())
    epi = [{k: jnp.asarray(before[len(scan) * 2 + j][k].numpy())
            for k in ("ssd", "conv")} for j in range(len(jcache["epilogue"]))]
    jcache = dict(jcache, scan=scan, epilogue=epi)
    jl, jcache = jmodel.paged_step(
        params, jnp.asarray(tokens), jnp.zeros(1, jnp.int32),
        jnp.asarray([6], jnp.int32), jcache, jnp.asarray(table),
        jnp.asarray([1], jnp.int32), backend="xla")
    tl = tmodel.paged_step(torch.from_numpy(tokens),
                           torch.zeros(1, dtype=torch.int32),
                           torch.tensor([6], dtype=torch.int32), tcache,
                           torch.from_numpy(table),
                           slot_ids=torch.tensor([1], dtype=torch.int32))
    assert _rel_err(tl.numpy(), jl) <= LOGIT_TOL
    for i in range(len(tmodel.layers)):
        for k in ("ssd", "conv"):
            assert torch.equal(tcache[i][k][0], before[i][k][0]), (i, k)
            assert not torch.equal(tcache[i][k][1], before[i][k][1]), (i, k)
    want = np.asarray(jcache["epilogue"][0]["ssd"])
    assert _rel_err(tcache[len(tmodel.layers) - 1]["ssd"], want) <= LOGIT_TOL


@pytest.mark.parametrize("arch", HYBRID)
def test_greedy_tokens_match_reference_engine(arch):
    """Five requests of mixed lengths through both engines, two slots and a
    pool tight enough to preempt: freed slots are reused (their SSM state
    zeroed at admission), and the tokens are the JAX engine's."""
    jmodel, params, tmodel = _models(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jmodel.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 5, 9, 3)]
    knobs = dict(max_slots=2, page_size=4, total_pages=7,
                 max_pages_per_seq=7, token_budget=8, prefill_chunk=8)
    ref_eng = JaxServingEngine(jmodel, params, JaxEngineConfig(
        backend="xla", metrics=False, **knobs))
    ref = ref_eng.run(prompts, 10)
    eng = ServingEngine(tmodel, EngineConfig(**knobs), device="cpu")
    got = eng.run(prompts, 10)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    stats = eng.sched.stats
    assert stats["preempted"] == ref_eng.sched.stats["preempted"] > 0
    assert stats["admitted"] == ref_eng.sched.stats["admitted"] \
        > len(prompts)


@pytest.mark.parametrize("arch", HYBRID)
def test_spec_k_clamped_and_reclaim_rule(arch):
    """Both engines clamp ``spec_k`` to 0 for a stack with mamba layers and
    apply the same window-reclaim rule: mamba layers do not constrain it,
    a hybrid's shared block (global) does."""
    jmodel, params, tmodel = _models(arch)
    knobs = dict(max_slots=2, page_size=4, total_pages=8, max_pages_per_seq=4)
    eng = ServingEngine(tmodel, EngineConfig(spec_k=4, **knobs),
                        device="cpu")
    ref_eng = JaxServingEngine(jmodel, params, JaxEngineConfig(
        spec_k=4, backend="xla", metrics=False, **knobs))
    assert eng.spec_k == ref_eng.spec_k == 0
    assert eng.sched.drafter is None
    gemma = get_config("gemma3_4b", smoke=True)
    cases = [get_config(arch, smoke=True),
             get_config(arch, smoke=True).with_(attn_window=16),
             get_config(arch, smoke=True).with_(
                 attn_window=16, layer_pattern=("local", "mamba")),
             gemma, gemma.with_(layer_pattern=("local",))]
    got = [ServingEngine._reclaim_window(c) for c in cases]
    want = [JaxServingEngine._reclaim_window(c) for c in cases]
    assert got == want
    assert got[2] == (16 if arch == "mamba2_130m" else None)
    assert got[1] is None and got[4] == gemma.attn_window


def test_quantized_tree_loads_bit_for_bit_and_int8_paged_logits_match():
    """A ``quantize_tree``d zamba2 tree loads into a ``quantize_model``d
    port model bit for bit (the mixers' sparse out_proj, the shared FFN;
    the dense in_proj stays full width), the same as quantizing on the
    port's side; the int8 paged steps (int8 weights and KV: the shared
    block's pools stay full width in both) agree with the JAX ones."""
    jmodel, params, tmodel = _models("zamba2_1p2b")
    qp, _ = jquant.quantize_tree(params, jmodel.spec())
    qtree = _np(qp)
    qmodel = quantize_model(LM(get_config("zamba2_1p2b", smoke=True),
                               device="cpu",
                               generator=torch.Generator().manual_seed(9)))
    qmodel.load_state_dict(from_jax_params(qtree, qmodel), strict=False)
    mix = qtree["stack"]["scan"][1]["mixer"]
    out_proj = qmodel.layers[3].mixer.out_proj
    assert out_proj.weight.dtype == torch.int8
    np.testing.assert_array_equal(out_proj.weight.numpy(),
                                  mix["out_proj"]["w"][1])
    np.testing.assert_array_equal(out_proj.w_scale.numpy(),
                                  mix["out_proj"]["w_scale"][1])
    assert qmodel.layers[3].mixer.in_proj.weight.dtype == torch.float32
    sh = qtree["stack"]["shared"]["ffn"]
    for name in ("up", "gate", "down"):
        lin = getattr(qmodel.shared.ffn, name)
        assert lin.weight.dtype == torch.int8
        np.testing.assert_array_equal(lin.w_scale.numpy(),
                                      sh[name]["w_scale"])
    ref = LM(get_config("zamba2_1p2b", smoke=True), device="cpu",
             generator=torch.Generator().manual_seed(0))
    ref.load_state_dict(tmodel.state_dict())
    quantize_model(ref)
    got_sd, ref_sd = qmodel.state_dict(), ref.state_dict()
    assert set(got_sd) == set(ref_sd)
    for k in ref_sd:
        assert torch.equal(got_sd[k], ref_sd[k]), k
    errs, _, tcache = _paged_steps(jmodel, qp, qmodel, quant_kv=True,
                                   n_decode=4)
    assert max(errs) <= LOGIT_TOL, errs
    assert all(t.dtype != torch.int8 for c in tcache for t in c.values())
