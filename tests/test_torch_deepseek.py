"""deepseek-moe-16b on the port against the JAX package on the CPU.

The configurations field for field, the full-width junction patterns at
the published 256 x 1024 blocks and at the card's 64 x 64, and on the
smoke configuration at 3 layers (the dense prologue layer, then 2 scanned
MoE layers with a shared expert) with the JAX parameters moved over by
``repro_torch.convert.from_jax_params``: the layer seeds and every
junction's pattern, the forward logits, the loss with its aux terms and
every gradient, the paged step's logits over 13 steps and the engine's
greedy tokens with preemption at the dropless capacity factor, a
``quantize_tree``d tree loaded into a ``quantize_model``d model and its
int8 paged logits, and what the port refuses (the published capacity in
serving, a tree without its prologue). The JAX junctions run on their XLA
backend, the plain reference of the Pallas kernels."""
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
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import kv_cache as jax_kv
from repro_torch.configs import ARCHS, deepseek_moe_16b, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.block_pattern import fit_block_pattern
from repro_torch.core.quant import quantize_model
from repro_torch.nn.ffn import FFN
from repro_torch.nn.model import LM, layer_seeds, prologue_len
from repro_torch.serving.engine import EngineConfig, ServingEngine

ARCH = "deepseek_moe_16b"
N_LAYERS = 3       # the prologue and 2 scanned MoE layers
DROPLESS = 4.0     # the smoke config's n_routed / top_k = 8 / 2
SEQ, BATCH = 32, 2
LOGIT_TOL = 1e-4   # f32 end to end (tests/test_torch_model.py)
LOSS_RTOL = 1e-5   # tests/test_torch_train.py
GRAD_TOL = 1e-4    # each gradient, relative to max |JAX|

# the full-width junctions (n_in, n_out, rho, pattern seed: the block's
# seed 0 for layer 0, 1 for the scan slot; +31/+33 an expert junction,
# +29 the shared FFN, +11/+13 an FFN junction) and, at the published
# 256 x 1024 and the card's 64 x 64 blocks, (n_lb, n_rb, fan-in, density)
FULL_JUNCTIONS = {
    "routed-up": (2048, 1408, 0.5, 1 + 31, (8, 11, 8, 1.0),
                  (32, 22, 16, 0.5)),
    "routed-down": (1408, 2048, 0.75, 1 + 33, (11, 2, 11, 1.0),
                    (22, 32, 22, 1.0)),
    "shared-up": (2048, 2816, 0.5, 1 + 29 + 11, (8, 11, 8, 1.0),
                  (32, 44, 16, 0.5)),
    "shared-down": (2816, 2048, 0.75, 1 + 29 + 13, (11, 2, 11, 1.0),
                    (44, 32, 33, 0.75)),
    "layer0-up": (2048, 10944, 0.5, 0 + 11, (8, 171, 8, 1.0),
                  (32, 171, 32, 1.0)),
    "layer0-down": (10944, 2048, 0.75, 0 + 13, (171, 2, 171, 1.0),
                    (171, 32, 171, 1.0)),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(**moe):
    """The JAX smoke config at 3 layers, its junctions on the XLA backend
    (the JAX MoE and Linear take it from the sparsity config)."""
    cfg = jax_get_config(ARCH, smoke=True).with_(n_layers=N_LAYERS)
    return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe),
                     sparsity=dataclasses.replace(cfg.sparsity,
                                                  backend="xla"))


def _port_cfg(**moe):
    cfg = get_config(ARCH, smoke=True).with_(n_layers=N_LAYERS)
    return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))


@functools.lru_cache(maxsize=None)
def _models(capacity_factor=None):
    """(JAX model, its parameters, the port's model with them) at the
    smoke config's capacity factor or at ``capacity_factor``."""
    moe = {} if capacity_factor is None \
        else dict(capacity_factor=capacity_factor)
    jmodel = build_model(_jax_cfg(**moe))
    params = jmodel.init(jax.random.key(0))
    tmodel = LM(_port_cfg(**moe), device="cpu",
                generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np(params), tmodel),
                           strict=False)
    return jmodel, params, tmodel


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# configuration and full-width patterns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_config_matches_reference(smoke):
    """Field for field, the nested MoE and sparsity configs too; the JAX
    smoke config's ``attn_chunk`` has no field in the port."""
    assert ARCH in ARCHS
    ref = jax_get_config(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(got):
        want = getattr(ref, f.name)
        if f.name in ("sparsity", "moe"):
            for g in dataclasses.fields(getattr(got, f.name)):
                assert getattr(getattr(got, f.name), g.name) \
                    == getattr(want, g.name), (f.name, g.name)
        else:
            assert getattr(got, f.name) == want, f.name
    assert got.layer_kinds == ref.layer_kinds
    assert prologue_len(got) == 1


def test_card_config_is_the_published_one_at_64_blocks():
    full, card = get_config(ARCH), deepseek_moe_16b.card_config()
    assert (card.sparsity.block_in, card.sparsity.block_out) == (64, 64)
    assert card.with_(sparsity=full.sparsity) == full
    assert card.moe.capacity_factor == 1.25
    n = sum(p.numel() for p in LM(card, device="meta").parameters())
    assert 11.1e9 < n < 11.3e9


@pytest.mark.parametrize("blocks", [(256, 1024), (64, 64)],
                         ids=["published", "card"])
@pytest.mark.parametrize("junction", list(FULL_JUNCTIONS))
def test_full_width_patterns_match_reference(junction, blocks):
    """Each full-width junction's pattern equals the JAX one, with the
    block counts, fan-in and density of the configuration's table."""
    n_in, n_out, rho, seed, pub, card = FULL_JUNCTIONS[junction]
    sp = dataclasses.replace(get_config(ARCH).sparsity, block_in=blocks[0],
                             block_out=blocks[1])
    jsp = dataclasses.replace(jax_get_config(ARCH).sparsity,
                              block_in=blocks[0], block_out=blocks[1])
    got = fit_block_pattern(n_in, n_out, rho, sp, seed=seed)
    ref = jax_fit(n_in, n_out, rho, jsp, seed=seed)
    np.testing.assert_array_equal(got.block_idx, ref.block_idx)
    want = pub if blocks == (256, 1024) else card
    assert (got.n_lb, got.n_rb, got.d_in_b) == want[:3]
    assert got.d_in_b / got.n_lb == want[3]
    assert got.n_lb * got.block_in == n_in
    assert got.n_rb * got.block_out == n_out
    if blocks == (64, 64):
        assert (got.block_in, got.block_out) == (64, 64)


def _patterns(ffn):
    """Every junction pattern of a block's FFN or MoE (shared expert's
    included), by name, as the port holds them."""
    if isinstance(ffn, FFN):
        return {n: getattr(ffn, n).pattern for n in ("up", "gate", "down")}
    out = {n: getattr(ffn, f"{n}_pat") for n in ("up", "gate", "down")}
    if ffn.shared is not None:
        out.update({f"shared.{k}": v
                    for k, v in _patterns(ffn.shared).items()})
    return out


def _jax_patterns(ffn):
    if hasattr(ffn, "up_pat"):
        out = {n: getattr(ffn, f"{n}_pat") for n in ("up", "gate", "down")}
        if getattr(ffn, "shared", None) is not None:
            out.update({f"shared.{k}": v
                        for k, v in _jax_patterns(ffn.shared).items()})
        return out
    return {n: getattr(ffn, n).pattern for n in ("up", "gate", "down")}


def test_layer_seeds_and_patterns_match_reference_stack():
    """The prologue block gets seed 0 and a dense FFN of ``dense_d_ff``,
    the scanned MoE blocks seed 1; every junction's pattern (the routed
    experts', the shared expert's, layer 0's) equals the JAX stack's."""
    jmodel, _, tmodel = _models()
    cfg = tmodel.cfg
    assert layer_seeds(cfg.layer_kinds, prologue_len(cfg)) == [0, 1, 1]
    assert layer_seeds(cfg.layer_kinds) == [1, 1, 1]  # no prologue
    stack = jmodel.stack
    assert len(stack.prologue) == 1 and stack.n_groups == 2
    jblocks = [stack.prologue[0]] + [stack.unit_blocks[0]] * 2
    assert [blk.is_moe for blk in tmodel.layers] == [False, True, True]
    assert tmodel.layers[0].ffn.up.n_out == cfg.moe.dense_d_ff
    for i, (tblk, jblk) in enumerate(zip(tmodel.layers, jblocks)):
        assert tblk.is_moe == jblk.is_moe, i
        got, want = _patterns(tblk.ffn), _jax_patterns(jblk.ffn)
        assert set(got) == set(want), i
        assert len(got) == (6 if i else 3)
        for name in want:
            assert got[name] is not None, (i, name)
            np.testing.assert_array_equal(got[name].block_idx,
                                          want[name].block_idx)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


def test_forward_loss_and_every_gradient_match_reference():
    jmodel, params, tmodel = _models()
    batch = JaxBigramLM(vocab_size=jmodel.cfg.vocab_size, seed=1).batch(
        0, BATCH, SEQ)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {k: torch.from_numpy(np.asarray(v)).long()
              for k, v in batch.items()}

    def jlogits(p):
        h = jmodel.forward(p, jbatch)[0]
        return jmodel.logits_fn(p, h)
    want = jax.jit(jlogits)(params)
    with torch.no_grad():
        got = tmodel.logits_fn(tmodel.forward(tbatch["tokens"])[0])
    assert _rel_err(got, want) <= LOGIT_TOL

    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jbatch)
    tmodel.zero_grad(set_to_none=True)
    loss, met = tmodel.loss(tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    for k in ("moe_lb", "moe_z"):  # summed over the 2 MoE layers
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   rtol=LOSS_RTOL)
    want_g = from_jax_params(_np(jgrads), tmodel)
    names = [n for n, _ in tmodel.named_parameters()]
    assert "head.weight" in names and "layers.0.ffn.up.weight" in names
    assert "layers.1.ffn.shared.down.weight" in names
    for name, p in tmodel.named_parameters():
        assert p.grad is not None, name
        assert _rel_err(p.grad, want_g[name]) <= GRAD_TOL, name
    tmodel.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------------
# serving at the dropless capacity factor
# ---------------------------------------------------------------------------


def _paged_steps(jmodel, params, tmodel, quant_kv=False, n_decode=12):
    """A prefill chunk, then ``n_decode`` greedy decode steps, through the
    JAX paged step and the port's; the largest |port - JAX| of each step's
    logits over the largest |JAX|."""
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
                                     quant_kv=quant_kv)
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
    return errs


def test_paged_step_logits_match_reference():
    """13 paged steps (a prefill chunk and 12 decode steps) through the
    prologue, the routed and the shared experts."""
    jmodel, params, tmodel = _models(DROPLESS)
    errs = _paged_steps(jmodel, params, tmodel)
    assert len(errs) == 13 and max(errs) <= LOGIT_TOL, errs


def test_greedy_tokens_match_reference_engine():
    """Mixed prompt lengths through both engines at the dropless capacity,
    a pool tight enough to preempt; every layer is global, so neither
    engine reclaims window pages."""
    jmodel, params, tmodel = _models(DROPLESS)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jmodel.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 5)]
    knobs = dict(max_slots=3, page_size=4, total_pages=9,
                 max_pages_per_seq=7, token_budget=8, prefill_chunk=8)
    ref_eng = JaxServingEngine(jmodel, params, JaxEngineConfig(
        backend="xla", metrics=False, **knobs))
    ref = ref_eng.run(prompts, 10)
    eng = ServingEngine(tmodel, EngineConfig(**knobs), device="cpu")
    assert eng._reclaim_window(tmodel.cfg) is None
    got = eng.run(prompts, 10)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    assert eng.sched.stats["preempted"] \
        == ref_eng.sched.stats["preempted"] > 0
    assert eng.sched.stats["reclaimed_pages"] == 0 \
        == ref_eng.sched.stats["reclaimed_pages"]


def test_quantized_tree_loads_bit_for_bit_and_int8_paged_logits_match():
    """A ``quantize_tree``d JAX tree loads into a ``quantize_model``d port
    model bit for bit (layer 0's ``w_scale``, the expert slabs' ``*_scale``,
    the shared expert's), the same as quantizing on the port's side; the
    int8 paged steps (int8 weights and KV pages) agree with the JAX ones."""
    jmodel, params, tmodel = _models(DROPLESS)
    qp, _ = jquant.quantize_tree(params, jmodel.spec())
    qtree = _np(qp)
    qmodel = quantize_model(LM(_port_cfg(capacity_factor=DROPLESS),
                               device="cpu",
                               generator=torch.Generator().manual_seed(9)))
    qmodel.load_state_dict(from_jax_params(qtree, qmodel), strict=False)
    pro = qtree["stack"]["prologue"][0]["ffn"]
    np.testing.assert_array_equal(qmodel.layers[0].ffn.down.weight.numpy(),
                                  pro["down"]["w"])
    np.testing.assert_array_equal(qmodel.layers[0].ffn.down.w_scale.numpy(),
                                  pro["down"]["w_scale"])
    scan = qtree["stack"]["scan"][0]["ffn"]
    for i in (1, 2):
        ffn = qmodel.layers[i].ffn
        for name in ("up", "gate", "down"):
            assert getattr(ffn, name).dtype == torch.int8
            np.testing.assert_array_equal(getattr(ffn, name).numpy(),
                                          scan[name][i - 1])
            np.testing.assert_array_equal(
                getattr(ffn, f"{name}_scale").numpy(),
                scan[f"{name}_scale"][i - 1])
        assert ffn.shared.up.weight.dtype == torch.int8
        np.testing.assert_array_equal(ffn.shared.up.w_scale.numpy(),
                                      scan["shared"]["up"]["w_scale"][i - 1])
    ref = LM(_port_cfg(capacity_factor=DROPLESS), device="cpu",
             generator=torch.Generator().manual_seed(0))
    ref.load_state_dict(tmodel.state_dict())
    quantize_model(ref)
    got_sd, ref_sd = qmodel.state_dict(), ref.state_dict()
    assert set(got_sd) == set(ref_sd)
    for k in ref_sd:
        assert torch.equal(got_sd[k], ref_sd[k]), k
    errs = _paged_steps(jmodel, qp, qmodel, quant_kv=True, n_decode=4)
    assert max(errs) <= LOGIT_TOL, errs


def test_engine_refuses_the_published_capacity():
    """The published capacity factor 1.25 (smoke: 1.5) drops tokens; both
    engines refuse it, with the port's message unchanged."""
    knobs = dict(max_slots=2, page_size=4, total_pages=8, max_pages_per_seq=4)
    with pytest.raises(NotImplementedError, match="capacity"):
        JaxServingEngine(build_model(_jax_cfg()), None,
                         JaxEngineConfig(**knobs))
    for cfg in (get_config(ARCH, smoke=True).with_(n_layers=2),
                deepseek_moe_16b.card_config()):
        model = LM(cfg, device="meta")
        with pytest.raises(NotImplementedError,
                           match=r"capacity_factor >= n_routed/top_k"):
            ServingEngine(model, EngineConfig(**knobs), device="cpu")
    full = deepseek_moe_16b.card_config()
    moe = full.moe
    assert moe.n_routed / moe.top_k * moe.top_k >= moe.n_routed


def test_from_jax_params_refuses_a_tree_without_its_prologue():
    jmodel, params, tmodel = _models()
    tree = _np(params)
    bad = dict(tree, stack=dict(tree["stack"], prologue=[]))
    with pytest.raises(ValueError, match="prologue mismatch"):
        from_jax_params(bad, tmodel)
    # a stack without a prologue refuses a tree that has one
    plain = LM(_port_cfg(first_layer_dense=False), device="cpu")
    with pytest.raises(ValueError, match="prologue mismatch"):
        from_jax_params(tree, plain)
