"""The dense decoder configurations (gemma2-9b, qwen2-7b, granite-34b) of
the port against the JAX package on the CPU: the configurations, the
full-width FFN patterns, the untied head and its conversion, the forward
logits, loss and every gradient, the paged step's logits and the engine's
greedy tokens, each on the smoke configuration at 2 layers with the JAX
parameters moved over by ``repro_torch.convert.from_jax_params``.

Between them the three reach ``qkv_bias`` (qwen2), one KV head under 4
query heads (granite's smoke; 48 at full width), alternating local and
global layers (gemma2: at 2 layers one of each, one scanned unit),
``post_norms``, ``scale_embed`` and both softcaps (gemma2), and the untied
head (qwen2, granite)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.block_pattern import fit_block_pattern as jax_fit
from repro.data import BigramLM as JaxBigramLM
from repro.nn import build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import kv_cache as jax_kv
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.block_pattern import fit_block_pattern
from repro_torch.core.quant import QuantConfig, quantize_model
from repro_torch.nn.model import LM, layer_seeds
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineConfig, ServingEngine

DENSE = ["gemma2_9b", "qwen2_7b", "granite_34b"]
N_LAYERS = 2
SEQ, BATCH = 32, 2
LOGIT_TOL = 1e-4   # f32 end to end (tests/test_torch_model.py)
LOSS_RTOL = 1e-5   # tests/test_torch_train.py
GRAD_TOL = 1e-4    # each gradient, relative to max |JAX|

# the full-width FFN patterns, as the JAX fit_block_pattern gives them:
# (n_lb x n_rb, fan-in d_in_b, block_in x block_out) of up/gate and down
FULL_PATTERNS = {
    "gemma2_9b": (((14, 14), 7, (256, 1024)), ((56, 7), 40, (256, 512))),
    "qwen2_7b": (((14, 37), 14, (256, 512)), ((74, 7), 74, (256, 512))),
    "granite_34b": (((24, 24), 12, (256, 1024)), ((96, 6), 64, (256, 1024))),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX model, its parameters, the port's model with them), 2 layers of
    the smoke configuration."""
    jcfg = jax_get_config(arch, smoke=True).with_(n_layers=N_LAYERS)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tmodel = LM(get_config(arch, smoke=True).with_(n_layers=N_LAYERS),
                device="cpu", generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np(params), tmodel),
                           strict=False)
    return jmodel, params, tmodel


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _batch(vocab):
    return JaxBigramLM(vocab_size=vocab, seed=1).batch(0, BATCH, SEQ)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_reference(arch, smoke):
    assert arch in ARCHS
    ref = jax_get_config(arch, smoke=smoke)
    got = get_config(arch, smoke=smoke)
    for f in dataclasses.fields(got):
        want = getattr(ref, f.name)
        if f.name == "sparsity":
            for g in dataclasses.fields(got.sparsity):
                assert getattr(got.sparsity, g.name) == getattr(want, g.name)
        else:
            assert getattr(got, f.name) == want, f.name
    assert got.layer_kinds == ref.layer_kinds
    assert layer_seeds(got.layer_kinds)[:2] == (
        [1, 11] if arch == "gemma2_9b" else [1, 1])


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_patterns_match_reference(arch):
    """Layer 0's up, gate and down patterns at full width (seeds 12, 13,
    14 of block seed 1) equal the JAX ones, with the block counts, fan-ins
    and block sizes of the table above."""
    cfg = get_config(arch)
    sp = cfg.sparsity
    jsp = jax_get_config(arch).sparsity
    want = FULL_PATTERNS[arch]
    for name, n_in, n_out, rho, seed, (grid, fan_in, block) in (
            ("up", cfg.d_model, cfg.d_ff, sp.rho_ffn[0], 12, want[0]),
            ("gate", cfg.d_model, cfg.d_ff, sp.rho_ffn[0], 13, want[0]),
            ("down", cfg.d_ff, cfg.d_model, sp.rho_ffn[1], 14, want[1])):
        got = fit_block_pattern(n_in, n_out, rho, sp, seed=seed)
        ref = jax_fit(n_in, n_out, rho, jsp, seed=seed)
        np.testing.assert_array_equal(got.block_idx, ref.block_idx)
        assert (got.n_lb, got.n_rb) == grid, name
        assert got.d_in_b == fan_in and (got.block_in, got.block_out) \
            == block, name


@pytest.mark.parametrize("arch", DENSE)
def test_head_and_conversion(arch):
    """An untied config builds ``head`` (d_model, vocab) in the parameter
    dtype and ``from_jax_params`` fills it from ``params["head"]``; a tree
    whose head does not match the model's is refused."""
    jmodel, params, tmodel = _models(arch)
    untied = not tmodel.cfg.tie_embeddings
    assert (tmodel.head is not None) == untied == ("head" in params)
    if untied:
        assert tuple(tmodel.head.weight.shape) == (64, 512)
        assert tmodel.head.bias is None and not tmodel.head.is_sparse
        np.testing.assert_array_equal(tmodel.head.weight.detach().numpy(),
                                      np.asarray(params["head"]["w"]))
        bad = {k: v for k, v in _np(params).items() if k != "head"}
    else:
        bad = dict(_np(params), head={"w": np.zeros((64, 512), np.float32)})
    with pytest.raises(ValueError, match="head mismatch"):
        from_jax_params(bad, tmodel)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_and_every_gradient_match_reference(arch):
    jmodel, params, tmodel = _models(arch)
    batch = _batch(jmodel.cfg.vocab_size)
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

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jbatch)
    tmodel.zero_grad(set_to_none=True)
    loss, _ = tmodel.loss(tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want_g = from_jax_params(_np(jgrads), tmodel)
    names = [n for n, _ in tmodel.named_parameters()]
    assert ("head.weight" in names) == (not tmodel.cfg.tie_embeddings)
    for name, p in tmodel.named_parameters():
        assert p.grad is not None, name
        assert _rel_err(p.grad, want_g[name]) <= GRAD_TOL, name
    tmodel.zero_grad(set_to_none=True)


@pytest.mark.parametrize("arch", DENSE)
def test_paged_step_logits_match_reference(arch):
    """A prefill chunk, then decode steps, against the JAX paged step; at
    8 + 12 positions gemma2's local layer (window 16) masks keys."""
    jmodel, params, tmodel = _models(arch)
    cfg = jmodel.cfg
    rng = np.random.default_rng(0)
    b, page, total_pages, per_seq = 2, 4, 14, 7
    prompt_lens = np.asarray([8, 5], np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (b, 8)).astype(np.int32)
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
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        return np.asarray(jl)

    logits = step(chunk, np.zeros(b, np.int32), prompt_lens)
    pos = prompt_lens.copy()
    for _ in range(12):
        tok = logits[:, 0].argmax(-1).astype(np.int32)[:, None]
        logits = step(tok, pos, np.ones(b, np.int32))
        pos += 1


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_match_reference_engine(arch):
    """Mixed prompt lengths through both engines, a pool tight enough to
    preempt; gemma2 mixes local and global layers, so neither engine
    reclaims window pages."""
    jmodel, params, tmodel = _models(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jmodel.cfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 5)]
    knobs = dict(max_slots=3, page_size=4, total_pages=9,
                 max_pages_per_seq=7, token_budget=8, prefill_chunk=8)
    ref_eng = JaxServingEngine(jmodel, params,
                               JaxEngineConfig(backend="xla", **knobs))
    ref = ref_eng.run(prompts, 10)
    eng = ServingEngine(tmodel, EngineConfig(**knobs), device="cpu")
    got = eng.run(prompts, 10)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    assert eng.sched.stats["preempted"] == ref_eng.sched.stats["preempted"]
    assert eng.sched.stats["reclaimed_pages"] == 0 \
        == ref_eng.sched.stats["reclaimed_pages"]


def test_engine_loads_part_by_part(monkeypatch):
    """The engine moves and casts the model one part at a time (embedding,
    each layer, final norm, head), quantizing each part's sparse junctions
    from the weights as given: the same tensors as moving the whole model,
    quantizing it and casting it."""
    cfg = get_config("granite_34b", smoke=True).with_(n_layers=3)
    seen = []
    real = torch.nn.Module.to

    def to(self, *a, **kw):
        seen.append(type(self).__name__)
        return real(self, *a, **kw)
    a = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(torch.nn.Module, "to", to)
    engine_mod.load(a, torch.device("cpu"), torch.bfloat16, quantize=True)
    monkeypatch.undo()
    assert seen[:2] == ["Embedding", "Embedding"]
    assert seen.count("TransformerBlock") == 2 * cfg.n_layers
    assert seen[-3:-1] == ["Linear", "Linear"] and seen[-1] == "LM"
    want = quantize_model(b).to(dtype=torch.bfloat16)
    sa, sb = a.state_dict(), want.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    assert a.layers[0].ffn.down.weight.dtype == torch.int8
    assert a.layers[0].ffn.down.w_scale.dtype == torch.float32
    assert a.head.weight.dtype == torch.bfloat16
    eng = ServingEngine(LM(cfg, device="cpu"), device="cpu",
                        quant=QuantConfig(weights=True, kv=True))
    assert eng.model.layers[0].ffn.up.weight.dtype == torch.int8


def test_serve_cli_builds_in_the_compute_dtype(monkeypatch, capsys):
    """``launch.serve`` builds the model in its compute dtype, as the
    engine serves it: at full width bf16, which is what fits granite-34b
    on one card (here the smoke configuration made bf16)."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve
    real_get = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda name, smoke=False:
                        real_get(name, smoke=True).with_(dtype="bfloat16"))
    built = []
    real = LM.__init__

    def init(self, cfg, **kw):
        built.append(cfg)
        real(self, cfg, **kw)
    monkeypatch.setattr(LM, "__init__", init)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "granite_34b",
                                     "--device", "cpu", "--gen", "2",
                                     "--prompt-len", "4", "--batch", "2"])
    serve.main()
    assert built[0].param_dtype == built[0].dtype == "bfloat16"
    assert "generated (2, 2) tokens" in capsys.readouterr().out
