"""The port's MoE serving path against the JAX package.

The expert-batched forward (plain version, on the CPU) against the JAX
package's Pallas kernels ``_csd_spmm_fwd_batched`` and
``_csd_spmm_fwd_quant_batched`` in interpret mode and its XLA forms; 5-D
slab quantization bit for bit; ``MoE.forward`` (routing, aux values,
dispatch, combine, shared expert, dropped tokens) against the JAX ``MoE``;
the paged step and the engine's greedy tokens, full width and int8, on the
granite-moe smoke config made dropless (``capacity_factor=4.0``); the
checkpoint conversion; and what the port refuses (capacity-constrained
serving, gradients through int8 5-D slabs). The training path through the
5-D junctions is held against the JAX package by
``tests/test_torch_moe_train.py``. The CUDA kernels are held against
the plain versions by ``tests/test_torch_cuda.py`` (on a card) and
``chip_smoke.py``.
"""
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
from repro.core.block_pattern import make_block_pattern
from repro.kernels import csd_spmm as jcsd
from repro.kernels import ops as jops
from repro.nn import build_model
from repro.nn.ffn import MoE as JaxMoE
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import kv_cache as jax_kv
from repro_torch.configs import get_config
from repro_torch.convert import _block_name, _items, from_jax_params
from repro_torch.core.block_pattern import fit_block_pattern
from repro_torch.core.quant import QuantConfig, quantize_model, quantize_slab
from repro_torch.kernels import csd_spmm, ops
from repro_torch.nn.ffn import MoE
from repro_torch.nn.model import LM
from repro_torch.serving.engine import EngineConfig, ServingEngine

TOL_SPMM = 1e-5  # of max |ref|: f32, the same products in another order
TOL_MOE = 1e-5   # MoE output, of max |ref|
TOL_AUX = 1e-6   # moe_lb / moe_z, relative
TOL_STEP = 1e-4  # paged-step logits, f32 end to end (as test_torch_model)
ARCH = "granite_moe_1b_a400m"
N_NEW = 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= tol * scale, (err, scale)


def _jax_cfg(smoke=True, **moe):
    """The JAX config of the same name, its junctions on the XLA backend
    (the JAX MoE takes its backend from the sparsity config)."""
    cfg = jax_get_config(ARCH, smoke=smoke)
    return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe),
                     sparsity=dataclasses.replace(cfg.sparsity,
                                                  backend="xla"))


def _port_cfg(smoke=True, **moe):
    cfg = get_config(ARCH, smoke=smoke)
    return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))


# ---------------------------------------------------------------------------
# (a) configuration and patterns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_config_matches_reference(smoke):
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


# (n_in, n_out, rho, blocks (bL, bR) or None for the default 256 x 1024,
#  expected (n_lb, n_rb, fan-in, density))
SERVING_PATTERNS = {
    "up-default": (1024, 512, 0.5, None, (4, 1, 4, 1.0)),
    "down-default": (512, 1024, 0.75, None, (2, 1, 2, 1.0)),
    "up-128x256": (1024, 512, 0.5, (128, 256), (8, 2, 4, 0.5)),
    "down-128x256": (512, 1024, 0.75, (128, 256), (4, 4, 3, 0.75)),
}


@pytest.mark.parametrize("case", list(SERVING_PATTERNS))
def test_expert_patterns_at_full_width(case):
    """The default blocks make granite's expert junctions dense; 128 x 256
    blocks give exactly rho_ffn, bit for bit as the JAX package."""
    n_in, n_out, rho, blocks, (n_lb, n_rb, fan_in, dens) = \
        SERVING_PATTERNS[case]
    sp = get_config(ARCH).sparsity
    jsp = jax_get_config(ARCH).sparsity
    if blocks is not None:
        sp = dataclasses.replace(sp, block_in=blocks[0], block_out=blocks[1])
        jsp = dataclasses.replace(jsp, block_in=blocks[0],
                                  block_out=blocks[1])
    for seed in (31, 32, 33):
        got = fit_block_pattern(n_in, n_out, rho, sp, seed=1 + seed)
        ref = jax_fit(n_in, n_out, rho, jsp, seed=1 + seed)
        np.testing.assert_array_equal(got.block_idx, ref.block_idx)
        assert (got.n_lb, got.n_rb, got.d_in_b) == (n_lb, n_rb, fan_in)
        assert got.d_in_b / got.n_lb == dens


# ---------------------------------------------------------------------------
# (b) the expert-batched forward, full width and int8
# ---------------------------------------------------------------------------

E, M = 4, 8


def _batched_junction(seed, n_in=64, n_out=96, bl=16, br=16, rho=0.5):
    rng = np.random.default_rng(seed)
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br,
                            seed=seed)
    x = rng.normal(size=(E, M, n_in)).astype(np.float32)
    w = rng.normal(size=(E, bp.n_rb, bp.d_in_b, bl, br)).astype(np.float32)
    b = rng.normal(size=(E, n_out)).astype(np.float32)
    return bp, x, w, b


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_batched_fwd_plain_matches_pallas_and_xla(activation, with_bias):
    bp, x, w, b = _batched_junction(1)
    bias = b if with_bias else None
    got = csd_spmm.csd_spmm_fwd_batched_plain(
        _t(x), _t(w), _t(bp.block_idx),
        bias=None if bias is None else _t(bias), activation=activation)
    jb = None if bias is None else jnp.asarray(bias)
    pallas = jcsd._csd_spmm_fwd_batched(
        jnp.asarray(x), jnp.asarray(w), bp.block_idx, bias=jb,
        activation=activation, save_preact=False, block_m=8, interpret=True)
    xla = jops.csd_matmul(jnp.asarray(x), jnp.asarray(w), bp, bias=jb,
                          activation=activation, backend="xla")
    assert got.dtype == torch.float32 and got.shape == (E, M, bp.n_out)
    for ref in (pallas, xla):
        _close(got.numpy(), ref, TOL_SPMM)
    # through csd_matmul, which keeps the expert dim and flattens the rest
    with torch.no_grad():
        got4 = ops.csd_matmul(
            _t(x).reshape(E, 2, 4, -1), _t(w), _t(bp.block_idx).int(),
            bias=None if bias is None else _t(bias), activation=activation)
    assert got4.shape == (E, 2, 4, bp.n_out)
    np.testing.assert_array_equal(got4.reshape(E, M, -1).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_quant_batched_fwd_plain_matches_pallas_and_xla(activation,
                                                        with_bias):
    bp, x, w, b = _batched_junction(2)
    q, s = (np.array(a) for a in jquant.quantize_slab(jnp.asarray(w)))
    bias = b if with_bias else None
    got = csd_spmm.csd_spmm_fwd_batched_plain(
        _t(x), _t(q), _t(bp.block_idx),
        bias=None if bias is None else _t(bias), activation=activation,
        w_scale=_t(s))
    jb = None if bias is None else jnp.asarray(bias)
    pallas = jcsd._csd_spmm_fwd_quant_batched(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), bp.block_idx,
        bias=jb, activation=activation, block_m=8, interpret=True)
    xla = jops.csd_matmul(jnp.asarray(x), jnp.asarray(q), bp, bias=jb,
                          activation=activation, backend="xla",
                          w_scale=jnp.asarray(s))
    assert got.dtype == torch.float32 and got.shape == (E, M, bp.n_out)
    for ref in (pallas, xla):
        _close(got.numpy(), ref, TOL_SPMM)
    with torch.no_grad():
        got3 = ops.csd_matmul(_t(x), _t(q), _t(bp.block_idx).int(),
                              bias=None if bias is None else _t(bias),
                              activation=activation, w_scale=_t(s))
    np.testing.assert_array_equal(got3.numpy(), got.numpy())


def test_quantize_slab_5d_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    w = rng.normal(scale=0.3, size=(3, 2, 4, 16, 8)).astype(np.float32)
    w[1, 0, 2] = 0.0                  # an all-zero block
    w[2, 1, 0] *= 0.0
    w[2, 1, 0, 0, :2] = [1.27, 0.005]  # halves land on the rounding rule
    q, s = quantize_slab(_t(w))
    jq, js = jquant.quantize_slab(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.shape == (3, 2, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# (c) MoE.forward against the JAX MoE
# ---------------------------------------------------------------------------

# capacity_factor, n_shared, block-sparse expert junctions (moe_sparsity)
MOE_CASES = {"dropless": (4.0, 0, True), "shared": (4.0, 1, True),
             "dropping": (1.0, 0, True), "dense-experts": (4.0, 0, False)}


def _moe_pair(cf, n_shared, sparse=True, seed=1):
    jcfg = _jax_cfg(capacity_factor=cf, n_shared=n_shared)
    tcfg = _port_cfg(capacity_factor=cf, n_shared=n_shared)
    jcfg, tcfg = (c.with_(sparsity=dataclasses.replace(
        c.sparsity, moe_sparsity=sparse)) for c in (jcfg, tcfg))
    jmoe = JaxMoE(jcfg, seed=seed)
    params = jmoe.init(jax.random.key(seed))
    tmoe = MoE(tcfg, seed=seed, generator=torch.Generator().manual_seed(0))
    sd = {_block_name(p): torch.as_tensor(np.array(a))
          for p, a in _items(_np_tree(params))}
    assert set(sd) == {n for n, _ in tmoe.named_parameters()}
    tmoe.load_state_dict(sd, strict=False)
    for name in ("up", "gate", "down"):
        idx, pat = getattr(tmoe, f"{name}_idx"), getattr(jmoe, f"{name}_pat")
        assert (idx is None) == (pat is None) == (not sparse)
        if sparse:
            np.testing.assert_array_equal(idx.numpy(), pat.block_idx)
    return jmoe, params, tmoe


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(case):
    cf, n_shared, sparse = MOE_CASES[case]
    jmoe, params, tmoe = _moe_pair(cf, n_shared, sparse)
    x = np.random.default_rng(4).normal(size=(2, 6, 64)).astype(np.float32)
    ref, ref_aux = jmoe(params, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tmoe(_t(x))
        # the routing itself agrees (a top-k tie would show here)
        _, ids, _ = tmoe._route(_t(x).reshape(12, 64))
    _, jids, _ = jmoe._route(params, jnp.asarray(x).reshape(12, 64))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    counts = np.bincount(ids.numpy().reshape(-1), minlength=8)
    assert (counts.max() > tmoe.capacity(12)) == (case == "dropping")
    assert got.shape == (2, 6, 64)
    _close(got.numpy(), ref, TOL_MOE)
    for k in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]),
                                   rtol=TOL_AUX)


# ---------------------------------------------------------------------------
# (d) the paged step and the engine on the dropless granite smoke config
# ---------------------------------------------------------------------------


def _lm_pair(seed=1, n_layers=None):
    jcfg = _jax_cfg(capacity_factor=4.0)
    tcfg = _port_cfg(capacity_factor=4.0)
    if n_layers is not None:
        jcfg, tcfg = (c.with_(n_layers=n_layers) for c in (jcfg, tcfg))
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.key(seed))
    tmodel = LM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np_tree(params), tmodel),
                           strict=False)
    return jcfg, jmodel, params, tmodel


def test_paged_step_logits_match_reference():
    jcfg, jmodel, params, tmodel = _lm_pair()
    rng = np.random.default_rng(5)
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
        tl = tmodel.paged_step(_t(tokens), _t(pos), _t(n_new), tcache,
                               _t(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=TOL_STEP, rtol=TOL_STEP)
        return np.asarray(jl)

    logits = step(chunk, np.zeros(b, np.int32), prompt_lens)
    pos = prompt_lens.copy()
    for _ in range(3):
        tok = logits[:, 0].argmax(-1).astype(np.int32)[:, None]
        logits = step(tok, pos, np.ones(b, np.int32))
        pos += 1


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_engine_greedy_tokens_match_reference_engine(quant):
    jcfg, jmodel, params, tmodel = _lm_pair(seed=2)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 5)]
    knobs = dict(max_slots=3, page_size=4, total_pages=24,
                 max_pages_per_seq=6, token_budget=8, prefill_chunk=8)
    jq = jquant.QuantConfig(weights=True, kv=True) if quant else None
    ref = JaxServingEngine(jmodel, params, JaxEngineConfig(
        backend="xla", metrics=False, quant=jq, **knobs)).run(prompts, N_NEW)
    eng = ServingEngine(tmodel, EngineConfig(
        quant=QuantConfig(weights=True, kv=True) if quant else None,
        **knobs), device="cpu")
    got = eng.run(prompts, N_NEW)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    ffn = eng.model.layers[0].ffn
    assert (ffn.up.dtype == torch.int8) == quant
    assert (ffn.down_scale is not None) == quant


# ---------------------------------------------------------------------------
# (e) checkpoints, the cast, and what the port refuses
# ---------------------------------------------------------------------------


def test_from_jax_params_loads_moe_and_quantized_trees():
    jcfg, jmodel, params, tmodel = _lm_pair(seed=3, n_layers=2)
    tree = _np_tree(params)
    scan = tree["stack"]["scan"][0]["ffn"]
    for i in range(2):
        ffn = tmodel.layers[i].ffn
        for name in ("router", "up", "gate", "down"):
            np.testing.assert_array_equal(getattr(ffn, name).detach().numpy(),
                                          scan[name][i])
    # a quantize_tree-rewritten tree into a quantized port model
    qp, _ = jquant.quantize_tree(params, jmodel.spec())
    qtree = _np_tree(qp)
    qscan = qtree["stack"]["scan"][0]["ffn"]
    qmodel = quantize_model(LM(_port_cfg(capacity_factor=4.0).with_(
        n_layers=2), device="cpu", generator=torch.Generator().manual_seed(9)))
    qmodel.load_state_dict(from_jax_params(qtree, qmodel), strict=False)
    for i in range(2):
        ffn = qmodel.layers[i].ffn
        for name in ("up", "gate", "down"):
            assert getattr(ffn, name).dtype == torch.int8
            np.testing.assert_array_equal(getattr(ffn, name).numpy(),
                                          qscan[name][i])
            np.testing.assert_array_equal(
                getattr(ffn, f"{name}_scale").numpy(),
                qscan[f"{name}_scale"][i])
    # the same as quantizing on the port's side
    quantize_model(tmodel)
    got_sd, ref_sd = qmodel.state_dict(), tmodel.state_dict()
    assert set(got_sd) == set(ref_sd)
    for k in ref_sd:
        assert torch.equal(got_sd[k], ref_sd[k]), k
    # an unquantized model refuses the quantized tree
    plain = LM(_port_cfg(capacity_factor=4.0).with_(n_layers=2),
               device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="up_scale"):
        from_jax_params(qtree, plain)


def test_engine_quantizes_f32_experts_and_keeps_f32_router_and_scales():
    """The engine quantizes before it casts to the bf16 compute dtype, and
    the cast leaves the router and the expert scales in f32."""
    _, jmodel, params, tmodel = _lm_pair(seed=4, n_layers=1)
    tmodel.cfg = tmodel.cfg.with_(dtype="bfloat16")
    eng = ServingEngine(tmodel, EngineConfig(
        max_slots=2, page_size=4, total_pages=8, max_pages_per_seq=4,
        quant=QuantConfig(weights=True, kv=True)), device="cpu")
    qp, _ = jquant.quantize_tree(params, jmodel.spec())
    qffn = _np_tree(qp)["stack"]["scan"][0]["ffn"]
    ffn = eng.model.layers[0].ffn
    assert ffn.router.dtype == torch.float32
    np.testing.assert_array_equal(ffn.router.detach().numpy(),
                                  qffn["router"][0])
    for name in ("up", "gate", "down"):
        np.testing.assert_array_equal(getattr(ffn, name).numpy(),
                                      qffn[name][0])
        assert getattr(ffn, f"{name}_scale").dtype == torch.float32
        np.testing.assert_array_equal(getattr(ffn, f"{name}_scale").numpy(),
                                      qffn[f"{name}_scale"][0])
    assert eng.model.layers[0].attn.wq.weight.dtype == torch.bfloat16
    assert len(eng.run([np.asarray([5, 6, 7], np.int32)], 3)[0]) == 3


def test_dropless_guard_raises_as_the_reference():
    knobs = dict(max_slots=2, page_size=4, total_pages=8, max_pages_per_seq=4)
    jmodel = build_model(_jax_cfg().with_(n_layers=1))
    with pytest.raises(NotImplementedError, match="capacity"):
        JaxServingEngine(jmodel, None, JaxEngineConfig(**knobs))
    model = LM(get_config(ARCH, smoke=True).with_(n_layers=1), device="cpu",
               generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="capacity"):
        ServingEngine(model, EngineConfig(**knobs), device="cpu")
    # dropless is accepted
    ServingEngine(LM(_port_cfg(capacity_factor=4.0).with_(n_layers=1),
                     device="cpu"), EngineConfig(**knobs), device="cpu")


def test_int8_5d_junction_refuses_a_gradient():
    """The int8 expert-batched junction is inference only, as the JAX
    package's quantized junction has no VJP; the full-width 5-D junction
    trains (``tests/test_torch_moe_train.py``)."""
    bp, x, w, b = _batched_junction(7)
    idx = _t(bp.block_idx).int()
    q, s = quantize_slab(_t(w))
    with pytest.raises(ValueError, match="no gradient"):
        ops.csd_matmul(_t(x).requires_grad_(True), q, idx, w_scale=s)
    with pytest.raises(ValueError, match="no gradient"):
        ops.csd_matmul(_t(x), q, idx, bias=_t(b).requires_grad_(True),
                       w_scale=s)
    with torch.no_grad(), pytest.raises(ValueError, match="expert count"):
        ops.csd_matmul(_t(x)[:2], _t(w), idx)
    model = LM(_port_cfg(capacity_factor=4.0).with_(n_layers=1),
               device="cpu", generator=torch.Generator().manual_seed(0))
    quantize_model(model)
    tokens = torch.zeros((1, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="no gradient"):
        model.loss({"tokens": tokens, "labels": tokens})
    # the CUDA wrappers refuse CPU tensors rather than running the plain
    # version in their place
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_fwd_batched_cuda(_t(x), _t(w), idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_fwd_batched_cuda(_t(x), q, idx, w_scale=s)
    assert csd_spmm.csd_spmm_fwd_batched_cuda.launches == 0
    assert csd_spmm.csd_spmm_fwd_quant_batched_cuda.launches == 0
