"""The port's int8 serving path against the JAX package.

Quantization of slabs and KV must be bit for bit the JAX package's; the
int8 forward and the int8-page decode attention (their plain versions, on
the CPU) must match the JAX package's Pallas kernels in interpret mode and
its XLA forms; the int8 engine must give the JAX int8 engine's greedy
tokens. The CUDA kernels are held against the plain versions by
``tests/test_torch_cuda.py`` (on a card) and ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import quant as jquant
from repro.core.block_pattern import make_block_pattern
from repro.kernels import csd_spmm as jcsd
from repro.kernels import ops as jops
from repro.kernels.flash_attention import paged_decode_attention as jpaged
from repro.nn import ModelConfig as JaxModelConfig
from repro.nn import SparsityConfig as JaxSparsityConfig
from repro.nn import build_model
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.quant import (QuantConfig, dequantize_slab,
                                    quantize_model, quantize_slab)
from repro_torch.kernels import csd_spmm, flash_attention, ops
from repro_torch.nn.common import ModelConfig, SparsityConfig
from repro_torch.nn.model import LM
from repro_torch.serving import kv_cache
from repro_torch.serving.engine import EngineConfig, ServingEngine

TOL_SPMM = 1e-5    # f32: same products, different summation order
TOL_PAGED = 2e-5   # the JAX package's own int8-KV tolerance
QUANTS = {"w-only": (True, False), "w+kv": (True, True)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# (a) quantization of slabs and KV: bit for bit
# ---------------------------------------------------------------------------


def test_quantize_slab_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    w = rng.normal(scale=0.3, size=(3, 4, 16, 8)).astype(np.float32)
    w[1, 2] = 0.0                     # an all-zero block: scale 1e-12 / 127
    w[2, 0, 0, 0] = 127.5 * 0.01      # halves land on the rounding rule
    w[2, 0] *= 0.0
    w[2, 0, 0, :2] = [1.27, 0.005]
    q, s = quantize_slab(_t(w))
    jq, js = jquant.quantize_slab(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == (3, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q[1, 2] == 0).all()
    np.testing.assert_array_equal(
        dequantize_slab(q, s).numpy(),
        np.asarray(jquant.dequantize_slab(jq, js)))


def test_quantize_kv_and_write_kv_quant_match_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    b, c, hkv, dh, page, pool = 2, 3, 2, 8, 4, 6
    k_new = rng.normal(size=(b, c, hkv, dh)).astype(np.float32)
    v_new = rng.normal(scale=3.0, size=(b, c, hkv, dh)).astype(np.float32)
    v_new[1, 2] = 0.0  # an all-zero token
    q, s = kv_cache.quantize_kv(_t(k_new))
    jq, js = jkv.quantize_kv(jnp.asarray(k_new))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    phys = np.asarray([[0, 0, 3], [5, 2, 2]], np.int64)
    off = np.asarray([[1, 2, 0], [3, 0, 1]], np.int64)
    pages = [torch.zeros((pool, page, hkv, dh), dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.zeros((pool, page)) for _ in range(2)]
    kv_cache.write_kv_quant(*pages, *scales, _t(k_new), _t(v_new),
                            _t(phys), _t(off))
    ref = jkv.write_kv_quant(
        jnp.zeros((pool, page, hkv, dh), jnp.int8),
        jnp.zeros((pool, page, hkv, dh), jnp.int8),
        jnp.zeros((pool, page)), jnp.zeros((pool, page)),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(phys),
        jnp.asarray(off))
    for got, want in zip(pages + scales, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    table = np.asarray([[3, -1], [5, 2]], np.int32)
    np.testing.assert_array_equal(
        kv_cache.gather_scales(scales[0], _t(table)).numpy(),
        np.asarray(jkv.gather_scales(ref[2], jnp.asarray(table))))


# ---------------------------------------------------------------------------
# (b) the int8 forward
# ---------------------------------------------------------------------------


def _quant_junction(seed, m, n_in=64, n_out=96, bl=16, br=32, rho=0.5):
    rng = np.random.default_rng(seed)
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br,
                            seed=seed)
    x = rng.normal(size=(m, n_in)).astype(np.float32)
    w = rng.normal(size=(bp.n_rb, bp.d_in_b, bl, br)).astype(np.float32)
    b = rng.normal(size=(n_out,)).astype(np.float32)
    q, s = jquant.quantize_slab(jnp.asarray(w))
    return bp, x, np.array(q), np.array(s), b


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_quant_fwd_plain_matches_pallas_and_xla(activation, with_bias):
    m = 40
    bp, x, q, s, b = _quant_junction(3, m)
    bias = b if with_bias else None
    got = csd_spmm.csd_spmm_fwd_plain(
        _t(x), _t(q), _t(bp.block_idx),
        bias=None if bias is None else _t(bias), activation=activation,
        w_scale=_t(s))
    jb = None if bias is None else jnp.asarray(bias)
    pallas = jcsd.csd_spmm_fwd(
        jnp.asarray(x), jnp.asarray(q), bp.block_idx, bias=jb,
        activation=activation, block_m=8, interpret=True,
        w_scale=jnp.asarray(s))
    xla = jops.csd_matmul(jnp.asarray(x), jnp.asarray(q), bp, bias=jb,
                          activation=activation, backend="xla",
                          w_scale=jnp.asarray(s))
    assert got.dtype == torch.float32 and got.shape == (m, bp.n_out)
    for ref in (pallas, xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=TOL_SPMM, rtol=TOL_SPMM)
    # through csd_matmul with leading dims, as the model calls it
    with torch.no_grad():
        got3 = ops.csd_matmul(
            _t(x).reshape(4, 10, -1), _t(q), _t(bp.block_idx).int(),
            bias=None if bias is None else _t(bias), activation=activation,
            w_scale=_t(s))
    np.testing.assert_array_equal(got3.reshape(m, -1).numpy(), got.numpy())


# ---------------------------------------------------------------------------
# (g) the int8 junction is inference only and needs an int8 slab
# ---------------------------------------------------------------------------


def test_quant_matmul_rejects_training_and_dtype_mismatch():
    bp, x, q, s, _ = _quant_junction(5, 4)
    idx = _t(bp.block_idx).int()
    xt = _t(x).requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        ops.csd_matmul(xt, _t(q), idx, w_scale=_t(s))
    w32 = dequantize_slab(_t(q), _t(s))
    with torch.no_grad(), pytest.raises(ValueError, match="expected int8"):
        ops.csd_matmul(_t(x), w32, idx, w_scale=_t(s))
    with pytest.raises(ValueError, match="save_preact"):
        csd_spmm.csd_spmm_fwd_plain(_t(x), _t(q), idx, w_scale=_t(s),
                                    save_preact=True)
    with torch.no_grad(), pytest.raises(ValueError, match="w_scale"):
        ops.csd_matmul(_t(x), _t(q), idx)  # an int8 slab without scales
    # the CUDA wrappers refuse CPU tensors rather than running the plain
    # version in their place
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_fwd_cuda(_t(x), _t(q), idx, w_scale=_t(s))
    assert csd_spmm.csd_spmm_fwd_quant_cuda.launches == 0


# ---------------------------------------------------------------------------
# (c) decode attention over int8 pages
# ---------------------------------------------------------------------------


def _quant_paged_case(seed=2, b=4, hkv=2, g=3, dh=16, page=4, n_pages=5,
                      total=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, dh)).astype(np.float32)
    k8 = rng.integers(-127, 128, size=(total, page, hkv, dh)).astype(np.int8)
    v8 = rng.integers(-127, 128, size=(total, page, hkv, dh)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, size=(total, page)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, size=(total, page)).astype(np.float32)
    lengths = np.asarray([3, 11, 0, 17], np.int32)[:b]
    table = np.full((b, n_pages), -1, np.int32)
    perm = rng.permutation(total - 1)
    k = 0
    for i in range(b):
        for pg in range(-(-int(lengths[i]) // page)):
            table[i, pg] = perm[k]
            k += 1
    return q, k8, v8, ks, vs, table, lengths


@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 30.0), (6, 30.0)])
def test_quant_paged_decode_plain_matches_pallas_and_xla(window, softcap):
    q, k8, v8, ks, vs, table, lengths = _quant_paged_case()
    got = flash_attention.paged_decode_attention(
        _t(q), _t(k8), _t(v8), _t(table), _t(lengths), window=window,
        softcap=softcap, k_scale=_t(ks), v_scale=_t(vs))
    args = (jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
            jnp.asarray(table), jnp.asarray(lengths))
    for kw in (dict(backend="xla"), dict(backend="pallas", interpret=True)):
        ref = jpaged(*args, window=window, softcap=softcap,
                     k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=TOL_PAGED, rtol=TOL_PAGED)
    assert (got.numpy()[2] == 0).all()  # the empty row
    with pytest.raises(ValueError, match="together"):
        flash_attention.paged_decode_attention(
            _t(q), _t(k8), _t(v8), _t(table), _t(lengths), k_scale=_t(ks))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.paged_decode_attention_cuda(
            _t(q), _t(k8), _t(v8), _t(table), _t(lengths), k_scale=_t(ks),
            v_scale=_t(vs))
    assert flash_attention.paged_decode_attention_quant_cuda.launches == 0


# ---------------------------------------------------------------------------
# (d) the int8 engine against the JAX int8 engine
# ---------------------------------------------------------------------------

N_NEW = 8
N_LAYERS = 2


def _gemma_pair(n_layers=N_LAYERS, seed=1):
    jcfg = jax_get_config("gemma3_4b", smoke=True).with_(n_layers=n_layers)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.key(seed))
    tmodel = LM(get_config("gemma3_4b", smoke=True).with_(n_layers=n_layers),
                device="cpu", generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np_tree(params), tmodel),
                           strict=False)
    return jcfg, jmodel, params, tmodel


@pytest.mark.parametrize("quant", list(QUANTS))
def test_int8_engine_matches_reference_engine(quant):
    weights, kv = QUANTS[quant]
    jcfg, jmodel, params, tmodel = _gemma_pair()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (7, 12, 5)]
    knobs = dict(max_slots=3, page_size=4, total_pages=24,
                 max_pages_per_seq=6, token_budget=8, prefill_chunk=8)
    ref = JaxServingEngine(jmodel, params, JaxEngineConfig(
        backend="xla", metrics=False,
        quant=jquant.QuantConfig(weights=weights, kv=kv), **knobs)
    ).run(prompts, N_NEW)
    eng = ServingEngine(tmodel, EngineConfig(
        quant=QuantConfig(weights=weights, kv=kv), **knobs), device="cpu")
    got = eng.run(prompts, N_NEW)
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]
    assert eng.model.layers[0].ffn.up.weight.dtype == torch.int8
    assert (eng.cache[0]["k_pages"].dtype == torch.int8) == kv
    assert ("k_scale" in eng.cache[0]) == kv


# ---------------------------------------------------------------------------
# (e) int8 against full width: >= 99% greedy agreement
# ---------------------------------------------------------------------------


def _agreement_models():
    """The config and weights of the JAX package's
    ``test_engine_int8_token_agreement``, in the port."""
    sp = dict(enabled=True, rho_ffn=(0.5, 1.0), block_in=16, block_out=16)
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=256, loss_chunk=16, dtype="float32", remat=False)
    jmodel = build_model(JaxModelConfig(sparsity=JaxSparsityConfig(**sp),
                                        attn_chunk=16, **kw))
    params = jmodel.init(jax.random.key(0))
    cfg = ModelConfig(sparsity=SparsityConfig(**sp), **kw)

    def port_model():
        m = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        m.load_state_dict(from_jax_params(_np_tree(params), m), strict=False)
        return m
    return port_model


def _agreement_engine_cfg(**kw):
    return EngineConfig(max_slots=4, page_size=8, total_pages=32,
                        token_budget=32, prefill_chunk=8, **kw)


@pytest.mark.parametrize("kv", [False, True], ids=["w-only", "w+kv"])
def test_int8_engine_token_agreement(kv):
    port_model = _agreement_models()
    prompts = [np.arange(1, 9, dtype=np.int32),
               np.arange(3, 15, dtype=np.int32),
               np.asarray([7, 7, 11], np.int32)]
    ref = ServingEngine(port_model(), _agreement_engine_cfg(),
                        device="cpu").run(prompts, 16)
    eng = ServingEngine(port_model(), _agreement_engine_cfg(
        quant=QuantConfig(weights=True, kv=kv)), device="cpu")
    assert any(m.weight.dtype == torch.int8 for m in eng.model.modules()
               if hasattr(m, "w_scale"))
    out = eng.run(prompts, 16)
    agree = sum(int((a == b).sum()) for a, b in zip(ref, out))
    total = sum(len(a) for a in ref)
    assert agree / total >= 0.99, (agree, total)


# ---------------------------------------------------------------------------
# (f) the model's SparsityConfig.quant alone makes the engine quantize
# ---------------------------------------------------------------------------


def test_engine_quant_from_model_sparsity_config():
    cfg = get_config("gemma3_4b", smoke=True).with_(n_layers=1)
    cfg = cfg.with_(sparsity=dataclasses.replace(
        cfg.sparsity, quant=QuantConfig(kv=False)))
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    eng = ServingEngine(model, EngineConfig(
        max_slots=2, page_size=4, total_pages=8, max_pages_per_seq=4),
        device="cpu")
    assert eng.quant == QuantConfig(kv=False)
    assert eng.model.layers[0].ffn.down.weight.dtype == torch.int8
    assert eng.cache[0]["k_pages"].dtype == torch.float32
    out = eng.run([np.asarray([5, 6, 7], np.int32)], 4)
    assert len(out[0]) == 4


# ---------------------------------------------------------------------------
# (h) the engine quantizes the f32 parameters and keeps the scales in f32
# ---------------------------------------------------------------------------


def test_engine_quantizes_f32_params_and_keeps_f32_scales():
    """The compute dtype is bf16 here, so the engine's cast at load would
    round the parameters and the scales if it came first."""
    jcfg, _, params, tmodel = _gemma_pair(seed=4)
    tmodel.cfg = tmodel.cfg.with_(dtype="bfloat16")
    eng = ServingEngine(tmodel, EngineConfig(
        max_slots=2, page_size=4, total_pages=8, max_pages_per_seq=4,
        quant=QuantConfig(weights=True, kv=True)), device="cpu")
    qp, _ = jquant.quantize_tree(params, build_model(jcfg).spec())
    qtree = _np_tree(qp)
    ffn = qtree["stack"]["scan"][0]["ffn"]
    n_quant = 0
    for name in ("up", "gate", "down"):
        lin = getattr(eng.model.layers[0].ffn, name)
        assert lin.weight.dtype == torch.int8
        assert lin.w_scale.dtype == torch.float32
        assert lin.bias is None or lin.bias.dtype == torch.bfloat16
        np.testing.assert_array_equal(lin.weight.numpy(),
                                      ffn[name]["w"][0])
        np.testing.assert_array_equal(lin.w_scale.numpy(),
                                      ffn[name]["w_scale"][0])
        n_quant += 1
    assert n_quant == 3
    assert eng.model.layers[0].attn.wq.weight.dtype == torch.bfloat16
    assert eng.cache[0]["k_scale"].dtype == torch.float32
    # the quantized bf16 model serves
    out = eng.run([np.asarray([5, 6, 7], np.int32)], 3)
    assert len(out[0]) == 3


# ---------------------------------------------------------------------------
# (i) a checkpoint quantized on the JAX side loads bit for bit
# ---------------------------------------------------------------------------


def test_from_jax_params_loads_a_quantized_tree():
    jcfg, jmodel, params, _ = _gemma_pair(seed=5)
    qp, _ = jquant.quantize_tree(params, jmodel.spec())
    qtree = _np_tree(qp)
    tmodel = quantize_model(LM(
        get_config("gemma3_4b", smoke=True).with_(n_layers=N_LAYERS),
        device="cpu", generator=torch.Generator().manual_seed(9)))
    tmodel.load_state_dict(from_jax_params(qtree, tmodel), strict=False)
    for i in range(N_LAYERS):
        ffn = qtree["stack"]["scan"][0]["ffn"] if i == 0 else None
        lin = tmodel.layers[i].ffn.up
        assert lin.weight.dtype == torch.int8
        if ffn is not None:
            np.testing.assert_array_equal(lin.weight.numpy(),
                                          ffn["up"]["w"][0])
            np.testing.assert_array_equal(lin.w_scale.numpy(),
                                          ffn["up"]["w_scale"][0])
    # the same quantization on the port's side gives the same model
    ref = LM(get_config("gemma3_4b", smoke=True).with_(n_layers=N_LAYERS),
             device="cpu", generator=torch.Generator().manual_seed(0))
    ref.load_state_dict(from_jax_params(_np_tree(params), ref), strict=False)
    quantize_model(ref)
    got_sd, ref_sd = tmodel.state_dict(), ref.state_dict()
    assert set(got_sd) == set(ref_sd)
    for k in ref_sd:
        assert torch.equal(got_sd[k], ref_sd[k]), k
    # an unquantized model refuses the quantized tree
    plain = LM(get_config("gemma3_4b", smoke=True).with_(n_layers=N_LAYERS),
               device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="w_scale"):
        from_jax_params(qtree, plain)
