"""The port's full-sequence attention (``repro_torch.kernels.flash_attention``)
against the JAX package, on the CPU.

On the CPU the dispatcher and ``FlashAttention`` run the plain versions. The
forward is held to ``ref.mha_ref`` and to the Pallas ``flash_attention`` in
interpret mode over the reference's own sweep (``tests/test_kernels.py``'s
``ATTN_CASES`` and dims, its bf16 and ``q_offset`` cases), its row
log-sum-exp to JAX's logsumexp of the masked logits, the plain backward to
``jax.vjp`` of ``ref.mha_ref``, and the autograd Function to ``jax.vjp`` of
the JAX training path's ``chunked_attention`` on gemma3-4b's smoke shapes.
The ``Attention`` layer, which calls the Function, is held to the same layer
computing its attention with the port's ``chunked_attention``. Inputs are made with numpy from a seed. The CUDA kernels are held to the
plain versions by ``tests/test_torch_cuda.py`` on a card and by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.nn import attention as jattention
from repro_torch.kernels import flash_attention as fa
from test_kernels import ATTN_CASES
from test_torch_cuda import LAYER_CASES, attention_layer_against_chunked

TOL = 2e-5       # f32 forward, as the reference's sweep
BF16_TOL = 3e-2  # bf16 inputs and output, as the reference's bf16 case
BWD_TOL = 1e-4   # f32 gradients, max |port - JAX| over max |JAX|
ATTN_TOL = 2e-5  # the Function against chunked_attention, relative to max
# (B, Sq, Skv, Hq, Hkv, Dh) of the reference's sweep
DIMS = [(2, 32, 32, 4, 2, 8), (1, 16, 16, 4, 4, 16), (2, 16, 16, 8, 1, 8)]
CASE_IDS = ["causal", "full", "window", "softcap", "window_softcap"]


def _qkv(b, sq, skv, hq, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, dh)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, dh)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("kwargs", ATTN_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dims", DIMS)
def test_plain_matches_mha_ref(kwargs, dims):
    q, k, v = _qkv(*dims)
    want = ref.mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       **kwargs)
    got = fa.flash_attention_plain(_t(q), _t(k), _t(v), **kwargs)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kwargs", ATTN_CASES, ids=CASE_IDS)
def test_dispatcher_matches_pallas_interpret(kwargs):
    q, k, v = _qkv(*DIMS[0], seed=1)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=8, block_k=8, interpret=True, **kwargs)
    got = fa.flash_attention(_t(q), _t(k), _t(v), block_q=8, block_k=8,
                             **kwargs)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_bf16_matches_mha_ref():
    q, k, v = _qkv(2, 32, 32, 4, 2, 8, seed=2)
    want = ref.mha_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                       causal=True)
    got = fa.flash_attention_plain(*(_t(a).bfloat16() for a in (q, k, v)),
                                   causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float(), np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("q_offset", [0, 13, 31])
def test_q_offset_matches_mha_ref_and_pallas(q_offset):
    q, k, v = _qkv(2, 1, 32, 4, 2, 8, seed=3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=True,
                             q_offset=q_offset, block_q=1, block_k=8)
    for want in (ref.mha_ref(jq, jk, jv, causal=True, q_offset=q_offset),
                 jflash(jq, jk, jv, causal=True, q_offset=q_offset,
                        block_q=1, block_k=8, interpret=True)):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_dispatcher_keeps_the_block_check():
    q, k, v = _qkv(1, 40, 40, 2, 1, 8)
    with pytest.raises(ValueError, match="divide block sizes"):
        fa.flash_attention(_t(q), _t(k), _t(v), block_q=16, block_k=8)


def _masked_logits(q, k, *, causal, window, logit_softcap, q_offset):
    """The logits of ``ref.mha_ref`` with the masked ones at -1e30, and the
    mask, (B, Hq, Sq, Skv)."""
    groups = q.shape[2] // k.shape[2]
    kf = jnp.repeat(k, groups, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q * q.shape[-1] ** -0.5, kf)
    if logit_softcap is not None:
        s = logit_softcap * jnp.tanh(s / logit_softcap)
    qpos = jnp.arange(q.shape[1])[:, None] + q_offset
    kpos = jnp.arange(k.shape[1])[None, :]
    mask = jnp.ones((q.shape[1], k.shape[1]), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return jnp.where(mask, s, -1e30), mask


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=None, logit_softcap=None, q_offset=0),
    dict(causal=True, window=8, logit_softcap=30.0, q_offset=5),
    # queries 24.. see no key of the 16: empty rows
    dict(causal=True, window=8, logit_softcap=None, q_offset=0),
    dict(causal=False, window=None, logit_softcap=50.0, q_offset=0),
], ids=["causal", "window_softcap_offset", "empty_rows", "full_softcap"])
def test_lse_matches_logsumexp_of_masked_logits(kw):
    q, k, v = _qkv(2, 40, 16, 4, 2, 8, seed=4)
    s, mask = _masked_logits(jnp.asarray(q), jnp.asarray(k), **kw)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    o, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), return_lse=True,
                                      **kw)
    assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
    seen = np.asarray(mask.any(-1))                  # (Sq,)
    np.testing.assert_allclose(lse.numpy()[..., seen], want[..., seen],
                               atol=TOL, rtol=TOL)
    assert (lse.numpy()[..., ~seen] == -1e30).all()
    assert (o.numpy()[:, ~seen] == 0).all()
    if kw["window"] == 8 and kw["q_offset"] == 0:
        assert (~seen).sum() == 40 - 23


@pytest.mark.parametrize("kwargs", ATTN_CASES, ids=CASE_IDS)
def test_bwd_plain_matches_vjp_of_mha_ref(kwargs):
    q, k, v = _qkv(*DIMS[0], seed=5)
    do = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    o, vjp = jax.vjp(lambda *a: ref.mha_ref(*a, **kwargs),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    to, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), return_lse=True,
                                       **kwargs)
    assert _rel_err(to, o) <= TOL
    got = fa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), to, lse,
                                       _t(do), **kwargs)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= BWD_TOL


# gemma3-4b's smoke shapes: Hq 4, Hkv 2 (G 2), Dh 16, window 16, chunk 16
SMOKE = dict(b=2, s=48, hq=4, hkv=2, dh=16, chunk=16)


@pytest.mark.parametrize("window,softcap", [(16, None), (None, None),
                                            (16, 30.0)],
                         ids=["window", "global", "window_softcap"])
def test_function_matches_vjp_of_chunked_attention(window, softcap):
    b, s, hq, hkv, dh = (SMOKE[k] for k in ("b", "s", "hq", "hkv", "dh"))
    q, k, v = _qkv(b, s, s, hq, hkv, dh, seed=7)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    scale = dh ** -0.5
    jkw = dict(causal=True, window=window, softcap=softcap,
               chunk=SMOKE["chunk"], scale=scale)

    def jfn(q, k, v):
        qg = q.reshape(b, s, hkv, hq // hkv, dh)
        return jattention.chunked_attention(qg, k, v, **jkw).reshape(q.shape)

    o, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    got = fa.FlashAttention.apply(*ts, True, window, softcap, scale, 0)
    got.backward(_t(do))
    assert _rel_err(got.detach(), o) <= ATTN_TOL
    for t, w in zip(ts, want):
        assert _rel_err(t.grad, w) <= ATTN_TOL


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_attention_forward_matches_chunked_attention_on_cpu(case):
    """The layer's output, x gradient and parameter gradients: its call of
    ``FlashAttention`` (window, scale, softcap, head grouping) against
    ``chunked_attention`` from the case's own settings."""
    assert attention_layer_against_chunked(torch.device("cpu"), case) \
        <= ATTN_TOL


def test_cuda_wrappers_refuse_cpu_tensors():
    """Each wrapper launches its kernel or raises: it never runs the plain
    version, and a refused call is not counted."""
    q, k, v = (_t(a) for a in _qkv(1, 16, 16, 2, 1, 16))
    n = fa.flash_attention_cuda.launches, fa.flash_attention_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, k, v)
    lse = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_bwd_cuda(q, k, v, q, lse, q)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == n
