"""The port's training path against the JAX package, on the CPU in f32:
full-sequence attention, the LM loss and every gradient, one AdamW update,
the synthetic batches and a short ``Trainer.fit`` loss trajectory.

The model is gemma3-4b's smoke configuration (6 layers, d_model 64, window
16, attention and loss chunks of 16) at seq 48, so that sliding windows,
several query chunks and several loss chunks all run. The JAX parameters
are moved into the port with ``repro_torch.convert.from_jax_params``, and
the JAX gradient tree is mapped onto the port's parameter names by the same
function (it has the parameter tree's structure).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import BigramLM as JaxBigramLM
from repro.nn import build_model
from repro.nn import attention as jattention
from repro.optim import adam as jadam
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.data import BigramLM
from repro_torch.nn import attention
from repro_torch.nn.model import LM
from repro_torch.optim import adam
from repro_torch.train import Trainer, TrainerConfig

LOSS_RTOL = 1e-5   # f32 loss: sums taken in another order than XLA's
GRAD_TOL = 1e-4    # each gradient: max |port - JAX| <= GRAD_TOL * max |JAX|
ATTN_TOL = 2e-5    # f32 attention outputs and gradients, relative to max
ADAM_TOL = 1e-6    # f32 AdamW: the same arithmetic, relative to max
FIT_RTOL = 1e-4    # the loss after 3 optimizer steps
SEQ, BATCH = 48, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("gemma3_4b", smoke=True)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tmodel = LM(get_config("gemma3_4b", smoke=True), device="cpu",
                generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np(params), tmodel), strict=False)
    return jmodel, params, tmodel


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # sq, skv, causal, window, chunk, kv_chunk, softcap
    "window_span": (300, 300, True, 16, 16, None, None),    # span 128 < skv
    "kv_merge": (64, 64, True, None, 16, 16, 30.0),         # 4 KV chunks
    "padded_q": (40, 40, True, 8, 16, None, None),          # 40 % 16 != 0
    "not_causal": (24, 24, False, None, 8, None, None),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_matches_reference(case):
    sq, skv, causal, window, chunk, kv_chunk, softcap = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    b, hkv, g, dh = 2, 2, 2, 8
    q = rng.normal(size=(b, sq, hkv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
    do = rng.normal(size=(b, sq, hkv, g, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, chunk=chunk,
              kv_chunk=kv_chunk, scale=dh ** -0.5)

    def ref_fn(*qkv_do):
        out, vjp = jax.vjp(lambda *qkv: jattention.chunked_attention(
            *qkv, **kw), *qkv_do[:3])
        return out, vjp(qkv_do[3])

    ref, ref_grads = jax.jit(ref_fn)(*map(jnp.asarray, (q, k, v, do)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = attention.chunked_attention(*ts, **kw)
    got.backward(torch.from_numpy(do))
    assert _rel_err(got.detach(), ref) <= ATTN_TOL
    for t, r in zip(ts, ref_grads):
        assert _rel_err(t.grad, r) <= ATTN_TOL


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def test_lm_loss_and_every_gradient_match_reference(models):
    jmodel, params, tmodel = models
    batch = JaxBigramLM(vocab_size=jmodel.cfg.vocab_size, seed=1).batch(
        0, BATCH, SEQ)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    tmodel.zero_grad(set_to_none=True)
    loss, metrics = tmodel.loss(_torch_batch(batch))
    loss.backward()
    assert metrics["tokens"].item() == float(jmetrics["tokens"]) \
        == BATCH * SEQ
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = from_jax_params(_np(jgrads), tmodel)
    for name, p in tmodel.named_parameters():
        assert p.grad is not None, name
        assert _rel_err(p.grad, want[name]) <= GRAD_TOL, name


# ---------------------------------------------------------------------------
# optimizer, data, trainer
# ---------------------------------------------------------------------------


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(4)
    shapes = {"slab": (2, 3, 4, 4), "w": (5, 6), "scale": (6,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.5)
    jparams, jstate = params, jadam.init(params)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = adam.init(tparams)
    for _ in range(2):  # the second step has bias corrections and history
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, jstate, jm = jadam.update(
            jadam.AdamWConfig(**cfg), grads, jstate, jparams)
        tparams, tstate, tm = adam.update(
            adam.AdamWConfig(**cfg), {k: torch.from_numpy(v.copy())
                                      for k, v in grads.items()},
            tstate, tparams)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=ADAM_TOL)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=ADAM_TOL)
        for k in shapes:
            assert _rel_err(tparams[k], jparams[k]) <= ADAM_TOL, k
            assert _rel_err(tstate["m"][k], jstate["m"][k]) <= ADAM_TOL, k
            assert _rel_err(tstate["v"][k], jstate["v"][k]) <= ADAM_TOL, k
    assert tstate["step"] == int(jstate["step"]) == 2


@pytest.mark.parametrize("step,batch,seq", [(0, 2, 48), (7, 3, 17)])
def test_bigram_batches_are_bit_identical(step, batch, seq):
    got = BigramLM(vocab_size=512, seed=3).batch(step, batch, seq)
    want = JaxBigramLM(vocab_size=512, seed=3).batch(step, batch, seq)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_fit_loss_trajectory_matches_reference(models):
    jmodel, params, _ = models
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    steps = 3
    data = dict(vocab_size=jmodel.cfg.vocab_size, seed=2)

    ref = []
    jtrainer = JaxTrainer(jmodel, JaxTrainerConfig(
        opt=jadam.AdamWConfig(**opt), log_every=1, metrics=False))
    jp = jax.tree.map(jnp.array, params)  # the step donates its inputs
    jtrainer.fit(JaxBigramLM(**data).iterate(BATCH, SEQ), steps, params=jp,
                 opt=jadam.init(jp), on_step=lambda s, m: ref.append(m))

    tmodel = LM(get_config("gemma3_4b", smoke=True), device="cpu",
                generator=torch.Generator().manual_seed(1))
    tmodel.load_state_dict(from_jax_params(_np(params), tmodel), strict=False)
    got = []
    trainer = Trainer(tmodel, TrainerConfig(opt=adam.AdamWConfig(**opt),
                                            log_every=1), device="cpu")
    _, _, history = trainer.fit(BigramLM(**data).iterate(BATCH, SEQ), steps,
                                on_step=lambda s, m: got.append(m))
    assert [h["step"] for h in history] == [1, 2, 3]
    assert len(got) == len(ref) == steps
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=FIT_RTOL)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=FIT_RTOL)
    assert got[-1]["loss"] < got[0]["loss"]


def test_grad_accum_matches_one_batch(models):
    """Two micro-batches of one row give the full batch's gradients."""
    _, params, _ = models
    batch = BigramLM(vocab_size=512, seed=5).batch(0, BATCH, SEQ)
    grads = []
    for accum in (1, 2):
        tmodel = LM(get_config("gemma3_4b", smoke=True), device="cpu",
                    generator=torch.Generator().manual_seed(0))
        tmodel.load_state_dict(from_jax_params(_np(params), tmodel),
                               strict=False)
        trainer = Trainer(tmodel, TrainerConfig(
            opt=adam.AdamWConfig(lr=0.0), grad_accum=accum), device="cpu")
        p, opt = trainer.init_state()
        trainer.train_step(p, opt, trainer.to_device(batch))
        grads.append({n: t.grad.clone() for n, t in p.items()})
    for name in grads[0]:
        assert _rel_err(grads[1][name], grads[0][name]) <= GRAD_TOL, name


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = LM(get_config("gemma3_4b", smoke=True).with_(n_layers=1),
               device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
