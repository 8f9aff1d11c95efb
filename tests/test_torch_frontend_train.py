"""Training llava-next-34b (a stub-frontend LM) on the port against the JAX
package on the CPU, and the dense-cache loop over mamba stacks.

On llava's smoke configuration (4 layers, G 2, f32) with the JAX
parameters moved over by ``repro_torch.convert.from_jax_params``:
``LM.loss`` on frontend embeddings (through the projector ``proj_in``,
gelu, ``proj_mid``) and every gradient against ``jax.value_and_grad`` of
the JAX ``LM.loss``, the embedding table's zero included; 3
``Trainer.fit`` steps against the JAX ``Trainer`` on the JAX CLI's batches
(float ``embeds`` kept in f32 by ``Trainer.to_device``); the train CLI on
the CPU with the JAX CLI's batches. On mamba2-130m's and zamba2-1.2b's
smoke configurations: ``prefill`` and 8 teacher-forced ``decode_step``s
against the JAX ``LM.prefill`` / ``decode_step`` (the mamba state and
zamba2's shared block over dense caches), and ``generate_cached``'s greedy
tokens against the JAX ``generate_cached``. The JAX junctions run on their
XLA backend, the plain reference of the Pallas kernels."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import generate_cached as jax_generate_cached
from repro.nn import build_model as jax_build_model
from repro.optim import adam as jadam
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.serve import generate_cached, needs_dense_loop
from repro_torch.nn.model import LM, build_model
from repro_torch.optim import adam
from repro_torch.train import Trainer, TrainerConfig
from test_torch_encdec_train import _jax_cli_batches, cli_run

ARCH = "llava_next_34b"
BATCH, SEQ = 2, 20
LOSS_RTOL = 1e-5   # f32 loss (tests/test_torch_train.py)
GRAD_TOL = 1e-4    # each gradient, relative to max |JAX|
FIT_RTOL = 1e-4    # loss and gradient norm after each of 3 steps
LOGIT_TOL = 1e-4   # dense-loop logits, of max |JAX|
SSM = ("mamba2_130m", "zamba2_1p2b")
PROMPT, S_MAX, N_DECODE, N_GEN = 6, 16, 8, 10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _jax_model(arch=ARCH):
    cfg = jax_get_config(arch, smoke=True)
    jmodel = jax_build_model(cfg.with_(sparsity=dataclasses.replace(
        cfg.sparsity, backend="xla")))
    return jmodel, jmodel.init(jax.random.key(0))


def _port_model(arch, params):
    model = build_model(get_config(arch, smoke=True), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    model.load_state_dict(from_jax_params(_np(params), model), strict=False)
    return model


# ---------------------------------------------------------------------------
# llava: loss, gradients, fit and the CLI
# ---------------------------------------------------------------------------


def test_frontend_loss_and_every_gradient_match_reference():
    jmodel, params = _jax_model()
    batch = _jax_cli_batches(ARCH, ["--batch", str(BATCH), "--seq",
                                    str(SEQ)], 1)[0]
    batch["labels"][0, 2] = -1
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    model = _port_model(ARCH, params)
    loss, metrics = model.loss(Trainer(model, device="cpu").to_device(batch))
    loss.backward()
    assert metrics["tokens"].item() == float(jmetrics["tokens"])
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = from_jax_params(_np(jgrads), model)
    # the tokens are not read: the table is off the loss's path
    assert model.embed.table.grad is None
    assert not np.asarray(want["embed.table"]).any()
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert _rel_err(got, want[name]) <= GRAD_TOL, name


def test_fit_on_frontend_embeddings_matches_reference():
    """3 AdamW steps on the JAX CLI's batches: a trainer that rounded the
    float ``embeds`` to integers would train on other inputs."""
    jmodel, params = _jax_model()
    steps = 3
    batches = _jax_cli_batches(ARCH, ["--batch", str(BATCH), "--seq",
                                      str(SEQ)], steps)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=steps)
    ref = []
    jtrainer = JaxTrainer(jmodel, JaxTrainerConfig(
        opt=jadam.AdamWConfig(**opt), log_every=1, metrics=False))
    jp = jax.tree.map(jnp.array, params)  # the step donates its inputs
    jtrainer.fit(iter(batches), steps, params=jp, opt=jadam.init(jp),
                 on_step=lambda s, m: ref.append(m))
    got = []
    trainer = Trainer(_port_model(ARCH, params), TrainerConfig(
        opt=adam.AdamWConfig(**opt), log_every=1, metrics=False),
        device="cpu")
    trainer.fit(iter(batches), steps, on_step=lambda s, m: got.append(m))
    assert len(got) == len(ref) == steps
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=FIT_RTOL)
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=FIT_RTOL)


def test_trainer_keeps_float_embeds_in_f32():
    trainer = Trainer(LM(get_config(ARCH, smoke=True).with_(n_layers=1),
                         device="cpu"), device="cpu")
    embeds = np.array([[[0.25, -1.5, 2.75]]], np.float32)
    out = trainer.to_device({"tokens": np.array([[3]], np.int32),
                             "embeds": embeds})
    assert out["tokens"].dtype == torch.long
    assert out["embeds"].dtype == torch.float32
    np.testing.assert_array_equal(out["embeds"].numpy(), embeds)


def test_train_cli_trains_with_the_reference_batches():
    params, _, logged = cli_run(ARCH, [], 2)
    assert "proj_in.weight" in params and len(logged) == 2


# ---------------------------------------------------------------------------
# the dense-cache loop over mamba stacks
# ---------------------------------------------------------------------------


def _prompt(cfg):
    rng = np.random.default_rng(4)
    return (rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (N_DECODE, BATCH, 1))
            .astype(np.int32))


@pytest.mark.parametrize("arch", SSM)
def test_ssm_prefill_and_decode_steps_match_reference(arch):
    """The prompt folded into each mamba layer's state by the chunked SSD,
    then 8 teacher-forced steps through ``Mamba2Block.decode`` (and on
    zamba2 the shared block over its dense caches)."""
    jmodel, params = _jax_model(arch)
    model = _port_model(arch, params)
    assert not needs_dense_loop(model.cfg)  # generate keeps the engine
    prompt, feed = _prompt(model.cfg)
    lg, cache = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, S_MAX))(params, jnp.asarray(prompt))
    want = [np.asarray(lg)]
    step = jax.jit(jmodel.decode_step)
    for t in feed:
        lg, cache = step(params, jnp.asarray(t), cache)
        want.append(np.asarray(lg))
    tl, tcache = model.prefill({"tokens": torch.from_numpy(prompt)}, S_MAX)
    got = [tl.numpy()] + [model.decode_step(torch.from_numpy(t), tcache)[0]
                          .numpy() for t in feed]
    assert tcache["pos"] == PROMPT + N_DECODE
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert _rel_err(g, w) <= LOGIT_TOL, i


@pytest.mark.parametrize("arch", SSM)
def test_ssm_generate_cached_greedy_tokens_match_reference(arch):
    jmodel, params = _jax_model(arch)
    prompt, _ = _prompt(jmodel.cfg)
    want, _ = jax_generate_cached(jmodel, params, jnp.asarray(prompt),
                                  S_MAX + 4, N_GEN)
    got, _ = generate_cached(_port_model(arch, params), prompt, S_MAX + 4,
                             N_GEN, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
