"""Training seamless-m4t-medium (the encoder-decoder) on the port against
the JAX package on the CPU, and the bidirectional attention backward.

On the smoke configuration (2 encoder + 2 decoder layers, f32, loss chunk
16) with the JAX parameters moved over by
``repro_torch.convert.from_jax_params``: ``EncDec.loss`` and every gradient
against ``jax.value_and_grad`` of the JAX ``EncDec.loss``, with remat (each
layer and loss chunk recomputed) and without, on a batch of 24 encoder
frames and 20 decoder tokens (a loss tail of 4 past the chunk) with one
label of -1; the train CLI (``launch.train.main``) on the CPU, its batches
bit-equal to those the JAX CLI feeds its trainer (the stand-in frontend
``embeds`` included). ``flash_attention_bwd_plain`` (the backward the
training path runs on the CPU) against ``jax.vjp`` of the JAX
``chunked_attention`` bidirectional, at Sq != Skv both ways, at lengths
that leave a tail past every chunk, and at a group of 7. The JAX junctions
run on their XLA backend, the plain reference of the Pallas kernels."""
import dataclasses
import functools
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train_cli
import repro.train as jax_train
from repro.configs import get_config as jax_get_config
from repro.nn import attention as jattention
from repro.nn import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as train_cli
from repro_torch.nn.model import build_model
from repro_torch.train import Trainer

ARCH = "seamless_m4t_medium"
BATCH, FRAMES, SEQ = 2, 24, 20
LOSS_RTOL = 1e-5   # f32 loss (tests/test_torch_train.py)
GRAD_TOL = 1e-4    # each gradient, relative to max |JAX|
ATTN_TOL = 2e-5    # f32 attention gradients, relative to max |JAX|


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _jax_model():
    cfg = jax_get_config(ARCH, smoke=True)
    jmodel = jax_build_model(cfg.with_(sparsity=dataclasses.replace(
        cfg.sparsity, backend="xla")))
    return jmodel, jmodel.init(jax.random.key(0))


def _port_model(params, **changes):
    model = build_model(get_config(ARCH, smoke=True).with_(**changes),
                        device="cpu",
                        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_params(_np(params), model), strict=False)
    return model


def _batch(cfg):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1))
    labels = toks[:, 1:].astype(np.int32)
    labels[1, 3] = -1
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": labels,
            "embeds": rng.normal(size=(BATCH, FRAMES, cfg.frontend_dim))
            .astype(np.float32)}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_encdec_loss_and_every_gradient_match_reference(remat):
    """The encoder's output takes the summed gradient of both decoder
    layers' cross k and v projections; the loss counts every label but the
    -1, the 4 past the last whole chunk included."""
    jmodel, params = _jax_model()
    batch = _batch(jmodel.cfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    model = _port_model(params, remat=remat)
    trainer = Trainer(model, device="cpu")
    loss, metrics = model.loss(trainer.to_device(batch))
    loss.backward()
    assert metrics["tokens"].item() == BATCH * SEQ - 1
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = from_jax_params(_np(jgrads), model)
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert _rel_err(p.grad, want[name]) <= GRAD_TOL, name


def _jax_cli_batches(arch, argv, n):
    """The first ``n`` batches the JAX train CLI hands its trainer."""
    got = []

    def fit(self, it, steps, **kw):
        got.extend(next(it) for _ in range(n))
        return None, None, []

    with mock.patch.object(jax_train.Trainer, "fit", fit), \
            mock.patch.object(sys, "argv", ["train", "--arch", arch, *argv]):
        jax_train_cli.main()
    return got


def cli_run(arch, argv, steps):
    """Run the port's train CLI on the CPU for ``steps`` steps and check
    that its batches are the JAX CLI's bit for bit; returns (params, opt,
    the logged metrics)."""
    seen, logged = [], []
    fit = Trainer.fit

    def recording(self, it, n, on_step=None, **kw):
        def tap():
            for b in it:
                seen.append({k: np.array(v) for k, v in b.items()})
                yield b

        def log(s, m):
            logged.append(m)
            on_step(s, m)
        return fit(self, tap(), n, on_step=log, **kw)

    argv = ["--steps", str(steps), "--batch", "2", "--seq", "20"]
    with mock.patch.object(Trainer, "fit", recording):
        params, opt = train_cli.main(["--arch", arch, "--device", "cpu",
                                      *argv])
    want = _jax_cli_batches(arch, argv, steps)
    assert len(seen) == len(want) == steps
    for got_b, want_b in zip(seen, want):
        assert set(got_b) == set(want_b) == {"tokens", "labels", "embeds"}
        for k in want_b:
            assert got_b[k].dtype == want_b[k].dtype, k
            np.testing.assert_array_equal(got_b[k], want_b[k])
    assert opt["step"] == steps
    assert all(np.isfinite(m["loss"]) for m in logged)
    return params, opt, logged


def test_train_cli_trains_with_the_reference_batches():
    params, _, logged = cli_run(ARCH, [], 2)
    assert "adapter.weight" in params and len(logged) == 2


# (B, Sq, Skv, Hq, Hkv, Dh): an encoder at a length that leaves a tail
# past every chunk, a cross-attention's queries over more keys and over
# fewer, a group of 7
BWD_CASES = {
    "encoder_tail": (2, 13, 13, 4, 4, 16),
    "cross_short_q": (2, 5, 23, 4, 4, 16),
    "cross_long_q": (1, 30, 7, 4, 2, 16),
    "g7": (1, 9, 40, 14, 2, 32),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_plain_bidirectional_matches_reference_vjp(case):
    b, sq, skv, hq, hkv, dh = BWD_CASES[case]
    rng = np.random.default_rng(6)
    q, do = (rng.normal(size=(b, sq, hq, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
            for _ in range(2))
    g = hq // hkv

    def ref(q, k, v):
        o = jattention.chunked_attention(
            q.reshape(b, sq, hkv, g, dh), k, v, causal=False, window=None,
            softcap=None, chunk=4, scale=dh ** -0.5)
        return o.reshape(b, sq, hq, dh)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=False,
                                      return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                       causal=False)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(a, w) <= ATTN_TOL, name
