"""The port's MoE training path against the JAX package, on the CPU.

The expert-batched backward operations (plain versions) against the JAX
package's Pallas kernels ``csd_spmm_dx`` / ``csd_spmm_dw`` on 5-D/3-D
operands in interpret mode and against ``_xla_dx_batched`` /
``_xla_dw_batched``; the batched forward's ``save_preact``; the 5-D
``csd_matmul`` and its gradients against ``jax.vjp``; ``MoE`` forward and
backward against ``jax.grad`` of the JAX ``MoE``; ``LM.loss`` with the MoE
aux terms and every gradient, and a 3-step ``Trainer.fit``, against the
JAX package on the granite-moe smoke config at its published capacity
factor (tokens can be dropped). The CUDA kernels are held against the
plain versions by ``tests/test_torch_cuda.py`` (on a card) and
``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.block_pattern import make_block_pattern
from repro.data import BigramLM as JaxBigramLM
from repro.kernels import csd_spmm as jcsd
from repro.kernels import ops as jops
from repro.nn import build_model
from repro.nn.ffn import MoE as JaxMoE
from repro.optim import adam as jadam
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.convert import _block_name, _items, from_jax_params
from repro_torch.data import BigramLM
from repro_torch.kernels import csd_spmm, ops
from repro_torch.nn.ffn import MoE
from repro_torch.nn.model import LM
from repro_torch.optim import adam
from repro_torch.train import Trainer, TrainerConfig

ARCH = "granite_moe_1b_a400m"
# backward kernels, max |port - JAX| over max |JAX|: f32 sums in another
# order; bf16 one rounding of each output plus the XLA form's bf16 running
# sum over the (at most 4) fan slots (as tests/test_torch_kernels.py)
TOL_BWD = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_MOE_GRAD = 1e-4  # MoE gradients, f32, of max |JAX grad|
LOSS_RTOL = 1e-5     # as tests/test_torch_train.py
GRAD_TOL = 1e-4      # as tests/test_torch_train.py: of max |JAX grad|
FIT_RTOL = 1e-4      # the loss after 3 optimizer steps
E, M = 3, 16         # experts and rows per expert of the kernel cases
BATCH, SEQ = 2, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_rel(got, ref, tol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _bwd_case(seed, dtype):
    """E expert junctions of one pattern with 8 left blocks, fan-in 4 and
    fan-out 2, their cotangent and aux, in ``dtype`` as arrays for JAX and
    tensors for the port."""
    rng = np.random.default_rng(seed)
    bp = make_block_pattern(128, 128, 0.5, block_in=16, block_out=32,
                            seed=seed)
    x = rng.normal(size=(E, M, bp.n_in))
    w = rng.normal(size=(E, bp.n_rb, bp.d_in_b, 16, 32))
    dy = rng.normal(size=(E, M, bp.n_out))
    aux = rng.normal(size=(E, M, bp.n_out))
    arrs = [jnp.asarray(a, dtype) for a in (x, w, dy, aux)]
    tens = [_t(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype))
            for a in arrs]
    return bp, arrs, tens


# ---------------------------------------------------------------------------
# (a) the 5-D backward-data and backward-weights plain versions
# ---------------------------------------------------------------------------

DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_dx_batched_plain_matches_pallas_and_xla(activation, dtype):
    bp, (_, w, dy, aux), (_, tw, tdy, taux) = _bwd_case(1, dtype)
    assert bp.out_idx.shape[1] > 1  # several slots per left block
    got = csd_spmm.csd_spmm_dx_batched_plain(
        tdy, tw, _t(bp.out_idx), _t(bp.out_slot), aux=taux,
        activation=activation)
    pallas = jcsd.csd_spmm_dx(dy, w, bp.out_idx, bp.out_slot, aux=aux,
                              activation=activation, block_m=8,
                              interpret=True)
    xla = jops._xla_dx_batched(jops._mask_dy_xla(dy, aux, activation), w,
                               bp)
    assert got.dtype == tdy.dtype and got.shape == (E, M, bp.n_in)
    for ref in (pallas, xla):
        _close_rel(got, ref, TOL_BWD[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("want_db", [False, True], ids=["nodb", "db"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_dw_batched_plain_matches_pallas_and_xla(activation, want_db, dtype):
    bp, (x, _, dy, aux), (tx, _, tdy, taux) = _bwd_case(2, dtype)
    kw = dict(block_in=bp.block_in, block_out=bp.block_out,
              activation=activation, want_db=want_db)
    got = csd_spmm.csd_spmm_dw_batched_plain(tx, tdy, _t(bp.block_idx),
                                             aux=taux, **kw)
    pallas = jcsd.csd_spmm_dw(x, dy, bp.block_idx, aux=aux, block_m=8,
                              interpret=True, **kw)
    mdy = jops._mask_dy_xla(dy, aux, activation)
    xla = jops._xla_dw_batched(x, mdy, bp)
    if want_db:
        (got, db), (pallas, pallas_db) = got, pallas
        assert db.dtype == torch.float32 and db.shape == (E, bp.n_out)
        for ref in (pallas_db, jnp.sum(mdy.astype(jnp.float32), axis=1)):
            _close_rel(db, ref, TOL_BWD["float32"])
    assert got.dtype == tx.dtype
    for ref in (pallas, xla):
        _close_rel(got, ref, TOL_BWD[dtype])


# ---------------------------------------------------------------------------
# (b) the batched forward's save_preact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_batched_fwd_save_preact_matches_pallas(activation):
    bp, (x, w, _, _), (tx, tw, _, _) = _bwd_case(3, "float32")
    b = np.random.default_rng(4).normal(size=(E, bp.n_out)).astype(
        np.float32)
    y, z = csd_spmm.csd_spmm_fwd_batched_plain(
        tx, tw, _t(bp.block_idx), bias=_t(b), activation=activation,
        save_preact=True)
    ry, rz = jcsd._csd_spmm_fwd_batched(
        x, w, bp.block_idx, bias=jnp.asarray(b), activation=activation,
        save_preact=True, block_m=8, interpret=True)
    _close_rel(y, ry, TOL_BWD["float32"])
    _close_rel(z, rz, TOL_BWD["float32"])


# ---------------------------------------------------------------------------
# (c) the 5-D csd_matmul and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_batched_csd_matmul_gradients_match_jax_vjp(activation, with_bias,
                                                    backend):
    bp, _, _ = _bwd_case(5, "float32")
    rng = np.random.default_rng(6)
    # 12 rows per expert in two leading dims: the Pallas path pads them
    x = rng.normal(size=(E, 2, 6, bp.n_in)).astype(np.float32)
    w = rng.normal(size=(E, bp.n_rb, bp.d_in_b, 16, 32)).astype(np.float32)
    b = rng.normal(size=(E, bp.n_out)).astype(np.float32)
    dy = rng.normal(size=(E, 2, 6, bp.n_out)).astype(np.float32)
    kw = dict(activation=activation, backend=backend)
    if backend == "pallas":
        kw.update(interpret=True, block_m=8)

    def jfn(x_, w_, b_):
        return jops.csd_matmul(x_, w_, bp, bias=b_ if with_bias else None,
                               **kw)

    ref, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    rdx, rdw, rdb = vjp(jnp.asarray(dy))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    got = ops.csd_matmul(tx, tw, _t(bp.block_idx).int(),
                         bias=tb if with_bias else None,
                         activation=activation, out_idx=_t(bp.out_idx).int(),
                         out_slot=_t(bp.out_slot).int())
    got.backward(_t(dy))
    _close_rel(got, ref, TOL_BWD["float32"])
    _close_rel(tx.grad, rdx, TOL_BWD["float32"])
    _close_rel(tw.grad, rdw, TOL_BWD["float32"])
    if with_bias:
        assert tb.grad.shape == (E, bp.n_out)
        _close_rel(tb.grad, rdb, TOL_BWD["float32"])
    else:
        assert tb.grad is None


def test_batched_training_cuda_wrappers_refuse_cpu_tensors():
    """The expert-batched backward wrappers and the batched forward with
    ``save_preact`` launch their kernels or raise: a CPU tensor never runs
    the plain version through them."""
    bp, _, (tx, tw, tdy, taux) = _bwd_case(7, "float32")
    idx, oidx, oslot = (_t(getattr(bp, k)).int()
                        for k in ("block_idx", "out_idx", "out_slot"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_dx_batched_cuda(tdy, tw, oidx, oslot)
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_dw_batched_cuda(tx, tdy, idx, block_in=16,
                                          block_out=32, want_db=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_fwd_batched_cuda(tx, tw, idx, activation="gelu",
                                           save_preact=True)
    with pytest.raises(ValueError, match="needs aux"):
        csd_spmm.csd_spmm_dx_batched_cuda(tdy, tw, oidx, oslot,
                                          activation="relu")
    assert csd_spmm.csd_spmm_dx_batched_cuda.launches == 0
    assert csd_spmm.csd_spmm_dw_batched_cuda.launches == 0
    assert csd_spmm.csd_spmm_fwd_batched_cuda.launches == 0


# ---------------------------------------------------------------------------
# (d) MoE forward and backward against jax.grad of the JAX MoE
# ---------------------------------------------------------------------------


def _jax_cfg(**moe):
    """The JAX config of the same name, its junctions on the XLA backend
    (the JAX MoE takes its backend from the sparsity config)."""
    cfg = jax_get_config(ARCH, smoke=True)
    return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe),
                     sparsity=dataclasses.replace(cfg.sparsity,
                                                  backend="xla"))


def _port_cfg(**moe):
    cfg = get_config(ARCH, smoke=True)
    return cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))


@pytest.mark.parametrize("cf", [1.0, 4.0], ids=["dropping", "dropless"])
def test_moe_gradients_match_jax_grad(cf):
    jmoe = JaxMoE(_jax_cfg(capacity_factor=cf), seed=1)
    params = jmoe.init(jax.random.key(1))
    tmoe = MoE(_port_cfg(capacity_factor=cf), seed=1,
               generator=torch.Generator().manual_seed(0))
    tmoe.load_state_dict({_block_name(p): _t(a)
                          for p, a in _items(_np_tree(params))},
                         strict=False)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    g = rng.normal(size=(2, 6, 64)).astype(np.float32)

    def jloss(p, x_):
        y, aux = jmoe(p, x_)
        return jnp.sum(y * g) + 0.01 * aux["moe_lb"] + aux["moe_z"]

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    y, aux = tmoe(tx)
    (torch.sum(y * _t(g)) + 0.01 * aux["moe_lb"] + aux["moe_z"]).backward()
    with torch.no_grad():
        _, ids, _ = tmoe._route(tx.reshape(12, 64))
    counts = np.bincount(ids.numpy().reshape(-1), minlength=8)
    assert (counts.max() > tmoe.capacity(12)) == (cf == 1.0)
    for name, ref in _np_tree(jgp).items():
        _close_rel(getattr(tmoe, name).grad, ref, TOL_MOE_GRAD)
    _close_rel(tx.grad, jgx, TOL_MOE_GRAD)


# ---------------------------------------------------------------------------
# (e) LM.loss and every gradient; (f) a 3-step fit, on the granite smoke
# config at its own capacity factor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jmodel = build_model(_jax_cfg())
    params = jmodel.init(jax.random.key(0))
    tmodel = LM(get_config(ARCH, smoke=True), device="cpu",
                generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np_tree(params), tmodel),
                           strict=False)
    return jmodel, params, tmodel


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def test_lm_loss_aux_and_every_gradient_match_reference(models):
    jmodel, params, tmodel = models
    batch = JaxBigramLM(vocab_size=jmodel.cfg.vocab_size, seed=1).batch(
        0, BATCH, SEQ)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    tmodel.zero_grad(set_to_none=True)
    loss, metrics = tmodel.loss(_torch_batch(batch))
    loss.backward()
    assert set(metrics) == set(jmetrics) \
        == {"loss", "tokens", "moe_lb", "moe_z"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    # the aux terms are in the loss, each sum divided by the layer count
    n = tmodel.cfg.n_layers
    np.testing.assert_allclose(
        loss.item(), metrics["loss"].item() + 0.01 * metrics[
            "moe_lb"].item() / n + metrics["moe_z"].item() / n,
        rtol=1e-6)
    want = from_jax_params(_np_tree(jgrads), tmodel)
    for name, p in tmodel.named_parameters():
        assert p.grad is not None, name
        _close_rel(p.grad, want[name], GRAD_TOL)


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

    tmodel = LM(get_config(ARCH, smoke=True), device="cpu",
                generator=torch.Generator().manual_seed(1))
    tmodel.load_state_dict(from_jax_params(_np_tree(params), tmodel),
                           strict=False)
    got = []
    trainer = Trainer(tmodel, TrainerConfig(opt=adam.AdamWConfig(**opt),
                                            log_every=1), device="cpu")
    trainer.fit(BigramLM(**data).iterate(BATCH, SEQ), steps,
                on_step=lambda s, m: got.append(m))
    assert len(got) == len(ref) == steps
    for g, r in zip(got, ref):
        for k in ("loss", "grad_norm", "moe_lb", "moe_z"):
            np.testing.assert_allclose(g[k], r[k], rtol=FIT_RTOL)
