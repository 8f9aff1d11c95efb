"""The paper MLP slice of the port against the JAX package, on the CPU.

The synthetic datasets bit for bit; the storage model; ``SparseMLP``'s
weight counts at the paper's configurations; ``SparseLinear`` forward and
gradients in every mode against ``jax.vjp`` of the JAX ``SparseLinear``;
the plain small-block forward, dx and dw (the blocks of 16 x 4, 4 x 4,
1 x 2 and 4 x 10 the paper MLP runs) against the Pallas kernels in
interpret mode; the port's version of
``tests/test_data_mlp.py::test_mlp_gather_equals_mask_training_dynamics``;
and ``train_mlp`` from the JAX init against the JAX ``train_mlp``. Inputs
are made with numpy from seeds; parameters move over with
``repro_torch.convert.mlp_from_jax_params``. The CUDA small-block forms
are held against the same plain versions on the card
(``tests/test_torch_small_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_mlp as jcfg
from repro.core import sparse_linear as jsl
from repro.core import storage as jstorage
from repro.core.block_pattern import make_block_pattern
from repro.data import synthetic_features as j_features
from repro.data import synthetic_mnist as j_mnist
from repro.kernels import csd_spmm as jcsd
from repro.nn import mlp as jmlp
from repro_torch.configs import paper_mlp
from repro_torch.convert import mlp_from_jax_params
from repro_torch.core import sparse_linear, storage
from repro_torch.data import synthetic_features, synthetic_mnist
from repro_torch.kernels import csd_spmm
from repro_torch.nn import mlp

F32_TOL = 1e-5


def _close(got, ref, tol=F32_TOL):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), (err, np.abs(ref).max())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# data and the storage model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mnist", "mnist_crop", "features"])
def test_synthetic_data_bit_for_bit(kind):
    if kind == "features":
        kw = dict(n_train=300, n_test=50, n_classes=39, n_features=39,
                  seed=4)
        ours, ref = synthetic_features(**kw), j_features(**kw)
    else:
        kw = dict(n_train=200, n_test=40, seed=3)
        if kind == "mnist_crop":
            kw["n_features"] = 200
        ours, ref = synthetic_mnist(**kw), j_mnist(**kw)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_storage_model_matches_jax():
    for d_in in (None, (160, 100)):
        assert dataclasses.asdict(storage.storage_cost(
            paper_mlp.MNIST_2J, d_in)) == dataclasses.asdict(
                jstorage.storage_cost(jcfg.MNIST_2J, d_in))
    assert storage.storage_cost(paper_mlp.MNIST_2J).total \
        == jstorage.storage_cost(jcfg.MNIST_2J).total
    assert storage.junction_cycles(16000, 200) \
        == jstorage.junction_cycles(16000, 200)
    assert storage.balanced_z([16000, 1000], 210) \
        == jstorage.balanced_z([16000, 1000], 210)


# ---------------------------------------------------------------------------
# weight counts at the paper's configurations
# ---------------------------------------------------------------------------

PAPER_CONFIGS = {
    "table1": dict(n_net=paper_mlp.MNIST_2J,
                   rho=paper_mlp.rho_from_dout(paper_mlp.MNIST_2J, (20, 10))),
    "mnist4j_80": dict(n_net=paper_mlp.MNIST_4J,
                       rho=paper_mlp.rho_from_dout(paper_mlp.MNIST_4J,
                                                   (80, 80, 80, 10))),
    "mnist4j_1": dict(n_net=paper_mlp.MNIST_4J,
                      rho=paper_mlp.rho_from_dout(paper_mlp.MNIST_4J,
                                                  (1, 2, 2, 10))),
    "cifar": dict(n_net=paper_mlp.CIFAR_MLP, rho=(0.2, 0.5)),
    "timit": dict(n_net=paper_mlp.TIMIT, rho=(0.2, 0.2)),
    "fig9": dict(n_net=(800, 400, 10), rho=(0.046, 1.0)),
}


@pytest.mark.parametrize("name", list(PAPER_CONFIGS))
def test_n_weights_match_jax(name):
    kw = PAPER_CONFIGS[name]
    for mode in ("block_gather", "mask"):
        ours = mlp.SparseMLP(mlp.MLPConfig(mode=mode, **kw), device="cpu")
        ref = jmlp.SparseMLP(jmlp.MLPConfig(mode=mode, **kw))
        assert ours.n_weights() == ref.n_weights()
        assert ours.density() == ref.density()
        assert [l.mode for l in ours.layers] \
            == [l._mode for l in ref.layers]


def test_table1_weight_count_and_configs():
    m = mlp.SparseMLP(paper_mlp.table1_sparse(), device="cpu")
    assert m.n_weights() == 17000  # Table I sparse |W|
    assert abs(m.density() - 0.21) < 0.005
    assert paper_mlp.table1_sparse() == mlp.MLPConfig(
        **dataclasses.asdict(jcfg.table1_sparse()))
    assert paper_mlp.table1_fc() == mlp.MLPConfig(
        **dataclasses.asdict(jcfg.table1_fc()))
    assert paper_mlp.TABLE2_MNIST == jcfg.TABLE2_MNIST
    for n in ("MNIST_2J", "MNIST_4J", "REUTERS", "TIMIT", "CIFAR_MLP"):
        assert getattr(paper_mlp, n) == getattr(jcfg, n)


# ---------------------------------------------------------------------------
# SparseLinear in every mode against jax.vjp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "mask", "gather", "block_gather",
                                  "block_scatter"])
@pytest.mark.parametrize("activation", [None, "relu"])
def test_sparse_linear_matches_jax(mode, activation):
    spec_kw = dict(n_in=64, n_out=40, rho=0.5, mode=mode, block_in=16,
                   block_out=4, seed=3)
    ref_layer = jsl.SparseLinear(jsl.SparseLinearSpec(**spec_kw))
    ours = sparse_linear.SparseLinear(
        sparse_linear.SparseLinearSpec(**spec_kw), device="cpu")
    assert ours.mode == ref_layer._mode
    assert ours.n_weights == ref_layer.n_weights
    p = ref_layer.init(jax.random.key(1))
    p["b"] = p["b"] + 0.05 * jnp.arange(40, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(24, 64)).astype(np.float32)
    dy = rng.normal(size=(24, 40)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda p_, x_: ref_layer(p_, x_, activation), p,
                         jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    with torch.no_grad():
        ours.weight.copy_(torch.as_tensor(np.array(p["w"])))
        ours.bias.copy_(torch.as_tensor(np.array(p["b"])))
    xt = torch.as_tensor(x).requires_grad_()
    y = ours(xt, activation)
    y.backward(torch.as_tensor(dy))
    _close(y, y_ref)
    _close(xt.grad, gx)
    _close(ours.weight.grad, gp["w"])
    _close(ours.bias.grad, gp["b"])


def test_layout_conversions_match_jax():
    spec = jsl.SparseLinearSpec(n_in=48, n_out=24, rho=0.5, mode="gather",
                                seed=1)
    layer = jsl.SparseLinear(spec)
    w = np.array(layer.init(jax.random.key(0))["w"])
    idx = layer.pattern.idx
    dense = sparse_linear.gather_weights_to_dense(torch.as_tensor(w), idx, 48)
    _close(dense, jsl.gather_weights_to_dense(jnp.asarray(w), idx, 48), 0)
    _close(sparse_linear.dense_weights_to_gather(dense, idx), w, 0)
    bp = make_block_pattern(64, 16, 0.5, block_in=16, block_out=4, seed=2)
    slab = np.random.default_rng(0).normal(size=(bp.n_rb, bp.d_in_b, 16, 4))
    _close(sparse_linear.block_weights_to_dense(torch.as_tensor(slab), bp),
           jsl.block_weights_to_dense(jnp.asarray(slab, jnp.float32), bp), 0)


# ---------------------------------------------------------------------------
# the plain small-block forms against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# (n_in, n_out, bL, bR, rho, experts, dtype, activation, bias)
SMALL_CASES = [
    (160, 40, 16, 4, 0.2, None, "float32", "relu", True),
    (40, 40, 4, 4, 0.5, None, "bfloat16", "gelu", True),
    (13, 26, 1, 2, 0.3, None, "float32", "relu", False),
    (40, 40, 4, 10, 0.5, 2, "float32", "gelu", True),
]


@pytest.mark.parametrize("case", SMALL_CASES,
                         ids=[f"{c[2]}x{c[3]}_{c[6]}_{c[7]}"
                              + ("_5d" if c[5] else "") for c in SMALL_CASES])
def test_small_block_plain_matches_pallas_interpret(case):
    n_in, n_out, bl, br, rho, e, dtype, act, bias = case
    tol = F32_TOL if dtype == "float32" else 2e-2
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br,
                            seed=5)
    rng = np.random.default_rng(6)
    lead = () if e is None else (e,)
    arrs = [jnp.asarray(rng.normal(size=lead + s), dtype) for s in (
        (16, n_in), (bp.n_rb, bp.d_in_b, bl, br), (n_out,), (16, n_out),
        (16, n_out))]
    x, w, b, dy, aux = arrs
    tx, tw, tb, tdy, taux = (torch.as_tensor(np.array(
        a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in arrs)
    form = "" if e is None else "_batched"
    kb = dict(bias=b if bias else None, activation=act)
    y, z = jcsd.csd_spmm_fwd(x, w, bp.block_idx, save_preact=True,
                             block_m=8, interpret=True, **kb)
    ty, tz = getattr(csd_spmm, f"csd_spmm_fwd{form}_plain")(
        tx, tw, torch.as_tensor(bp.block_idx), bias=tb if bias else None,
        activation=act, save_preact=True)
    _close(ty, y, tol)
    _close(tz, z, tol)
    dx = jcsd.csd_spmm_dx(dy, w, bp.out_idx, bp.out_slot, aux=aux,
                          activation=act, block_m=8, interpret=True)
    tdx = getattr(csd_spmm, f"csd_spmm_dx{form}_plain")(
        tdy, tw, torch.as_tensor(bp.out_idx), torch.as_tensor(bp.out_slot),
        aux=taux, activation=act)
    _close(tdx, dx, tol)
    dw, db = jcsd.csd_spmm_dw(x, dy, bp.block_idx, block_in=bl, block_out=br,
                              aux=aux, activation=act, want_db=True,
                              block_m=8, interpret=True)
    tdw, tdb = getattr(csd_spmm, f"csd_spmm_dw{form}_plain")(
        tx, tdy, torch.as_tensor(bp.block_idx), block_in=bl, block_out=br,
        aux=taux, activation=act, want_db=True)
    _close(tdw, dw, tol)
    _close(tdb, db, tol)


# ---------------------------------------------------------------------------
# the model and its training loop
# ---------------------------------------------------------------------------


def test_mlp_gather_equals_mask_training_dynamics():
    """mode='mask' and mode='gather' give the same loss and, on the
    existing edges, the same gradient: masked-dense training is per-edge
    training (the port's version of the JAX package's test)."""
    data = synthetic_mnist(n_train=600, n_test=100, seed=1)
    rho = paper_mlp.rho_from_dout(paper_mlp.MNIST_2J, (20, 10))
    lm, lg = (mlp.SparseMLP(mlp.MLPConfig(
        n_net=paper_mlp.MNIST_2J, rho=rho, mode=mode, method="clashfree",
        seed=5), device="cpu") for mode in ("mask", "gather"))
    x = torch.as_tensor(data[0][:64])
    y = torch.as_tensor(data[1][:64])
    with torch.no_grad():
        for layer_m, layer_g in zip(lm.layers, lg.layers):
            if layer_g.mode == "gather":
                layer_m.weight.copy_(sparse_linear.gather_weights_to_dense(
                    layer_g.weight, layer_g.pattern.idx, layer_g.spec.n_in))
            else:
                layer_m.weight.copy_(layer_g.weight)
            layer_m.bias.copy_(layer_g.bias)
    l_m, l_g = lm.loss(x, y), lg.loss(x, y)
    np.testing.assert_allclose(l_m.item(), l_g.item(), rtol=1e-5)
    l_m.backward()
    l_g.backward()
    gm = sparse_linear.dense_weights_to_gather(lm.layers[0].weight.grad,
                                               lg.layers[0].pattern.idx)
    np.testing.assert_allclose(gm.numpy(), lg.layers[0].weight.grad.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["table1_block", "timit_block",
                                  "table1_mask"])
def test_train_mlp_matches_jax(name):
    """``train_mlp`` from the JAX init: 2 epochs of 8 batches of 64, the
    same batches; final parameters within 1e-4 of max |JAX| (the Adam steps
    amplify f32 rounding differences of the two frameworks' sums) and the
    same test accuracy."""
    if name.startswith("table1"):
        kw = dict(n_net=paper_mlp.MNIST_2J,
                  rho=paper_mlp.rho_from_dout(paper_mlp.MNIST_2J, (20, 10)))
        data = synthetic_mnist(n_train=512, n_test=128, seed=2)
    else:
        kw = dict(n_net=paper_mlp.TIMIT, rho=(0.2, 0.2))
        data = synthetic_features(n_train=512, n_test=128, n_classes=39,
                                  n_features=39, seed=2)
    mode = "mask" if name.endswith("mask") else "block_gather"
    cfg = dict(mode=mode, seed=1, **kw)
    ref_model = jmlp.SparseMLP(jmlp.MLPConfig(**cfg))
    ref_params, ref_acc = jmlp.train_mlp(ref_model, data, epochs=2,
                                         batch=64, seed=3)
    model = mlp.SparseMLP(mlp.MLPConfig(**cfg), device="cpu")
    init = mlp_from_jax_params(_np_tree(ref_model.init(jax.random.key(3))),
                               model)
    losses = []
    params, acc = mlp.train_mlp(model, data, epochs=2, batch=64, seed=3,
                                params=init,
                                on_step=lambda t, l: losses.append(float(l)))
    assert len(losses) == 16 and all(np.isfinite(losses))
    ref = mlp_from_jax_params(_np_tree(ref_params), model)
    for k in params:
        _close(params[k], ref[k].numpy(), 1e-4)
    assert acc == ref_acc


def test_sparse_mlp_defaults_to_the_card():
    """The model is an entry point: it asks for the card unless the caller
    names the CPU, and raises where there is none."""
    if torch.cuda.is_available():
        model = mlp.SparseMLP(paper_mlp.table1_sparse())
        assert model.layers[0].weight.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlp.SparseMLP(paper_mlp.table1_sparse())
