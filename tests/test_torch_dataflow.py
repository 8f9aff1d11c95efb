"""``csd_matmul``'s ``dataflow="scatter"`` and ``backend="dense"`` against the
JAX package's, on the CPU.

The scatter dataflow (the JAX package's ``_xla_fwd_scatter`` and
``_xla_fwd_scatter_quant``) and the dense backend (``_dense_map`` and
``_densify_slab``, one matmul) against ``jax.vjp`` of the JAX
``csd_matmul`` with ``backend="xla", dataflow="scatter"`` and
``backend="dense"``: forward and the gradients of x, the slab and the bias,
4-D and expert-batched; the int8 scatter form; a ``block_scatter``
``SparseLinear`` (which now runs the scatter sweep on the CPU); the
refusals (duplicate block pairs and int8 slabs under the dense backend,
unknown option values, a scatter call without the scatter form). On the
card the scatter dataflow runs the same kernels as the gather one, as the
JAX package's Pallas branch ignores it. Inputs come from numpy seeds.

Tolerance: f32 1e-5 of max |JAX| (the same products, sums in another
order; the dense backend sums every input, zeros included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core import sparse_linear as jsl
from repro.core.block_pattern import make_block_pattern
from repro.kernels import ops as jops
from repro_torch.core import sparse_linear
from repro_torch.kernels import csd_spmm, ops

TOL = 1e-5
# (n_in, n_out, bL, bR, rho, method): the paper MLP's 16 x 4 at fan-in 20
# of 40, a structured 16 x 16 junction of the smoke configurations' blocks
JUNCTIONS = [(160, 40, 16, 4, 0.5, "clashfree"),
             (96, 64, 16, 16, 0.5, "structured")]


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), (err, np.abs(ref).max())


def _case(k, experts, seed):
    """The pattern and (x, w, b, dy): x (2, 6, n_in) against a 4-D slab, or
    (E, 2, 6, n_in) against E expert slabs with a bias each."""
    n_in, n_out, bl, br, rho, method = JUNCTIONS[k]
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br,
                            method=method, seed=seed)
    rng = np.random.default_rng(seed)
    lead = () if experts is None else (experts,)
    arrays = [rng.normal(size=lead + s).astype(np.float32) for s in (
        (2, 6, n_in), (bp.n_rb, bp.d_in_b, bl, br), (n_out,), (2, 6, n_out))]
    arrays[2] *= 0.1
    return bp, arrays


def _pat(bp):
    return {k: torch.as_tensor(getattr(bp, k), dtype=torch.int32)
            for k in ("block_idx", "out_idx", "out_slot")}


def _port(bp, arrays, act, **kw):
    """y and the gradients of x, w, b of the port's ``csd_matmul``."""
    x, w, b, dy = (torch.as_tensor(a) for a in arrays)
    x, w, b = (t.requires_grad_() for t in (x, w, b))
    p = _pat(bp)
    y = ops.csd_matmul(x, w, p["block_idx"], bias=b, activation=act,
                       out_idx=p["out_idx"], out_slot=p["out_slot"], **kw)
    y.backward(dy)
    return y, x.grad, w.grad, b.grad


def _jax(bp, arrays, act, **kw):
    x, w, b, dy = (jnp.asarray(a) for a in arrays)
    y, vjp = jax.vjp(lambda x_, w_, b_: jops.csd_matmul(
        x_, w_, bp, bias=b_, activation=act, **kw), x, w, b)
    return (y,) + vjp(dy)


@pytest.mark.parametrize("act", [None, "relu", "gelu"])
@pytest.mark.parametrize("experts", [None, 3], ids=["4d", "5d"])
@pytest.mark.parametrize("k", [0, 1], ids=["16x4", "16x16"])
def test_scatter_matches_jax(k, experts, act, monkeypatch):
    """The scatter dataflow's forward (the plain scatter sweep) and its
    gradients against ``jax.vjp`` of the JAX XLA scatter form."""
    calls = []
    real = ops.fwd_scatter_plain
    monkeypatch.setattr(ops, "fwd_scatter_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    bp, arrays = _case(k, experts, seed=k + 7)
    got = _port(bp, arrays, act, dataflow="scatter")
    ref = _jax(bp, arrays, act, backend="xla", dataflow="scatter")
    assert calls == [1]
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("experts", [None, 3], ids=["4d", "5d"])
def test_scatter_int8_matches_jax(experts, act):
    """The int8 scatter form (each left block's int8 product times its
    block's scale, pushed into its right blocks) against the JAX
    ``_xla_fwd_scatter_quant``, and equal to the gather form's plain
    version up to summation order."""
    bp, (x, w, b, _) = _case(0, experts, seed=3)
    q, s = jquant.quantize_slab(jnp.asarray(w))
    p = _pat(bp)
    with torch.no_grad():
        got = ops.csd_matmul(
            torch.as_tensor(x), torch.as_tensor(np.array(q)), p["block_idx"],
            bias=torch.as_tensor(b), activation=act, out_idx=p["out_idx"],
            out_slot=p["out_slot"], w_scale=torch.as_tensor(np.array(s)),
            dataflow="scatter")
        gather = ops.csd_matmul(
            torch.as_tensor(x), torch.as_tensor(np.array(q)), p["block_idx"],
            bias=torch.as_tensor(b), activation=act,
            w_scale=torch.as_tensor(np.array(s)))
    ref = jops.csd_matmul(jnp.asarray(x), q, bp, bias=jnp.asarray(b),
                          activation=act, backend="xla", dataflow="scatter",
                          w_scale=s)
    _close(got, ref)
    _close(got, gather.numpy())


@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("experts", [None, 3], ids=["4d", "5d"])
@pytest.mark.parametrize("k", [0, 1], ids=["16x4", "16x16"])
def test_dense_backend_matches_jax(k, experts, act):
    """``backend="dense"``: the slab densified and one matmul, forward and
    gradients through autograd against ``jax.vjp`` of the JAX dense
    backend; the slab's gradient lies on the pattern's blocks only, as the
    sparse sweeps' does."""
    bp, arrays = _case(k, experts, seed=k + 11)
    got = _port(bp, arrays, act, backend="dense")
    ref = _jax(bp, arrays, act, backend="dense")
    for g, r in zip(got, ref):
        _close(g, r)
    sparse = _port(bp, arrays, act)
    for g, r in zip(got, sparse):
        _close(g, r.detach().numpy())


def test_densify_slab_places_every_block():
    """The dense weight holds slab block (rb, f) at rows of left block
    block_idx[rb, f] and columns of right block rb, zeros elsewhere, as
    the JAX package's ``_densify_slab`` does."""
    bp = make_block_pattern(64, 48, 0.5, block_in=16, block_out=4,
                            method="structured", seed=2)
    w = np.random.default_rng(0).normal(
        size=(bp.n_rb, bp.d_in_b, 16, 4)).astype(np.float32)
    got = ops.densify_slab(torch.as_tensor(w), _pat(bp)["block_idx"],
                           bp.n_lb)
    ref = jops._densify_slab(jnp.asarray(w), jops._Pat(bp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        got.numpy(), sparse_linear.block_weights_to_dense(
            torch.as_tensor(w), bp).numpy())


def test_dense_and_dataflow_refusals():
    """The dense backend refuses duplicate (left, right) block pairs and an
    int8 slab, as the JAX package's does; unknown backends and dataflows
    raise; the scatter dataflow needs the scatter form."""
    bp, (x, w, b, _) = _case(0, None, seed=1)
    p = _pat(bp)
    x, w = torch.as_tensor(x), torch.as_tensor(w)
    dup = p["block_idx"].clone()
    dup[0, 1] = dup[0, 0]
    with pytest.raises(ValueError, match="distinct"):
        ops.csd_matmul(x, w, dup, backend="dense")
    with torch.no_grad(), pytest.raises(ValueError, match="unquantized"):
        ops.csd_matmul(x, w.to(torch.int8), p["block_idx"],
                       w_scale=torch.ones(w.shape[:2]), backend="dense")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.csd_matmul(x, w, p["block_idx"], backend="pallas")
    with pytest.raises(ValueError, match="unknown dataflow"):
        ops.csd_matmul(x, w, p["block_idx"], dataflow="rows")
    with pytest.raises(ValueError, match="out_idx"):
        ops.csd_matmul(x, w, p["block_idx"], dataflow="scatter")


def test_scatter_on_the_card_runs_the_gather_kernels():
    """On a CUDA tensor the scatter dataflow picks the same kernel wrapper
    as the gather one (nothing launches here: the choice alone)."""
    dev = torch.device("cuda")
    for batched in (False, True):
        form = "_batched" if batched else ""
        assert ops._forward(dev, batched, "scatter", None, None) \
            is getattr(csd_spmm, f"csd_spmm_fwd{form}_cuda")
    assert ops._forward(torch.device("cpu"), False, "gather", None, None) \
        is csd_spmm.csd_spmm_fwd_plain


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_block_scatter_sparse_linear_matches_jax(quant, monkeypatch):
    """A ``block_scatter`` ``SparseLinear`` (16 x 16 blocks, gelu) runs the
    scatter sweep on the CPU and matches the JAX layer: forward and, in
    f32, the gradients of x, the slab and the bias against ``jax.vjp``; in
    int8 (``quantize_model``) the forward with ``w_scale``."""
    from repro_torch.core.quant import quantize_model
    calls = []
    real = ops.fwd_scatter_plain
    monkeypatch.setattr(ops, "fwd_scatter_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    spec_kw = dict(n_in=96, n_out=64, rho=0.5, mode="block_scatter",
                   block_in=16, block_out=16, method="structured", seed=4)
    ref_layer = jsl.SparseLinear(jsl.SparseLinearSpec(**spec_kw))
    ours = sparse_linear.SparseLinear(
        sparse_linear.SparseLinearSpec(**spec_kw), device="cpu")
    p = ref_layer.init(jax.random.key(2))
    p["b"] = p["b"] + 0.01 * jnp.arange(64, dtype=jnp.float32)
    with torch.no_grad():
        ours.weight.copy_(torch.as_tensor(np.array(p["w"])))
        ours.bias.copy_(torch.as_tensor(np.array(p["b"])))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(10, 96)).astype(np.float32)
    if quant:
        quantize_model(ours)
        jq, js = jquant.quantize_slab(p["w"])
        p = dict(p, w=jq, w_scale=js)
        with torch.no_grad():
            y = ours(torch.as_tensor(x), "gelu")
        _close(y, ref_layer(p, jnp.asarray(x), "gelu"))
        assert calls == [1]
        return
    dy = rng.normal(size=(10, 64)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda p_, x_: ref_layer(p_, x_, "gelu"), p,
                         jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    xt = torch.as_tensor(x).requires_grad_()
    y = ours(xt, "gelu")
    y.backward(torch.as_tensor(dy))
    assert calls == [1]
    _close(y, y_ref)
    _close(xt.grad, gx)
    _close(ours.weight.grad, gp["w"])
    _close(ours.bias.grad, gp["b"])
