"""The int8 junction at blocks whose bL or bR is not a multiple of 64 (the
paper MLP's 16 x 4, 4 x 4, 1 x 2, 2 x 1 and the smoke configurations' 16 x
16) against the JAX package, on the CPU.

The plain int8 forward, 4-D and expert-batched, f32 and bf16 x, against the
Pallas kernel in interpret mode and the JAX ``csd_matmul(backend="xla")``;
an int8 ``SparseLinear`` and an int8 ``SparseMLP`` (Table I's widths)
against the JAX ``SparseLinear`` / ``SparseMLP.logits`` with
``params[...]["w_scale"]``; ``mlp_from_jax_params`` with ``w_scale``; and the
int8 small-block plan (``launch.fwd_small_plan(quant=True)``): what the
wrappers route to it, its geometry and shared memory, and the grid pass
clean at the lint's int8 cases. Inputs come from numpy seeds. The CUDA
kernel is held against the plain version on the card
(``tests/test_torch_small_cuda.py``, ``chip_smoke.py`` phases 3d-3f).

Tolerances: f32 1e-5 (``test_torch_quant.py``'s: the same products, sums in
another order); bf16 x 2e-2 of max |reference| (the JAX package rounds each
slot's partial sum to bf16 in its XLA form and the output to bf16 in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core import sparse_linear as jsl
from repro.core.block_pattern import make_block_pattern
from repro.kernels import csd_spmm as jcsd
from repro.kernels import ops as jops
from repro.nn import mlp as jmlp
from repro_torch.analysis import grid_pass
from repro_torch.analysis.capture import capture_launch
from repro_torch.configs import paper_mlp
from repro_torch.convert import mlp_from_jax_params
from repro_torch.core import sparse_linear
from repro_torch.core.quant import quantize_model, quantize_slab
from repro_torch.kernels import csd_spmm, launch, ops
from repro_torch.nn import mlp

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# (n_in, n_out, bL, bR, rho): Table I's 16 x 4, Table II's 4 x 4, TIMIT's
# 1 x 2 and 2 x 1, the smoke configurations' 16 x 16
JUNCTIONS = [(160, 40, 16, 4, 0.2), (40, 40, 4, 4, 0.5), (13, 26, 1, 2, 0.3),
             (26, 13, 2, 1, 0.3), (64, 96, 16, 16, 0.5)]
IDS = [f"{j[2]}x{j[3]}" for j in JUNCTIONS]
# (bias, activation) per dtype, turned through the junctions so that every
# combination meets every block shape's neighbours
COMBOS = [(True, "relu"), (False, "gelu"), (True, None), (False, "relu"),
          (True, "gelu"), (False, None)]


def _np(t):
    return np.array(jnp.asarray(t, jnp.float32))  # a writable copy


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), (err, np.abs(ref).max())


def _junction(junction, experts, seed, m=16):
    n_in, n_out, bl, br, rho = junction
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br,
                            seed=seed)
    rng = np.random.default_rng(seed)
    lead = () if experts is None else (experts,)
    x = rng.normal(size=lead + (m, n_in)).astype(np.float32)
    w = rng.normal(size=lead + (bp.n_rb, bp.d_in_b, bl, br)).astype(
        np.float32)
    b = rng.normal(size=lead + (n_out,)).astype(np.float32)
    q, s = jquant.quantize_slab(jnp.asarray(w))
    return bp, x, np.array(q), np.array(s), b


@pytest.mark.parametrize("experts", [None, 3], ids=["4d", "5d"])
@pytest.mark.parametrize("k", range(len(JUNCTIONS)), ids=IDS)
def test_quant_small_plain_matches_pallas_and_xla(k, experts):
    """The plain int8 forward (each slot's f32 sum times its block's scale)
    at the small blocks, f32 and bf16 x, against the Pallas int8 kernel in
    interpret mode and the JAX XLA form."""
    bp, x, q, s, b = _junction(JUNCTIONS[k], experts, seed=k)
    for j, dtype in enumerate(("float32", "bfloat16")):
        with_bias, act = COMBOS[(2 * k + j + (experts or 0)) % len(COMBOS)]
        jx = jnp.asarray(x, dtype)
        jb = jnp.asarray(b, dtype) if with_bias else None
        tx = torch.as_tensor(_np(jx)).to(getattr(torch, dtype))
        tb = torch.as_tensor(_np(jb)).to(tx.dtype) if with_bias else None
        plain = csd_spmm.csd_spmm_fwd_batched_plain if experts \
            else csd_spmm.csd_spmm_fwd_plain
        got = plain(tx, torch.as_tensor(q), torch.as_tensor(bp.block_idx),
                    bias=tb, activation=act, w_scale=torch.as_tensor(s))
        assert got.dtype == tx.dtype
        pallas = jcsd.csd_spmm_fwd(
            jx, jnp.asarray(q), bp.block_idx, bias=jb, activation=act,
            block_m=8, interpret=True, w_scale=jnp.asarray(s))
        xla = jops.csd_matmul(jx, jnp.asarray(q), bp, bias=jb,
                              activation=act, backend="xla",
                              w_scale=jnp.asarray(s))
        for ref in (pallas, xla):
            _close(got, ref, TOL[dtype])
        # through csd_matmul, leading dims flattened as the model calls it
        with torch.no_grad():
            got3 = ops.csd_matmul(
                tx.reshape(tx.shape[:-2] + (4, 4, -1)), torch.as_tensor(q),
                torch.as_tensor(bp.block_idx).int(), bias=tb,
                activation=act, w_scale=torch.as_tensor(s))
        assert torch.equal(got3.reshape(got.shape), got)


@pytest.mark.parametrize("mode", ["block_gather", "block_scatter"])
def test_int8_sparse_linear_matches_jax(mode):
    """An int8 ``SparseLinear`` (``quantize_model``: the weight int8, the
    scales a buffer) against the JAX ``SparseLinear`` with ``w_scale`` in
    its parameters: the same int8 slab and scales bit for bit, outputs at
    the f32 tolerance."""
    spec_kw = dict(n_in=64, n_out=40, rho=0.5, mode=mode, block_in=16,
                   block_out=4, seed=3)
    ref_layer = jsl.SparseLinear(jsl.SparseLinearSpec(**spec_kw))
    ours = sparse_linear.SparseLinear(
        sparse_linear.SparseLinearSpec(**spec_kw), device="cpu")
    p = ref_layer.init(jax.random.key(1))
    p["b"] = p["b"] + 0.05 * jnp.arange(40, dtype=jnp.float32)
    with torch.no_grad():
        ours.weight.copy_(torch.as_tensor(np.array(p["w"])))
        ours.bias.copy_(torch.as_tensor(np.array(p["b"])))
    assert ours.w_scale is None
    quantize_model(ours)
    jq, js = jquant.quantize_slab(p["w"])
    p = dict(p, w=jq, w_scale=js)
    assert ours.weight.dtype == torch.int8 and not ours.weight.requires_grad
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ours.w_scale.numpy(), np.asarray(js))
    x = np.random.default_rng(2).normal(size=(2, 12, 64)).astype(np.float32)
    for act in (None, "relu"):
        with torch.no_grad():
            y = ours(torch.as_tensor(x), act)
        _close(y, ref_layer(p, jnp.asarray(x), act), TOL["float32"])
    quantize_model(ours)  # already quantized: left as it is
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(jq))


def _table1(seed=1):
    cfg = dict(n_net=paper_mlp.MNIST_2J, mode="block_gather", seed=seed,
               rho=paper_mlp.rho_from_dout(paper_mlp.MNIST_2J, (20, 10)))
    return jmlp.SparseMLP(jmlp.MLPConfig(**cfg)), \
        mlp.SparseMLP(mlp.MLPConfig(**cfg), device="cpu")


def _quantize_tree(model, params):
    """The JAX MLP tree with every block junction's slab int8 and its
    ``w_scale`` sibling (what ``quantize_tree`` writes for a slab)."""
    out = {}
    for i, layer in enumerate(model.layers):
        p = dict(params[f"j{i}"])
        if layer._mode.startswith("block"):
            p["w"], p["w_scale"] = jquant.quantize_slab(p["w"])
        out[f"j{i}"] = p
    return out


def test_int8_sparse_mlp_matches_jax():
    """Table I's MLP (800-100-10: 16 x 4 blocks at fan-in 20 of 800, then a
    dense 100 -> 10) from the JAX init, quantized by ``quantize_model``
    (the block junction only), against the JAX ``SparseMLP.logits`` on the
    quantized tree, a batch of 32; the accuracy on it too."""
    ref_model, model = _table1()
    params = ref_model.init(jax.random.key(3))
    model.load_params(mlp_from_jax_params(jax.tree.map(np.asarray, params),
                                          model))
    quantize_model(model)
    qparams = _quantize_tree(ref_model, params)
    x = np.random.default_rng(4).random((32, 800)).astype(np.float32)
    y = np.random.default_rng(5).integers(0, 10, 32)
    with torch.no_grad():
        logits = model.logits(torch.as_tensor(x))
    _close(logits, ref_model.logits(qparams, jnp.asarray(x)),
           TOL["float32"])
    assert model.accuracy(torch.as_tensor(x), torch.as_tensor(y)) == float(
        ref_model.accuracy(qparams, jnp.asarray(x), jnp.asarray(y)))
    assert [layer.weight.dtype for layer in model.layers] == [
        torch.int8, torch.float32]


def test_mlp_from_jax_params_carries_w_scale():
    """A quantized JAX MLP tree loads into a quantized port model bit for
    bit (slabs, scales, biases); it is refused by an unquantized model, and
    an f32 tree (or an f32 slab beside its scales) by a quantized one."""
    ref_model, model = _table1(seed=2)
    params = jax.tree.map(np.asarray, ref_model.init(jax.random.key(0)))
    qtree = jax.tree.map(np.asarray, _quantize_tree(ref_model, params))
    with pytest.raises(ValueError, match="unexpected"):
        mlp_from_jax_params(qtree, model)
    quantize_model(model)
    with pytest.raises(ValueError, match="missing"):
        mlp_from_jax_params(params, model)
    with pytest.raises(ValueError, match="int8"):  # f32 slab beside scales
        mlp_from_jax_params(dict(qtree, j0=dict(qtree["j0"],
                                                w=params["j0"]["w"])), model)
    sd = mlp_from_jax_params(qtree, model)
    assert sorted(sd) == ["layers.0.bias", "layers.0.w_scale",
                          "layers.0.weight", "layers.1.bias",
                          "layers.1.weight"]
    model.load_state_dict(sd, strict=False)
    layer = model.layers[0]
    np.testing.assert_array_equal(layer.weight.numpy(), qtree["j0"]["w"])
    np.testing.assert_array_equal(layer.w_scale.numpy(),
                                  qtree["j0"]["w_scale"])
    assert layer.w_scale.dtype == torch.float32
    for i in range(2):
        np.testing.assert_array_equal(model.layers[i].bias.detach().numpy(),
                                      qtree[f"j{i}"]["b"])


# ---------------------------------------------------------------------------
# the int8 small-block plan
# ---------------------------------------------------------------------------


def _meta_operands(junction, experts, m, dtype=torch.float32):
    n_in, n_out, bl, br, rho = junction
    bp = make_block_pattern(n_in, n_out, rho, block_in=bl, block_out=br)
    lead = () if experts is None else (experts,)
    shape = lead + (bp.n_rb, bp.d_in_b, bl, br)
    return bp, (torch.empty(lead + (m, n_in), dtype=dtype, device="meta"),
                torch.empty(shape, dtype=torch.int8, device="meta"),
                torch.empty(shape[:-2], dtype=torch.float32, device="meta"),
                torch.as_tensor(bp.block_idx, dtype=torch.int32))


@pytest.mark.parametrize("experts", [None, 3], ids=["4d", "5d"])
@pytest.mark.parametrize("k", range(len(JUNCTIONS)), ids=IDS)
def test_int8_small_blocks_route_before_the_width_check(k, experts,
                                                        monkeypatch):
    """The int8 wrappers send blocks below 64 to the int8 small-block form
    before ``_check_fwd_shapes`` (which refuses them) is reached; its plan
    is the f32 small form's geometry over an int8 slab that also reads each
    slot's scale, and the grid pass certifies it."""
    def refuse(*a, **kw):
        raise AssertionError("_check_fwd_shapes reached")

    monkeypatch.setattr(csd_spmm, "_check_fwd_shapes", refuse)
    bp, (x, q, s, idx) = _meta_operands(JUNCTIONS[k], experts, 40)
    fn = csd_spmm.csd_spmm_fwd_batched_cuda if experts \
        else csd_spmm.csd_spmm_fwd_cuda
    plan = capture_launch(fn, x, q, idx, w_scale=s, activation="relu")
    assert plan.name == "csd_spmm_fwd_quant_small"
    assert grid_pass.analyze_plan(plan, "int8 small")[0] == []
    assert plan.buffers["w"].itemsize == 1
    assert plan.buffers["w_scale"].shape == (experts or 1,) + tuple(s.shape[
        -2:])
    reads = plan.launches[0].reads(plan.launches[0].ctas(),
                                   plan.pattern_arrays())
    assert any(a.buffer == "w_scale" for a in reads)
    # the f32 small form's geometry and shared memory: the gather kernel
    # stages x, whatever the slab's type
    f32 = launch.fwd_small_plan(experts or 1, 40, bp.n_in, bp.n_rb,
                                bp.d_in_b, bp.block_in, bp.block_out,
                                "float32", has_bias=False, save_preact=False)
    assert f32.name == "csd_spmm_fwd_small"
    assert f32.dims() == plan.dims() and f32.args == plan.args
    # held on the card against the export the launcher's code shares
    assert launch.PLAN_EXPORTS[plan.name][1] == "csd_spmm_small_gather_plan"


def test_int8_small_plan_refuses_save_preact_and_counts_launches():
    """The plan takes no pre-activation (inference only); a CPU tensor is
    refused by the CUDA wrapper rather than run through the plain version,
    and no launch is counted."""
    with pytest.raises(ValueError, match="save_preact"):
        launch.fwd_small_plan(1, 8, 64, 4, 2, 16, 16, "float32",
                              has_bias=False, save_preact=True, quant=True)
    bp, x, q, s, _ = _junction(JUNCTIONS[0], None, seed=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        csd_spmm.csd_spmm_fwd_quant_small_cuda(
            torch.as_tensor(x), torch.as_tensor(q), torch.as_tensor(s),
            torch.as_tensor(bp.block_idx).int())
    assert csd_spmm.csd_spmm_fwd_quant_small_cuda.launches == 0


def test_lint_int8_small_cases_clean():
    """The lint's int8 small-block cases (``grid_pass.small_block_cases``:
    Table I, CIFAR_MLP and TIMIT's two junctions at 256 rows, the smoke
    down junction at a decode step, granite-moe's 8 smoke experts of 4
    rows) build the int8 small-block plan and are certified clean."""
    cases = [c for c in grid_pass.small_block_cases() if "quant" in c.name]
    assert len(cases) == 6
    for c in cases:
        plan = c.build()
        assert plan.name == "csd_spmm_fwd_quant_small", c.name
        assert grid_pass.analyze_plan(plan, c.name)[0] == []
        assert 0 < plan.launches[0].smem <= launch.SMEM_OPTIN


def test_quantize_slab_of_a_small_slab_matches_jax():
    """16 x 4 and 2 x 1 slabs quantize bit for bit as the JAX package's."""
    rng = np.random.default_rng(9)
    for shape in ((5, 3, 16, 4), (2, 4, 40, 2, 1)):
        w = rng.normal(size=shape).astype(np.float32)
        q, s = quantize_slab(torch.as_tensor(w))
        jq, js = jquant.quantize_slab(jnp.asarray(w))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
