"""The port's DiLoCo outer loop against the JAX trainer's, on the CPU in f32.

``Trainer.diloco_sync`` works parameter by parameter and in place: the
anchor, outer momentum and error-feedback buffers are the only copies, and
a parameter never shares storage with its anchor. One sync on random
tensors is held against the JAX ``Trainer.diloco_sync`` (no mesh: the
local compressed mean), then a 4-step ``fit`` with ``diloco_period=2`` on
gemma3-4b's smoke configuration against the JAX ``Trainer.fit`` from the
same parameters (moved with ``convert.from_jax_params``) and batches.

Tolerances: a sync on the same inputs within ``SYNC_TOL`` of max |JAX|
(the same f32 arithmetic: equal int8 codes and scales); the fit's losses
within ``FIT_RTOL`` (f32 sums in another order than
XLA's, as in ``tests/test_torch_train.py``). The fit's parameters are not
held to a share of their own size element by element: AdamW divides each
gradient element by its own root mean square, so an element whose gradient
is near zero turns the f32 sum-order difference into a share of the
learning rate (1.3e-3 of max |JAX| in ``layers.2.ffn.up.weight`` after one
step at lr 1e-2; at seq 16 one element of ``layers.1.attn.wo.weight`` ends
3.7e-3 apart), and where ``delta / scale`` lands within that difference of
a half, the two runs' int8 codes differ by one (210 of 280,320 elements at
the first sync), which the error feedback and the shared per-tensor scale
carry into the next sync. So each tensor's distance from the JAX run is
held to ``MOVE_TOL`` of the distance the JAX run moved it, in Frobenius
norm (at most 1.9e-3 here, 2.5e-3 at seq 16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import BigramLM as JaxBigramLM
from repro.nn import build_model
from repro.optim import adam as jadam
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.data import BigramLM
from repro_torch.nn.model import LM
from repro_torch.optim import adam
from repro_torch.train import Trainer, TrainerConfig

SYNC_TOL = 1e-6
FIT_RTOL = 1e-4
MOVE_TOL = 1e-2
SEQ, BATCH, STEPS, PERIOD = 32, 2, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small CPU steps run up
    to a hundred times slower in torch's thread pool when the test workers
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def test_diloco_sync_matches_reference_in_place():
    rng = np.random.default_rng(0)
    shapes = {"slab": (2, 3, 4, 4), "w": (5, 6), "scale": (6,)}
    start = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    cfg = dict(diloco_period=2, diloco_outer_lr=0.7,
               diloco_outer_momentum=0.9)
    jtr = JaxTrainer(None, JaxTrainerConfig(**cfg))
    jparams = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = jtr.make_diloco_state(jparams)

    model = torch.nn.Module()
    tr = Trainer(model, TrainerConfig(**cfg), device="cpu")
    params = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    dstate = tr.make_diloco_state(params)
    for name, p in params.items():
        assert not _shares_storage(p, dstate["anchor"][name])
        assert torch.equal(p, dstate["anchor"][name])
    storages = {name: p.untyped_storage().data_ptr()
                for name, p in params.items()}
    for _ in range(2):  # the second sync has momentum and error feedback
        step = {k: rng.normal(size=s).astype(np.float32) * 0.1
                for k, s in shapes.items()}
        jparams = {k: jparams[k] - step[k] for k in shapes}
        with torch.no_grad():
            for k in shapes:
                params[k].sub_(torch.from_numpy(step[k]))
        jparams, jstate = jtr.diloco_sync(jparams, jstate)
        got, dstate = tr.diloco_sync(params, dstate)
        assert got is params
        for k in shapes:
            assert params[k].untyped_storage().data_ptr() == storages[k]
            assert not _shares_storage(params[k], dstate["anchor"][k])
            assert _rel_err(params[k], jparams[k]) <= SYNC_TOL, k
            for part in ("anchor", "outer_m", "err"):
                assert _rel_err(dstate[part][k], jstate[part][k]) \
                    <= SYNC_TOL, (part, k)


def test_diloco_sync_refuses_a_pod_axis():
    tr = Trainer(torch.nn.Module(), TrainerConfig(diloco_period=1),
                 device="cpu")
    params = {"w": torch.ones(3)}
    with pytest.raises(NotImplementedError):
        tr.diloco_sync(params, tr.make_diloco_state(params), "pod")


def _port_tree(np_tree, model):
    return {n: torch.from_numpy(np.array(v))
            for n, v in from_jax_params(np_tree, model).items()}


def test_diloco_fit_matches_reference():
    """4 steps, syncs after steps 2 and 4: the losses within ``FIT_RTOL``,
    each sync within ``SYNC_TOL`` on the JAX sync's own inputs
    (teacher-forced, real parameter shapes, with momentum and error
    feedback at the second), and the final parameters' distance from the
    JAX run's within ``MOVE_TOL`` of how far that run moved each tensor
    (Frobenius norms)."""
    jcfg = jax_get_config("gemma3_4b", smoke=True)
    jmodel = build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, params)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=STEPS)
    data = dict(vocab_size=jcfg.vocab_size, seed=2)
    dcfg = dict(diloco_period=PERIOD, diloco_outer_lr=0.7,
                diloco_outer_momentum=0.9)

    ref, syncs = [], []
    jtr = JaxTrainer(jmodel, JaxTrainerConfig(
        opt=jadam.AdamWConfig(**opt), log_every=1, metrics=False, **dcfg))
    jax_sync = jtr.diloco_sync

    def recorded_sync(p, dstate, axis_name=None):
        inputs = jax.tree.map(np.asarray, (p, dstate))
        out = jax_sync(p, dstate, axis_name)
        syncs.append((inputs, jax.tree.map(np.asarray, out)))
        return out

    jtr.diloco_sync = recorded_sync
    jp = jax.tree.map(jnp.array, params)  # the step donates its inputs
    jp, _, _ = jtr.fit(JaxBigramLM(**data).iterate(BATCH, SEQ), STEPS,
                       params=jp, opt=jadam.init(jp),
                       on_step=lambda s, m: ref.append(m))
    assert len(syncs) == STEPS // PERIOD

    tmodel = LM(get_config("gemma3_4b", smoke=True), device="cpu",
                generator=torch.Generator().manual_seed(1))
    tmodel.load_state_dict(from_jax_params(np_params, tmodel), strict=False)
    got, before_sync = [], []
    trainer = Trainer(tmodel, TrainerConfig(
        opt=adam.AdamWConfig(**opt), log_every=1, metrics=False, **dcfg),
        device="cpu")
    port_sync = trainer.diloco_sync

    def checked_sync(p, dstate, axis_name=None):
        for name, t in p.items():  # no second tree: the anchor is a copy
            assert not _shares_storage(t, dstate["anchor"][name]), name
        before_sync.append({n: t.detach().clone() for n, t in p.items()})
        return port_sync(p, dstate, axis_name)

    trainer.diloco_sync = checked_sync
    tp, _, _ = trainer.fit(BigramLM(**data).iterate(BATCH, SEQ), STEPS,
                           on_step=lambda s, m: got.append(m))
    assert len(got) == len(ref) == STEPS and len(before_sync) == len(syncs)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=FIT_RTOL)
    # each sync on the JAX sync's own inputs
    for (jparams, jstate), (jout, jout_state) in syncs:
        tparams = _port_tree(jparams, tmodel)
        tstate = {k: _port_tree(v, tmodel) for k, v in jstate.items()}
        port_sync(tparams, tstate)
        want = from_jax_params(jout, tmodel)
        for name, t in tparams.items():
            assert _rel_err(t, want[name]) <= SYNC_TOL, name
        for part in ("anchor", "outer_m", "err"):
            want = from_jax_params(jout_state[part], tmodel)
            for name, t in tstate[part].items():
                assert _rel_err(t, want[name]) <= SYNC_TOL, (part, name)
    # the whole trajectory, against how far it moved each tensor (2-norms)
    init = from_jax_params(np_params, tmodel)
    want = from_jax_params(jax.tree.map(np.asarray, jp), tmodel)
    for name, t in tp.items():
        w = np.asarray(want[name], np.float64)
        moved = np.linalg.norm(w - np.asarray(init[name], np.float64))
        err = np.linalg.norm(t.detach().numpy().astype(np.float64) - w)
        assert err <= MOVE_TOL * moved, (name, err / moved)
    # the live parameters are the model's, synced in place
    assert tp["embed.table"] is tmodel.embed.table
