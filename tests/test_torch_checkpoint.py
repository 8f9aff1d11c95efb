"""The port's checkpointing, restart and compression (``train.checkpoint``,
``train.fault_tolerance``, ``optim.compression``, the CLI's restart loop)
against the JAX package and against an uncut run, on the CPU in f32.

Tolerances: the int8 codes and scales are equal (the same f32 arithmetic,
a division then a round half to even); the error-feedback residual is
within ``ERR_TOL`` of max |residual| (one rounding of a product). A
checkpoint restores bit for bit, and a run cut by a simulated failure and
resumed from its checkpoint equals the uncut run bit for bit: the same
operations on the same CPU.
"""
import ast
import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro.train import CheckpointManager as JaxCheckpointManager
from repro_torch.data import BigramLM
from repro_torch.launch import train as train_cli
from repro_torch.nn.common import ModelConfig
from repro_torch.nn.model import LM
from repro_torch.optim import (AdamWConfig, compress_with_feedback,
                               compression_ratio, dequantize_int8,
                               psum_compressed_tree, quantize_int8)
from repro_torch.train import (CheckpointManager, HeartbeatMonitor,
                               RestartLoop, RestartPolicy, Trainer,
                               TrainerConfig, remesh_plan)

ERR_TOL = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its many small CPU steps run up
    to a hundred times slower in torch's thread pool when the test workers
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_model(seed=0):
    cfg = ModelConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=128, loss_chunk=16,
                      dtype="float32", remat=False)
    return LM(cfg, device="cpu",
              generator=torch.Generator().manual_seed(seed)), cfg


# ---------------------------------------------------------------------------
# checkpoints (the port's versions of tests/test_train.py's)
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_resume(tmp_path):
    model, cfg = _tiny_model()
    data = BigramLM(vocab_size=cfg.vocab_size, seed=1)
    d = str(tmp_path)
    tc = TrainerConfig(opt=AdamWConfig(lr=1e-3, total_steps=30),
                       checkpoint_dir=d, checkpoint_every=10)
    tr = Trainer(model, tc, device="cpu")
    tr.fit(data.iterate(8, 16), steps=20, on_step=lambda s, m: None)
    # a new trainer resumes from step 20 and finishes
    tr2 = Trainer(model, tc, device="cpu")
    _, o2, hist = tr2.fit(data.iterate(8, 16, start_step=20), steps=30,
                          resume=True, on_step=lambda s, m: None)
    assert hist[0]["step"] > 20
    assert o2["step"] == 30
    assert CheckpointManager(d).latest_step() == 30


def test_checkpoint_integrity_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    mgr.save(5, tree)
    path = os.path.join(str(tmp_path), "step_00000005", "shard-00000.npz")
    data = dict(np.load(path))
    data["a"] = data["a"] + 1.0
    np.savez(path, **data)
    live = {"a": torch.zeros(10), "b": {"c": torch.zeros((3, 3))}}
    with pytest.raises(IOError):
        mgr.restore(5, live)
    # nothing was written into the live state
    assert not live["a"].any() and not live["b"]["c"].any()


def test_checkpoint_with_a_flipped_byte_raises_ioerror(tmp_path):
    """A byte flipped in the shard's data (the zip layer's CRC catches it
    before the SHA-1 does) is an ``IOError`` too."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"w": torch.arange(4096.0)})
    path = os.path.join(str(tmp_path), "step_00000002", "shard-00000.npz")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError):
        mgr.restore(2, {"w": torch.zeros(4096)})


def test_checkpoint_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.ones(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]


def test_async_save_is_a_snapshot_taken_before_the_next_step(tmp_path):
    """``save(async_=True)`` returns before the write; the optimizer step
    after it changes the parameters and moments in place. The checkpoint
    must hold the values at the save, on the CPU too (where
    ``Tensor.cpu()`` is the live storage)."""
    model, cfg = _tiny_model()
    tr = Trainer(model, TrainerConfig(opt=AdamWConfig(lr=1e-2)),
                 device="cpu")
    params, opt = tr.init_state()
    data = BigramLM(vocab_size=cfg.vocab_size, seed=2)
    tr.train_step(params, opt, tr.to_device(data.batch(0, 4, 16)))
    at_save = {n: p.detach().clone() for n, p in params.items()}
    m_at_save = {n: m.clone() for n, m in opt["m"].items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params, "opt": opt}, async_=True)
    tr.train_step(params, opt, tr.to_device(data.batch(1, 4, 16)))
    mgr.wait()
    assert opt["step"] == 2
    assert any(not torch.equal(p, at_save[n]) for n, p in params.items())
    state, _ = mgr.restore(1, {"params": params, "opt": opt})
    assert state["opt"]["step"] == 1
    assert state["params"]["embed.table"] is params["embed.table"]
    for n, p in params.items():
        assert torch.equal(p, at_save[n]), n
        assert torch.equal(opt["m"][n], m_at_save[n]), n


def test_bf16_roundtrip_is_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(7, 33, generator=g).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("inf"), -0.0, 1e-40, float("nan")])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": x, "n": 7})
    meta = json.load(open(os.path.join(str(tmp_path), "step_00000003",
                                       "manifest.json")))["keys"]["w"]
    assert meta["dtype"] == "bfloat16" and meta["shape"] == [7, 33]
    live = {"w": torch.zeros(7, 33, dtype=torch.bfloat16), "n": 0}
    state, _ = mgr.restore(3, live)
    assert state["w"] is live["w"] and state["n"] == 7
    assert torch.equal(live["w"].view(torch.int16), x.view(torch.int16))


@pytest.mark.parametrize("save", [np.savez, np.savez_compressed])
def test_shard_reader_takes_what_numpy_writes(tmp_path, save):
    """The restore's reader (straight into the array for an uncompressed
    member, numpy's own reader otherwise) gives ``np.load``'s arrays."""
    import zipfile
    from repro_torch.train.checkpoint import _read_stored
    arrays = {"f": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
              "empty": np.zeros((0, 5), np.float32), "scalar": np.asarray(3),
              "bool": np.array([True, False]),
              "bits": np.arange(-4, 4, dtype=np.int16)}
    path = str(tmp_path / "x.npz")
    save(path, **arrays)
    with open(path, "rb") as fh, zipfile.ZipFile(fh) as zf:
        for k, want in arrays.items():
            got = _read_stored(fh, zf, k)
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(got, want)


def test_restore_refuses_another_shape(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="saved"):
        mgr.restore(1, {"w": torch.zeros(5)})


def test_manifest_and_checksums_match_the_jax_manager(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    c = rng.integers(-9, 9, size=(11,)).astype(np.int32)
    bf = torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)).to(
        torch.bfloat16)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    JaxCheckpointManager(jdir).save(
        4, {"a": jnp.asarray(a), "b": {"c": jnp.asarray(c)},
            "d": jnp.asarray(bf.view(torch.int16).numpy()).view(
                jnp.bfloat16)}, extra={"k": 1})
    CheckpointManager(tdir).save(
        4, {"a": torch.from_numpy(a), "b": {"c": torch.from_numpy(c)},
            "d": bf}, extra={"k": 1})
    want = json.load(open(os.path.join(jdir, "step_00000004",
                                       "manifest.json")))
    got = json.load(open(os.path.join(tdir, "step_00000004",
                                      "manifest.json")))
    assert set(got) == set(want)
    for k in ("step", "extra", "process_count"):
        assert got[k] == want[k], k
    assert want["keys"]["['a']"] == got["keys"]["a"]
    assert want["keys"]["['b']['c']"] == got["keys"]["b/c"]
    assert want["keys"]["['d']"] == got["keys"]["d"]    # bf16: its bytes
    for d in (jdir, tdir):
        assert sorted(os.listdir(os.path.join(d, "step_00000004"))) == [
            "COMMITTED", "manifest.json", "shard-00000.npz"]


# ---------------------------------------------------------------------------
# fault tolerance (the port's versions of tests/test_train.py's)
# ---------------------------------------------------------------------------


def test_restart_loop_recovers_from_failures():
    state = {"saved": [], "fail_at": {7, 23}}
    progress = {"step": 0}

    def step_fn(step):
        if step in state["fail_at"]:
            state["fail_at"].remove(step)
            raise RuntimeError("injected device loss")
        progress["step"] = step + 1

    loop = RestartLoop(RestartPolicy(checkpoint_every=5),
                       lambda s: state["saved"].append(s),
                       lambda: max(state["saved"] or [0]))
    loop.run(step_fn, total_steps=30)
    assert progress["step"] == 30
    assert loop.restarts == 2


def test_restart_loop_failures_reset_on_checkpoint_progress():
    saved = [0]
    state = {"fail_at": {6, 16, 26, 36}}

    def step_fn(step):
        if step in state["fail_at"]:
            state["fail_at"].remove(step)
            raise RuntimeError("injected transient fault")

    loop = RestartLoop(RestartPolicy(max_failures=3, checkpoint_every=5),
                       lambda s: saved.append(s), lambda: max(saved))
    loop.run(step_fn, total_steps=40)
    assert loop.restarts == 4

    loop2 = RestartLoop(RestartPolicy(max_failures=3, checkpoint_every=5),
                        lambda s: None, lambda: 0)

    def always_fail(step):
        raise RuntimeError("hard fault")

    with pytest.raises(RuntimeError):
        loop2.run(always_fail, total_steps=40)
    assert loop2.failures == 4


def test_heartbeat_and_stragglers():
    mon = HeartbeatMonitor(["h0", "h1", "h2"], timeout_s=10,
                           straggler_steps=3)
    now = 100.0
    mon.beat("h0", 10, now)
    mon.beat("h1", 10, now)
    mon.beat("h2", 6, now)
    assert mon.stragglers(now) == ["h2"]
    assert mon.dead(now + 5) == []
    mon.beat("h0", 11, now + 20)
    mon.beat("h2", 7, now + 20)
    assert mon.dead(now + 20) == ["h1"]
    assert set(mon.healthy(now + 20)) == {"h0", "h2"}


def test_stragglers_exclude_dead_hosts():
    mon = HeartbeatMonitor(["h0", "h1", "h2"], timeout_s=10,
                           straggler_steps=3)
    now = 100.0
    mon.beat("h0", 50, now)
    mon.beat("h1", 46, now + 20)
    mon.beat("h2", 46, now + 20)
    late = now + 20
    assert mon.dead(late) == ["h0"]
    assert mon.stragglers(late) == []
    mon.beat("h1", 55, late)
    assert mon.dead(late) == ["h0"]
    assert mon.stragglers(late) == ["h2"]


def test_remesh_plan_shrinks_to_power_of_two():
    assert remesh_plan(256, 8, 16)["data"] == 128
    plan = remesh_plan(253, 8, 16)
    assert plan["data"] == 64
    assert plan["devices_used"] == 64 * 16
    assert remesh_plan(1, 8, 16) is None


def test_ft_metrics_go_to_the_given_registry():
    from repro_torch.obs import Registry
    reg = Registry()
    mon = HeartbeatMonitor(["h0", "h1"], timeout_s=1, registry=reg)
    mon.beat("h1", 1, 0.0)
    mon.beat("h0", 3, 10.0)
    assert mon.dead(10.5) == ["h1"]
    assert reg.gauge("ft_dead_hosts").value() == 1.0
    fail = {3}

    def step_fn(step):
        if step in fail:
            fail.remove(step)
            raise RuntimeError("x")

    loop = RestartLoop(RestartPolicy(checkpoint_every=2), lambda s: None,
                       lambda: 0, registry=reg)
    loop.run(step_fn, total_steps=5)
    assert reg.counter("ft_restarts_total").value() == 1.0
    assert reg.counter("ft_failures_total").value() == 1.0


# ---------------------------------------------------------------------------
# compression against the JAX package
# ---------------------------------------------------------------------------

COMPRESSION_CASES = {
    "normal": lambda rng: rng.normal(size=(64,)) * 3,
    "matrix": lambda rng: rng.normal(size=(33, 17)) * 1e-3,
    "halves": lambda rng: np.arange(-6, 7) * 0.5,   # ties at scale 6/127
    "zeros": lambda rng: np.zeros((9,)),
}


@pytest.mark.parametrize("case", list(COMPRESSION_CASES))
def test_compression_matches_reference(case):
    rng = np.random.default_rng(1)
    x = COMPRESSION_CASES[case](rng).astype(np.float32)
    err = (rng.normal(size=x.shape) * 1e-2).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)

    jq, js, je = jcomp.compress_with_feedback(jnp.asarray(x),
                                              jnp.asarray(err))
    q, s, e = compress_with_feedback(torch.from_numpy(x),
                                     torch.from_numpy(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    je = np.asarray(je)
    assert np.abs(e.numpy() - je).max() <= ERR_TOL * max(
        np.abs(je).max(), 1e-30)

    jmean, jerr = jcomp.psum_compressed_tree({"x": jnp.asarray(x)},
                                             {"x": jnp.asarray(err)}, None)
    mean, new_err = psum_compressed_tree({"x": torch.from_numpy(x)},
                                         {"x": torch.from_numpy(err)})
    for got, want in ((mean["x"], jmean["x"]), (new_err["x"], jerr["x"])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= ERR_TOL * max(
            np.abs(want).max(), 1e-30)
    tree = {"x": torch.from_numpy(x)}
    assert compression_ratio(tree) == pytest.approx(
        jcomp.compression_ratio({"x": jnp.asarray(x)}))


def test_int8_roundtrip_and_error_feedback():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)) * 3
                         ).float()
    q, s = quantize_int8(x)
    assert (dequantize_int8(q, s) - x).abs().max() <= s / 2 + 1e-6
    err = torch.zeros_like(x)
    total = torch.zeros_like(x)
    for _ in range(50):
        q, s, err = compress_with_feedback(x, err)
        total = total + dequantize_int8(q, s)
    np.testing.assert_allclose(total / 50, x, atol=float(s) * 0.2 + 1e-4)


def test_psum_compressed_local_path():
    mean, _ = psum_compressed_tree({"a": torch.arange(8.0)},
                                   {"a": torch.zeros(8)}, None)
    np.testing.assert_allclose(mean["a"], torch.arange(8.0), atol=0.05)
    with pytest.raises(NotImplementedError):
        psum_compressed_tree({"a": torch.arange(8.0)},
                             {"a": torch.zeros(8)}, "pod")


# ---------------------------------------------------------------------------
# the CLI's restart loop: a cut and resumed run equals the uncut run
# ---------------------------------------------------------------------------


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params, opt = train_cli.main(argv)
    lines = buf.getvalue().splitlines()
    steps = [(int(ln.split(":")[0].split()[1]),
              ast.literal_eval(ln.split(": ", 1)[1]))
             for ln in lines if ln.startswith("step ")]
    return steps, lines, params, opt


def test_resume_after_simulated_failure_equals_uncut_run(tmp_path):
    common = ["--arch", "gemma3_4b", "--device", "cpu", "--steps", "6",
              "--batch", "2", "--seq", "32", "--checkpoint-every", "2"]
    cut, lines, params, opt = _cli(
        common + ["--checkpoint-dir", str(tmp_path / "cut"),
                  "--simulate-failure-at", "3"])
    uncut, _, params_u, opt_u = _cli(
        common + ["--checkpoint-dir", str(tmp_path / "uncut")])
    assert any(ln.startswith("[restart] simulated device loss")
               for ln in lines)
    assert [s for s, _ in cut] == [1, 2, 3, 4, 5, 6]
    assert [m["loss"] for _, m in cut] == [m["loss"] for _, m in uncut]
    assert [m["grad_norm"] for _, m in cut] == \
        [m["grad_norm"] for _, m in uncut]
    assert opt["step"] == opt_u["step"] == 6
    for n in params_u:
        assert torch.equal(params[n], params_u[n]), n
        assert torch.equal(opt["m"][n], opt_u["m"][n]), n
        assert torch.equal(opt["v"][n], opt_u["v"][n]), n
    # the cut run's checkpoints: step 3 (the failure), then 4 and 6
    assert CheckpointManager(str(tmp_path / "cut")).steps() == [3, 4, 6]
    a = np.load(tmp_path / "cut" / "step_00000006" / "shard-00000.npz")
    b = np.load(tmp_path / "uncut" / "step_00000006" / "shard-00000.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_failure_without_checkpoints_is_raised(tmp_path):
    with pytest.raises(RuntimeError, match="simulated device loss"):
        _cli(["--arch", "gemma3_4b", "--device", "cpu", "--steps", "2",
              "--batch", "1", "--seq", "16", "--simulate-failure-at", "1"])
