"""The port's Mamba2 SSD against the JAX package on the CPU.

``ssd_chunked`` and ``ssd_decode_step`` against ``repro.nn.ssm``'s on
numpy-seeded inputs (a sequence that is not a multiple of the chunk, fewer
B/C groups than heads, a state carried in, a sequence streamed in two
halves), the decode step also against a sequential recurrence in numpy
f64; then the whole ``Mamba2Block`` (forward and one-token decode) with
the JAX parameters moved over, and ``MambaLayer.paged_step``'s state
rules (inactive rows keep their state bit for bit; ``slot_ids`` address
the slots). All in f32, within 1e-5 of max |JAX|."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.nn import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import _block_name, _items
from repro_torch.nn import ssm
from repro_torch.nn.transformer import MambaLayer

TOL = 1e-5  # f32 end to end, relative to max |JAX|


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _ssd_inputs(seed, b, s, h, p, g, n):
    """x, dt (softplus-range), a (negative), B, C, d_skip, h0 as numpy f32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(
        x=f(b, s, h, p),
        dt=rng.uniform(1e-3, 0.5, (b, s, h)).astype(np.float32),
        a=-np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32),
        b_in=f(b, s, g, n), c_in=f(b, s, g, n),
        d_skip=rng.uniform(0.5, 1.5, h).astype(np.float32),
        h0=0.5 * f(b, h, p, n))


def _run_ssd(inp, chunk, h0):
    args = [inp[k] for k in ("x", "dt", "a", "b_in", "c_in", "d_skip")]
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk,
                             h0=None if h0 is None else torch.from_numpy(h0))
    return (ty.numpy(), th.numpy()), (np.asarray(jy), np.asarray(jh))


# (S, chunk, H, G): S a multiple of the chunk; not one (the padded tail);
# shorter than the chunk; G below H (two and one B/C group for 8 heads)
SSD_CASES = [(32, 16, 8, 8), (37, 16, 8, 2), (5, 16, 4, 4), (40, 8, 8, 1)]


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("s,chunk,h,g", SSD_CASES)
def test_ssd_chunked_matches_reference(s, chunk, h, g, with_h0):
    inp = _ssd_inputs(s + h + g, 2, s, h, 8, g, 6)
    (ty, th), (jy, jh) = _run_ssd(inp, chunk, inp["h0"] if with_h0 else None)
    assert ty.shape == (2, s, h, 8) and th.shape == (2, h, 8, 6)
    assert th.dtype == np.float32
    assert _rel_err(ty, jy) <= TOL
    assert _rel_err(th, jh) <= TOL


def test_ssd_chunked_streamed_halves_equal_the_whole():
    """The second half with the first half's final state carried in gives
    the whole sequence's outputs and final state (the padded tail of each
    half leaves the state exact)."""
    inp = _ssd_inputs(7, 2, 45, 8, 8, 2, 6)
    (y, hw), _ = _run_ssd(inp, 16, inp["h0"])
    first = {k: v[:, :20] if v.ndim > 1 and v.shape[1] == 45 else v
             for k, v in inp.items()}
    second = {k: v[:, 20:] if v.ndim > 1 and v.shape[1] == 45 else v
              for k, v in inp.items()}
    (y1, h1), _ = _run_ssd(first, 16, inp["h0"])
    (y2, h2), (jy2, jh2) = _run_ssd(second, 16, h1)
    assert _rel_err(np.concatenate([y1, y2], 1), y) <= TOL
    assert _rel_err(h2, hw) <= TOL
    assert _rel_err(y2, jy2) <= TOL and _rel_err(h2, jh2) <= TOL


def _recurrence(inp, h0):
    """The SSM as a sequential recurrence in numpy f64: h = exp(dt a) h +
    dt x B^T, y = h C + D x, B and C repeated over each group's heads."""
    x, dt, a = (inp[k].astype(np.float64) for k in ("x", "dt", "a"))
    bsz, s, h, p = x.shape
    rep = h // inp["b_in"].shape[2]
    bh = np.repeat(inp["b_in"].astype(np.float64), rep, axis=2)
    chh = np.repeat(inp["c_in"].astype(np.float64), rep, axis=2)
    st = h0.astype(np.float64)
    ys = []
    for t in range(s):
        dec = np.exp(dt[:, t] * a)[:, :, None, None]
        st = dec * st + (dt[:, t, :, None] * x[:, t])[..., None] \
            * bh[:, t, :, None, :]
        ys.append(np.einsum("bhpx,bhx->bhp", st, chh[:, t])
                  + x[:, t] * inp["d_skip"][None, :, None])
    return np.stack(ys, 1), st


@pytest.mark.parametrize("g", [4, 1])
def test_ssd_decode_step_matches_reference_and_the_recurrence(g):
    """Each step against the JAX step from the same state; stepped over
    the whole sequence, equal to the recurrence and to ``ssd_chunked``."""
    inp = _ssd_inputs(11 + g, 2, 12, 4, 8, g, 6)
    args = ("x", "dt", "a", "b_in", "c_in", "d_skip")
    tstate = torch.from_numpy(inp["h0"])
    ys = []
    for t in range(12):
        step = {k: inp[k][:, t:t + 1] if inp[k].ndim > 1 else inp[k]
                for k in args}
        jy, jst = jssm.ssd_decode_step(
            *(jnp.asarray(step[k]) for k in args), jnp.asarray(tstate))
        ty, tstate_new = ssm.ssd_decode_step(
            *(torch.from_numpy(step[k]) for k in args), tstate)
        assert ty.shape == (2, 1, 4, 8) and tstate_new.dtype == torch.float32
        assert _rel_err(ty, jy) <= TOL and _rel_err(tstate_new, jst) <= TOL
        ys.append(ty.numpy())
        tstate = tstate_new
    want_y, want_h = _recurrence(inp, inp["h0"])
    assert _rel_err(np.concatenate(ys, 1), want_y) <= TOL
    assert _rel_err(tstate, want_h) <= TOL
    (cy, ch), _ = _run_ssd(inp, 8, inp["h0"])
    assert _rel_err(cy, want_y) <= TOL and _rel_err(ch, want_h) <= TOL


# ---------------------------------------------------------------------------
# the mixer, with the JAX parameters moved over
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _blocks(arch="mamba2_130m"):
    """(JAX Mamba2Block, its parameters, the port's block with them) on
    the smoke configuration."""
    jcfg = jax_get_config(arch, smoke=True)
    jblk = jssm.Mamba2Block(jcfg, seed=1)
    params = jblk.init(jax.random.key(3))
    tblk = ssm.Mamba2Block(get_config(arch, smoke=True), seed=1,
                           device="cpu")
    sd = {_block_name(path): torch.from_numpy(np.array(arr))
          for path, arr in _items(jax.tree.map(np.asarray, params))}
    assert set(sd) == {n for n, _ in tblk.named_parameters()}
    tblk.load_state_dict(sd, strict=False)
    return jblk, params, tblk


def test_mixer_patterns_and_parameter_dtypes():
    """in_proj (64 -> 296, no block of 16 divides it) is dense, out_proj
    (128 -> 64) the reference's 16 x 16 pattern; the gated norm's scale
    starts at ones; the SSM parameters stay f32 through a bf16 cast."""
    jblk, _, tblk = _blocks()
    assert tblk.in_proj.pattern is None and jblk.in_proj.pattern is None
    np.testing.assert_array_equal(tblk.out_proj.pattern.block_idx,
                                  jblk.out_proj.pattern.block_idx)
    fresh = ssm.Mamba2Block(get_config("mamba2_130m", smoke=True),
                            device="cpu")
    assert torch.equal(fresh.norm.scale, torch.ones(128))
    assert not fresh.norm.zero_centered
    fresh.to(torch.bfloat16)
    assert fresh.in_proj.weight.dtype == torch.bfloat16
    for name in ssm._F32_PARAMS:
        assert getattr(fresh, name).dtype == torch.float32, name


def test_mixer_forward_and_decode_match_reference():
    """The full-sequence form (S 37, chunks of 16), then a decode step from
    its final state, against the JAX block; a second forward with that
    state carried in equals the decode step."""
    jblk, params, tblk = _blocks()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 37, 64)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    jy, jst = jax.jit(jblk.__call__)(params, jnp.asarray(x))
    with torch.no_grad():
        ty, tst = tblk(torch.from_numpy(x))
        assert _rel_err(ty, jy) <= TOL
        for k in ("ssd", "conv"):
            assert _rel_err(tst[k], jst[k]) <= TOL, k
        jy1, jst1 = jax.jit(jblk.decode)(params, jnp.asarray(x1), jst)
        ty1, tst1 = tblk.decode(torch.from_numpy(x1), tst)
        assert _rel_err(ty1, jy1) <= TOL
        for k in ("ssd", "conv"):
            assert _rel_err(tst1[k], jst1[k]) <= TOL, k
        ty1c, tst1c = tblk(torch.from_numpy(x1), tst)
    assert _rel_err(ty1c, ty1) <= TOL
    assert _rel_err(tst1c["ssd"], tst1["ssd"]) <= TOL


def test_paged_step_keeps_inactive_rows_and_addresses_slots():
    """A decode and a chunk step over 3 slots: a row with n_new == 0 keeps
    its state bit for bit; ``slot_ids`` steps only the named slots, as the
    whole step with the others inactive does."""
    cfg = get_config("mamba2_130m", smoke=True)
    layer = MambaLayer(cfg, seed=1, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    state = {k: torch.randn(t.shape, generator=g)
             for k, t in layer.mixer.init_state(3).items()}
    with torch.no_grad():
        for c in (1, 4):
            x = torch.randn((3, c, 64), generator=g)
            n_new = torch.tensor([c, 0, c], dtype=torch.int32)
            pos = torch.zeros(3, dtype=torch.int32)
            whole = {k: t.clone() for k, t in state.items()}
            out = layer.paged_step(x, pos, n_new, whole, None)
            for k in whole:
                assert torch.equal(whole[k][1], state[k][1]), k
                assert not torch.equal(whole[k][0], state[k][0]), k
            part = {k: t.clone() for k, t in state.items()}
            ids = torch.tensor([2, 0])
            out2 = layer.paged_step(x[[2, 0]], pos[:2], n_new[[2, 0]], part,
                                    None, slot_ids=ids)
            for k in part:
                assert torch.equal(part[k], whole[k]), k
            assert torch.equal(out2, out[[2, 0]])
