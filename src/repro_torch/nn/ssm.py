"""Mamba2: the SSD (state-space duality) scan, chunked, and its one-token
recurrence (port of ``repro.nn.ssm``).

``ssd_chunked`` splits the sequence into chunks: within a chunk the
quadratic (attention-like) form, across chunks a recurrent state (B, H, P,
N) carried by a loop over chunks. ``ssd_decode_step`` is one step of the
recurrence against a persistent state, the SSM's counterpart of a KV
cache, of constant size in the sequence length. ``Mamba2Block`` is the
whole mixer: in_proj, a causal depthwise conv, the SSD, a gated RMS norm
and out_proj.

The JAX package computes the SSD in XLA (no Pallas kernel), so the port
computes it in plain torch, on the card as on the CPU; only the in/out
projection junctions run the junction forward. The numerics are the JAX
package's: the SSD runs in f32, the conv in the input's dtype, dt is a
softplus in f32 clipped to ``dt_limit``, and padded steps get dt = 0 so
that the final state stays exact. Every einsum is two-operand with an
explicit contraction: a 3- or 4-operand form can materialise a (.., Q, H,
P, N) product.

A decode step's SSM work runs under two named profiler ranges,
``SSD_RANGE`` (the SSD's plain-torch ops) and ``MIXER_RANGE`` (the whole
mixer), so a profile attributes device time to them; without a profiler
a range costs a few microseconds of host time.

The mixer's conv weight and bias and its ``a_log``, ``dt_bias`` and
``d_skip`` are f32 whatever the parameter dtype, as the JAX package
initialises them, and stay f32 when the module is cast (the serving
engine casts the model to its compute dtype): the JAX engine serves them
in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from .common import ModelConfig, param_dtype_of
from .layers import Linear, RMSNorm

# the profiler ranges of a decode step's SSD and of its whole mixer
SSD_RANGE, MIXER_RANGE = "ssm/ssd_decode_step", "ssm/mixer_decode"


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum for decay matrices: out[i, j] = sum_{j<k<=i} a_k
    (lower triangular), -inf above the diagonal. a: (..., Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor,
                d_skip: torch.Tensor, *, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) after the softplus, a (H,) negative
    decay rates, b_in and c_in (B, S, G, N), d_skip (H,), h0 (B, H, P, N)
    the state carried in (zeros if None) -> (y (B, S, H, P) in the dtype of
    x, the final state (B, H, P, N) in f32)."""
    bsz, s, h, p = x.shape
    g, n = b_in.shape[-2:]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # dt = 0 at the padded steps makes them the identity of the
        # recurrence (decay exp(0) = 1, update dt * B * x = 0): the final
        # state is exact
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc = s // chunk
    hg = h // g

    xf = x.float()
    dtf = dt.float()
    af = a.float()

    # chunked views; the heads stay grouped (B, nc, Q, G, hg, ...) so that
    # B and C are never expanded to per-head copies
    def ck(t):
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc = ck(xf).reshape(bsz, nc, chunk, g, hg, p)      # (B,nc,Q,G,hg,P)
    dtc = ck(dtf)                                      # (B,nc,Q,H)
    dtg = dtc.reshape(bsz, nc, chunk, g, hg)
    bc = ck(b_in.float())                              # (B,nc,Q,G,N)
    cc = ck(c_in.float())
    adt = dtc * af[None, None, None, :]                # (B,nc,Q,H)
    adt_cum = torch.cumsum(adt, dim=2)                 # within-chunk cumsum

    # intra-chunk (quadratic) term: per-group scores, per-head decay
    lmat = torch.exp(_segsum(adt.movedim(-1, 2)))      # (B,nc,H,Q,Q)
    lmat = lmat.reshape(bsz, nc, g, hg, chunk, chunk)
    scores = torch.einsum("bnqgx,bnkgx->bngqk", cc, bc)  # (B,nc,G,Q,Q)
    # mw[q, k] = scores[q, k] * exp(segsum) * dt[k]
    mw = scores[:, :, :, None] * lmat \
        * dtg.movedim(2, 4)[:, :, :, :, None, :]       # (B,nc,G,hg,Q,K)
    y_intra = torch.einsum("bnghqk,bnkghp->bnqghp", mw, xc)

    # chunk-final states: sum_k decay_k dt_k x_k B_k^T (contract over k)
    decay_to_end = torch.exp(adt_cum[:, :, -1:, :] - adt_cum)  # (B,nc,Q,H)
    w = (decay_to_end * dtc).reshape(bsz, nc, chunk, g, hg)
    xw = xc * w[..., None]                             # (B,nc,Q,G,hg,P)
    states = torch.einsum("bnqghp,bnqgx->bnghpx", xw, bc)
    states = states.reshape(bsz, nc, h, p, n)          # (B,nc,H,P,N)
    chunk_decay = torch.exp(adt_cum[:, :, -1, :])      # (B,nc,H)

    # inter-chunk recurrence: the state entering each chunk
    carry = xf.new_zeros((bsz, h, p, n)) if h0 is None else h0.float()
    h_prev = []
    for i in range(nc):
        h_prev.append(carry)
        carry = states[:, i] + chunk_decay[:, i, :, None, None] * carry
    h_prev = torch.stack(h_prev, dim=1)                # (B,nc,H,P,N)

    # inter-chunk output: C_i . (decay_in[i] * h_prev), contracted over N
    h_prev_g = h_prev.reshape(bsz, nc, g, hg, p, n)
    ch = torch.einsum("bnqgx,bnghpx->bnqghp", cc, h_prev_g)
    decay_in = torch.exp(adt_cum).reshape(bsz, nc, chunk, g, hg)
    y_inter = ch * decay_in[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + xf * d_skip.float()[None, None, :, None]
    if pad:
        y = y[:, :s_orig]
    return y.to(x.dtype), carry


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_in: torch.Tensor, c_in: torch.Tensor,
                    d_skip: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence: x (B, 1, H, P), dt (B, 1, H), a (H,),
    b_in and c_in (B, 1, G, N), d_skip (H,), state (B, H, P, N) -> (y (B,
    1, H, P) in the dtype of x, the new state in the dtype of state)."""
    with record_function(SSD_RANGE):
        h = x.shape[2]
        g = b_in.shape[-2]
        head_group = torch.arange(h, device=x.device) // (h // g)
        bh = b_in.float()[:, 0].index_select(1, head_group)   # (B, H, N)
        ch = c_in.float()[:, 0].index_select(1, head_group)
        dtf = dt.float()[:, 0]                # (B, H)
        dec = torch.exp(dtf * a.float())      # (B, H)
        xf = x.float()[:, 0]                  # (B, H, P)
        upd = (dtf[:, :, None] * xf)[..., None] * bh[:, :, None, :]
        new_state = dec[:, :, None, None] * state.float() + upd
        y = torch.einsum("bhx,bhpx->bhp", ch, new_state)
        y = y + xf * d_skip.float()[None, :, None]
        return y[:, None].to(x.dtype), new_state.to(state.dtype)


# the mixer's parameters that are f32 whatever the parameter dtype
_F32_PARAMS = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip")


class Mamba2Block(nn.Module):
    """The Mamba2 mixer: in_proj -> causal depthwise conv -> SSD -> gated
    RMS norm -> out_proj. in_proj and out_proj are junctions of density
    ``rho_ffn`` (seeds +21 and +22)."""

    def __init__(self, cfg: ModelConfig, seed: int = 0, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sc = cfg.ssm
        self.sc = sc
        d = cfg.d_model
        self.d_inner = sc.expand * d
        self.n_heads = self.d_inner // sc.head_dim
        self.conv_dim = self.d_inner + 2 * sc.n_groups * sc.d_state
        proj_out = (2 * self.d_inner + 2 * sc.n_groups * sc.d_state
                    + self.n_heads)
        sp = cfg.sparsity
        rho_up, rho_down = sp.rho_ffn if sp.enabled else (1.0, 1.0)
        pd = param_dtype_of(cfg)
        kw = dict(sp=sp, dtype=pd, device=device, generator=generator)
        self.in_proj = Linear(d, proj_out, rho=rho_up, seed=seed + 21, **kw)
        self.out_proj = Linear(self.d_inner, d, rho=rho_down,
                               seed=seed + 22, **kw)
        self.norm = RMSNorm(self.d_inner, cfg.rms_eps, pd, device,
                            zero_centered=False)
        f32 = dict(device=device, dtype=torch.float32)

        def log_uniform(lo, hi):  # log of exp(U(log lo, log hi))
            u = torch.rand(self.n_heads, generator=generator, **f32)
            return math.log(lo) + u * (math.log(hi) - math.log(lo))

        self.a_log = nn.Parameter(log_uniform(*sc.a_init_range))
        dt = torch.exp(log_uniform(1e-3, 1e-1))
        # the inverse softplus of dt
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        self.conv_w = nn.Parameter(torch.randn(
            (sc.d_conv, self.conv_dim), generator=generator, **f32)
            * math.sqrt(1.0 / sc.d_conv))
        self.conv_b = nn.Parameter(torch.zeros(self.conv_dim, **f32))
        self.d_skip = nn.Parameter(torch.ones(self.n_heads, **f32))

    def _apply(self, fn, recurse=True):
        keep = {n: getattr(self, n).data for n in _F32_PARAMS}
        out = super()._apply(fn, recurse)
        for n, old in keep.items():
            p = getattr(self, n)
            if p.dtype != old.dtype:
                p.data = old.to(p.device)
        return out

    def _split(self, proj: torch.Tensor):
        di = self.d_inner
        return (proj[..., :di], proj[..., di:di + self.conv_dim],
                proj[..., di + self.conv_dim:])

    def _conv(self, xbc: torch.Tensor, carry: Optional[torch.Tensor]):
        """Causal depthwise conv along the sequence, in the dtype of xbc;
        carry (B, d_conv - 1, conv_dim) holds the previous inputs. Returns
        (silu(conv), the new carry)."""
        kw = self.conv_w.to(xbc.dtype)  # (K, C)
        k = kw.shape[0]
        if carry is None:
            pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
        else:
            pad = carry.to(xbc.dtype)
        xp = torch.cat([pad, xbc], dim=1)  # (B, S + K - 1, C)
        new_carry = xp[:, -(k - 1):, :]
        s = xbc.shape[1]
        out = sum(xp[:, i:i + s, :] * kw[i] for i in range(k))
        out = out + self.conv_b.to(xbc.dtype)
        return F.silu(out), new_carry

    def _pre_ssd(self, x: torch.Tensor, conv_carry: Optional[torch.Tensor]):
        sc = self.sc
        proj = self.in_proj(x)
        z, xbc, dt = self._split(proj)
        xbc, new_carry = self._conv(xbc, conv_carry)
        di, gn = self.d_inner, sc.n_groups * sc.d_state
        lead = xbc.shape[:2]
        xs = xbc[..., :di]
        b_in = xbc[..., di:di + gn].reshape(*lead, sc.n_groups, sc.d_state)
        c_in = xbc[..., di + gn:].reshape(*lead, sc.n_groups, sc.d_state)
        # softplus as jax.nn.softplus computes it: logaddexp(v, 0)
        v = dt.float() + self.dt_bias.float()
        dt = torch.logaddexp(v, v.new_zeros(()))
        dt = torch.clamp(dt, *sc.dt_limit)
        xh = xs.reshape(*lead, self.n_heads, sc.head_dim)
        a = -torch.exp(self.a_log.float())
        return z, xh, dt, a, b_in, c_in, new_carry

    def _out(self, y: torch.Tensor, z: torch.Tensor,
             shape: torch.Size) -> torch.Tensor:
        y = y.reshape(*shape[:2], self.d_inner)
        y = self.norm(y * F.silu(z.to(y.dtype)))
        return self.out_proj(y)

    def forward(self, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The full-sequence form: x (B, S, d) -> (B, S, d) and the final
        state {"ssd", "conv"}; ``state`` (the same keys) is carried in, as
        a chunk of a streamed prefill does."""
        conv_carry = state["conv"] if state else None
        h0 = state["ssd"] if state else None
        z, xh, dt, a, b_in, c_in, conv_out = self._pre_ssd(x, conv_carry)
        y, h_last = ssd_chunked(xh, dt, a, b_in, c_in, self.d_skip,
                                chunk=self.sc.chunk, h0=h0)
        return self._out(y, z, x.shape), {"ssd": h_last, "conv": conv_out}

    def decode(self, x: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token: x (B, 1, d), state {"ssd": (B, H, P, N), "conv": (B,
        d_conv - 1, conv_dim)} -> (B, 1, d) and the new state."""
        with record_function(MIXER_RANGE):
            z, xh, dt, a, b_in, c_in, conv_out = self._pre_ssd(
                x, state["conv"])
            y, new_ssd = ssd_decode_step(xh, dt, a, b_in, c_in, self.d_skip,
                                         state["ssd"])
            return self._out(y, z, x.shape), {"ssd": new_ssd,
                                              "conv": conv_out}

    def init_state(self, batch: int, device=None) -> Dict[str, torch.Tensor]:
        """Zero state for ``batch`` rows, in f32."""
        sc = self.sc
        kw = dict(dtype=torch.float32, device=device or self.conv_w.device)
        return {
            "ssd": torch.zeros((batch, self.n_heads, sc.head_dim,
                                sc.d_state), **kw),
            "conv": torch.zeros((batch, sc.d_conv - 1, self.conv_dim), **kw)}
