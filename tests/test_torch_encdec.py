"""seamless-m4t-medium (the encoder-decoder) on the port against the JAX
package on the CPU, and the decode attention of the dense-cache loop.

The configuration field for field and the full-width junction patterns; on
the smoke configuration (2 encoder + 2 decoder layers, f32) with the JAX
parameters moved over by ``repro_torch.convert.from_jax_params``: the
stacks' seeds (7001, 9001) and every junction pattern against the JAX
``EncDec``, the encoder's output, the prefill logits and the self and cross
caches, 8 teacher-forced ``decode_step``s, and ``generate_cached``'s greedy
tokens. The decode attention over a dense cache's page view
(``dense_decode_attention``, the paged decode kernel's plain version here)
against the JAX ``decode_attention`` at G 1, 2 and 7, with a window, a
softcap, the last row and a cross cache whose padding rows hold garbage;
the plain flash forward against the JAX ``chunked_attention(causal=False)``
with Sq != Skv. The JAX junctions run on their XLA backend, the plain
reference of the Pallas kernels."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.block_pattern import fit_block_pattern as jax_fit
from repro.launch.serve import generate_cached as jax_generate_cached
from repro.nn import attention as jattention
from repro.nn import build_model as jax_build_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.core.block_pattern import fit_block_pattern
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.serve import generate_cached, needs_dense_loop
from repro_torch.nn import attention
from repro_torch.nn.model import (DECODER_SEED, ENCODER_SEED, EncDec,
                                  build_model, layer_seeds)

ARCH = "seamless_m4t_medium"
BATCH, PROMPT, ENC_LEN, S_MAX, N_DECODE = 2, 5, 12, 16, 8
ENC_TOL = 1e-5      # the encoder's output, of max |JAX|
LOGIT_TOL = 1e-4    # logits, of max |JAX| (tests/test_torch_model.py)
CACHE_TOL = 1e-5    # the self and cross caches, of max |JAX|
ATTN_TOL = 1e-5     # one attention in f32, of max |JAX|

# the full-width FFN junctions: (n_in, n_out, rho, pattern seed: the
# stack's slot seed + 11 up / + 13 down) -> (n_lb, n_rb, fan-in)
FULL_JUNCTIONS = {
    "encoder-up": (1024, 4096, 0.5, ENCODER_SEED + 1 + 11, (4, 4, 2)),
    "encoder-down": (4096, 1024, 0.75, ENCODER_SEED + 1 + 13, (16, 1, 16)),
    "decoder-up": (1024, 4096, 0.5, DECODER_SEED + 1 + 11, (4, 4, 2)),
    "decoder-down": (4096, 1024, 0.75, DECODER_SEED + 1 + 13, (16, 1, 16)),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX EncDec, its parameters, the port's EncDec with them)."""
    cfg = jax_get_config(ARCH, smoke=True)
    jmodel = jax_build_model(cfg.with_(sparsity=dataclasses.replace(
        cfg.sparsity, backend="xla")))
    params = jmodel.init(jax.random.key(0))
    tmodel = build_model(get_config(ARCH, smoke=True), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    tmodel.load_state_dict(from_jax_params(_np(params), tmodel),
                           strict=False)
    return jmodel, params, tmodel


def _inputs():
    rng = np.random.default_rng(1)
    cfg = get_config(ARCH, smoke=True)
    return dict(
        tokens=rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(
            np.int32),
        embeds=rng.normal(size=(BATCH, ENC_LEN, cfg.frontend_dim)).astype(
            np.float32),
        feed=rng.integers(0, cfg.vocab_size, (N_DECODE, BATCH, 1)).astype(
            np.int32))


@functools.lru_cache(maxsize=None)
def _runs():
    """Prefill and N_DECODE teacher-forced decode steps of both models:
    {"jax"/"port": (encoder output, prefill logits, cache after prefill,
    [decode logits])}, the caches as numpy (per layer for the port)."""
    jmodel, params, tmodel = _models()
    x = _inputs()
    jbatch = {"tokens": jnp.asarray(x["tokens"]),
              "embeds": jnp.asarray(x["embeds"])}
    enc = jax.jit(jmodel.encode)(params, jbatch["embeds"])
    logits, cache = jax.jit(
        lambda p, b: jmodel.prefill(p, b, S_MAX))(params, jbatch)
    jcache = _np(cache["layers"])
    step = jax.jit(jmodel.decode_step)
    jdec = []
    for t in x["feed"]:
        lg, cache = step(params, jnp.asarray(t), cache)
        jdec.append(np.asarray(lg))
    tbatch = {k: torch.from_numpy(x[k]) for k in ("tokens", "embeds")}
    with torch.no_grad():
        tenc = tmodel.encode(tbatch["embeds"]).numpy()
    tlogits, tcache = tmodel.prefill(tbatch, S_MAX)
    tcache0 = [{part: {n: t.clone().numpy() for n, t in kv.items()}
                for part, kv in c.items()} for c in tcache["layers"]]
    tdec = [tmodel.decode_step(torch.from_numpy(t), tcache)[0].numpy()
            for t in x["feed"]]
    return {"jax": (np.asarray(enc), np.asarray(logits), jcache, jdec),
            "port": (tenc, tlogits.numpy(), tcache0, tdec, tcache)}


# ---------------------------------------------------------------------------
# configuration, seeds and patterns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_config_matches_reference(smoke):
    """Field for field, the nested enc-dec and sparsity configs too; the
    JAX smoke config's ``attn_chunk`` has no field in the port."""
    assert ARCH in ARCHS
    ref = jax_get_config(ARCH, smoke=smoke)
    got = get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(got):
        want, have = getattr(ref, f.name), getattr(got, f.name)
        if f.name == "sparsity":
            for g in dataclasses.fields(have):
                assert getattr(have, g.name) == getattr(want, g.name), g.name
        elif f.name == "enc_dec":
            assert dataclasses.asdict(have) == dataclasses.asdict(want)
        else:
            assert have == want, f.name
    assert needs_dense_loop(got)


@pytest.mark.parametrize("junction", list(FULL_JUNCTIONS))
def test_full_width_patterns_match_reference(junction):
    n_in, n_out, rho, seed, want = FULL_JUNCTIONS[junction]
    got = fit_block_pattern(n_in, n_out, rho, get_config(ARCH).sparsity,
                            seed=seed)
    ref = jax_fit(n_in, n_out, rho, jax_get_config(ARCH).sparsity,
                  seed=seed)
    np.testing.assert_array_equal(got.block_idx, ref.block_idx)
    assert (got.n_lb, got.n_rb, got.d_in_b) == want
    assert (got.block_in, got.block_out) == (256, 1024)


def test_seeds_and_patterns_match_reference_stacks():
    """Every layer of each stack is the JAX stack's one scanned slot (seed
    7001 in the encoder, 9001 in the decoder), with its FFN patterns; the
    decoder's cross-attention and ``ln_cross``, dense, without bias."""
    jmodel, _, tmodel = _models()
    kinds = ("global",) * 2
    assert layer_seeds(kinds, base=ENCODER_SEED) == [7001, 7001]
    assert layer_seeds(kinds, base=DECODER_SEED) == [9001, 9001]
    for name in ("encoder", "decoder"):
        stack = getattr(jmodel, name)
        assert (stack.unit_len, stack.n_groups) == (1, 2)
        assert not stack.prologue and not stack.epilogue
        jblk = stack.unit_blocks[0]
        for tblk in getattr(tmodel, name):
            assert (tblk.cross_attn is not None) == (name == "decoder")
            for j in ("up", "down"):
                np.testing.assert_array_equal(
                    getattr(tblk.ffn, j).pattern.block_idx,
                    getattr(jblk.ffn, j).pattern.block_idx)
            assert getattr(tblk.ffn, "gate", None) is None
    cross = tmodel.decoder[0].cross_attn
    assert cross.cross and not cross.wq.is_sparse and cross.wq.bias is None
    assert hasattr(tmodel.decoder[0], "ln_cross")
    assert not hasattr(tmodel.encoder[0], "ln_cross")


# ---------------------------------------------------------------------------
# prefill, caches, decode, greedy tokens
# ---------------------------------------------------------------------------


def test_prefill_encoder_and_caches_match_reference():
    jenc, jlogits, jcache, _ = _runs()["jax"]
    tenc, tlogits, tcache, _, _ = _runs()["port"]
    assert _rel_err(tenc, jenc) <= ENC_TOL
    assert tlogits.shape == jlogits.shape == (BATCH, 1, 512)
    assert _rel_err(tlogits, jlogits) <= LOGIT_TOL
    scan = jcache["scan"][0]          # (G, B, S, Hkv, Dh) a leaf
    assert len(tcache) == scan["self"]["k"].shape[0] == 2
    for g, c in enumerate(tcache):
        for part, rows in (("self", S_MAX), ("cross", ENC_LEN)):
            for n in ("k", "v"):
                got = c[part][n]
                # rounded up to whole pages of 16 rows, the padding zero
                assert got.shape[1] == -(-rows // 16) * 16
                assert not got[:, rows:].any()
                assert _rel_err(got[:, :rows],
                                scan[part][n][g]) <= CACHE_TOL, (g, part, n)


def test_decode_steps_match_reference():
    jdec = _runs()["jax"][3]
    tdec, tcache = _runs()["port"][3:]
    assert len(tdec) == len(jdec) == N_DECODE
    for i, (got, want) in enumerate(zip(tdec, jdec)):
        assert _rel_err(got, want) <= LOGIT_TOL, i
    assert tcache["pos"] == PROMPT + N_DECODE
    assert tcache["enc_len"] == ENC_LEN


def test_generate_cached_greedy_tokens_match_reference():
    jmodel, params, tmodel = _models()
    x = _inputs()
    want, _ = jax_generate_cached(
        jmodel, params, jnp.asarray(x["tokens"]), S_MAX, 10,
        extra_batch={"embeds": jnp.asarray(x["embeds"])})
    got, tps = generate_cached(tmodel, x["tokens"], S_MAX, 10,
                               extra_batch={"embeds": x["embeds"]},
                               device="cpu")
    assert got.shape == (BATCH, 10) and tps > 0
    np.testing.assert_array_equal(got, np.asarray(want))


def test_cross_block_has_no_paged_step():
    tmodel = _models()[2]
    with pytest.raises(NotImplementedError, match="cross-attention"):
        tmodel.decoder[0].paged_step(None, None, None, None, None)
    assert isinstance(tmodel, EncDec)


# ---------------------------------------------------------------------------
# the decode attention over a dense cache's page view; the plain flash
# forward without the causal mask
# ---------------------------------------------------------------------------

# (Hkv, G, Dh, cache rows S, pos, window, softcap, cross): pos is the
# query's position (a self cache's keys 0..pos are visible); a cross case's
# keys are its first pos + 1 rows of S, the rest garbage
DECODE_CASES = {
    "g1": (4, 1, 16, 48, 20, None, None, False),
    "g2": (2, 2, 16, 48, 33, None, None, False),
    "g7": (2, 7, 32, 32, 9, None, None, False),
    "window": (2, 2, 16, 64, 50, 8, None, False),
    "softcap": (2, 2, 16, 48, 40, None, 5.0, False),
    "last_row": (2, 2, 16, 48, 47, 16, None, False),
    "cross": (4, 1, 16, 48, 36, None, None, True),
    "cross_g7": (2, 7, 32, 32, 17, None, 5.0, True),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_dense_decode_matches_reference_decode_attention(case):
    hkv, g, dh, s, pos, window, softcap, cross = DECODE_CASES[case]
    rng = np.random.default_rng(7)
    b = 3
    q = rng.normal(size=(b, 1, hkv, g, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
            for _ in range(2))
    scale = dh ** -0.5
    kw = dict(window=window, softcap=softcap, scale=scale)
    if cross:
        # the JAX cross cache holds exactly the encoder's frames; the
        # port's rows past them (padding to a whole page) must be masked
        # by the lengths, not by the shape
        n = pos + 1
        want = jattention.decode_attention(
            jnp.asarray(q), jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]),
            pos=n - 1, **kw)
        k[:, n:] = 1e4
        v[:, n:] = -1e4
    else:
        want = jattention.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            pos=jnp.int32(pos), **kw)
    lengths = torch.full((b,), pos + 1, dtype=torch.int32)
    got = fa.dense_decode_attention(
        torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
        lengths, **kw)
    assert got.shape == (b, hkv, g, dh)
    assert _rel_err(got, np.asarray(want)[:, 0]) <= ATTN_TOL
    if not cross:
        ref = attention.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            pos=pos, **kw)
        assert _rel_err(ref, want) <= ATTN_TOL


def test_dense_page_table_views_rows_as_pages():
    table = fa.dense_page_table(3, 48)
    assert table.dtype == torch.int32 and table.shape == (3, 3)
    assert table.tolist() == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.dense_page_table(2, 40)


# (B, Sq, Skv, Hq, Hkv, Dh): an encoder (Sq = Skv), a cross-attention's
# prefill and decoder prompt (Sq != Skv, both ways), a group of 7
FLASH_CASES = {
    "encoder": (2, 12, 12, 4, 4, 16),
    "cross_short_q": (2, 5, 23, 4, 4, 16),
    "cross_long_q": (1, 30, 7, 4, 2, 16),
    "g7": (1, 9, 40, 14, 2, 32),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_bidirectional_matches_chunked_attention(case):
    b, sq, skv, hq, hkv, dh = FLASH_CASES[case]
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, sq, hq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, skv, hkv, dh)).astype(np.float32)
            for _ in range(2))
    want = jattention.chunked_attention(
        jnp.asarray(q.reshape(b, sq, hkv, hq // hkv, dh)), jnp.asarray(k),
        jnp.asarray(v), causal=False, window=None, softcap=None, chunk=4,
        scale=dh ** -0.5)
    got = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=False)
    assert _rel_err(got, np.asarray(want).reshape(b, sq, hq, dh)) \
        <= ATTN_TOL
