"""The models (port of ``repro.nn.model``): the decoder-only ``LM`` (token
or stub-frontend embedding input) with the full-sequence forward and
chunked cross-entropy loss of training, the paged serving step and the
dense-cache loop (``prefill``, ``decode_step``), and the encoder-decoder
``EncDec`` (seamless-m4t's backbone) with the dense-cache loop;
``build_model`` picks one for a configuration.

The JAX package splits its layers into an unscanned prologue
(deepseek-moe's dense layer 0), scanned pattern units (gemma3: 5 local +
1 global) under ``lax.scan`` and an unscanned epilogue (34 = 5 x 6 + 4 for
gemma3). Here the layers are one flat ``nn.ModuleList`` run by a Python
loop, but each layer is built with the seed its JAX block has, because the
seed picks its FFN sparsity pattern: prologue block ``i`` gets
``1000 * i``, scan slot ``u`` gets ``10 * u + 1`` in every group (scanned
groups share one pattern per slot), epilogue block ``i`` gets
``2000 + 10 * i``. The repeating unit is ``detect_unit``'s, or for a
hybrid stack (mamba layers and ``cfg.hybrid``: zamba2) ``hybrid.period``
(``repeat_unit``): zamba2's 38 layers are 6 groups of 6 slots and 2
epilogue layers. The hybrid's shared attention block (``self.shared``,
seed 501) runs after each group, never after the epilogue, on the hidden
state and the scaled input embedding. MoE blocks
(granite-moe, deepseek-moe) get the same seeds, and the paged step runs
MoE over all B x C rows, inactive slots' rows included, as the JAX step
does (serving needs dropless capacity for that, which the engine checks).
In training the MoE blocks' aux values are summed over layers and enter
the loss as in the JAX package: ``moe_lb`` x 0.01 and ``moe_z`` x 1.0,
each sum divided by the number of layers, the dense prologue's included.

With ``cfg.remat`` the training forward recomputes each layer (an
encoder-decoder's encoder and decoder layers too), and the loss each
sequence chunk, in the backward pass (``torch.utils.checkpoint``); the JAX
package recomputes each scanned group of layers instead. The results are
the same, only the memory differs.

An LM with ``input_mode="embeddings"`` (llava's stub vision tower) reads
frontend embeddings (B, S, frontend_dim) through a 2-layer projector,
``proj_in`` (with bias), tanh gelu, ``proj_mid`` (with bias), dense
``Linear``s whose products are ``torch.matmul``s as the JAX package's are
XLA dots; its decode embeds generated text tokens through the table.

The dense-cache loop (the JAX ``generate_cached`` path, which ``generate``
falls back to for encoder-decoders, stub frontends and MoE with a finite
expert capacity): ``prefill`` runs the prompt through ``forward``, writes
each layer's k and v into a cache of ``s_max`` rows per request
(``init_cache``; one {"self": {"k", "v"}} a layer, (B, S, Hkv, Dh) in the
compute dtype, and a decoder layer's static "cross" cache of the encoder's
frames) and returns the last token's logits; ``decode_step`` runs one token
per row at the cache's position ``pos`` (one position for the batch, as in
the JAX package), writing in place. The caches' rows are rounded up to a
multiple of 16, so that the paged decode kernel reads them as a page pool
(``kernels.flash_attention.dense_decode_attention``); the padding rows are
masked by the lengths. A mamba layer's cache is its state of B rows,
{"ssd", "conv"} in f32, which ``prefill`` sets to the state the chunked
SSD ends the prompt with and ``decode_step`` steps; a hybrid stack's
shared block has one {"self"} cache per application after the layers'
(the JAX ``Stack.decode``). ``launch.serve.generate`` still serves
token-input SSM models through the engine, as the JAX one does.

``EncDec``: the stub frontend's frames go through the dense ``adapter``
(with bias) into an encoder of bidirectional global layers and ``ln_enc``;
the decoder's layers cross-attend to that output; the logits are the tied
``embed.attend`` with no final softcap. Its ``loss`` is the JAX
``EncDec.loss``: f32 cross entropy over every position (chunked for
memory here, the tail included), labels < 0 ignored. Each stack's layer
seeds start from its base, as the JAX ``Stack(seed=...)``: 7000 for the
encoder (every layer 7001: a unit of one global layer, scanned) and 9000
for the decoder (9001; its cross-attention 9101).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import DENSE_PAGE, dense_page_table
from .attention import DecodeView
from .common import ModelConfig, dtype_of, param_dtype_of
from .layers import Embedding, Linear, RMSNorm, activation
from .transformer import MambaLayer, SharedAttnBlock, TransformerBlock

# weight of each MoE aux value in the loss, as in the JAX package
_AUX_SCALE = {"moe_lb": 0.01, "moe_z": 1.0}
# the seed bases of an encoder-decoder's stacks (the JAX ``EncDec``)
ENCODER_SEED, DECODER_SEED = 7000, 9000


def detect_unit(kinds: Tuple[str, ...]) -> int:
    """The repeating unit of the layer kinds, as the JAX ``Stack`` finds it
    (a unit repeated only once counts only if it spans every layer)."""
    n = len(kinds)
    for u in range(1, n + 1):
        groups = n // u
        ok = all(kinds[i] == kinds[i % u] for i in range(groups * u))
        if ok and (groups > 1 or u == n):
            return u
    return n


def prologue_len(cfg: ModelConfig) -> int:
    """Layers the JAX stack keeps unscanned before its scan: 1 for an MoE
    stack whose first layer is dense (deepseek-moe), else 0."""
    return int(cfg.moe is not None and cfg.moe.first_layer_dense)


def is_hybrid(cfg: ModelConfig) -> bool:
    """A zamba2-style stack: mamba layers and a shared attention block."""
    return cfg.hybrid is not None and "mamba" in cfg.layer_kinds


def repeat_unit(cfg: ModelConfig) -> int:
    """The JAX stack's repeating unit of the layers after the prologue:
    ``hybrid.period`` for a hybrid stack, else ``detect_unit``'s."""
    rest = cfg.layer_kinds[prologue_len(cfg):]
    if is_hybrid(cfg):
        return cfg.hybrid.period
    return detect_unit(rest) if rest else 1


def layer_seeds(kinds: Tuple[str, ...], pro_n: int = 0,
                unit: Optional[int] = None, base: int = 0) -> List[int]:
    """Per-layer block seeds of the JAX stack built with seed ``base``:
    ``pro_n`` prologue blocks, then the scan slots of the rest (repeating
    ``unit`` layers, by default ``detect_unit``'s), then its epilogue."""
    rest = kinds[pro_n:]
    if not rest:
        return [base + 1000 * i for i in range(len(kinds))]
    unit = unit or detect_unit(rest)
    scanned = (len(rest) // unit) * unit
    return [base + 1000 * i for i in range(pro_n)] + [
        base + (10 * (i % unit) + 1 if i < scanned
                else 2000 + 10 * (i - scanned))
        for i in range(len(rest))]


def _pages(n: int) -> int:
    """``n`` rows rounded up to whole pages of the dense caches' view."""
    return -(-n // DENSE_PAGE) * DENSE_PAGE


def _write_prefill(layer_caches: List[dict], kvs: List[dict]) -> None:
    """Write each prefill KV ({"self", and a cross layer's "cross": {"k",
    "v"}}) into the first rows of its zeroed cache, and each mamba layer's
    final state ({"ssd", "conv"}) over its state, in place."""
    for c, kv in zip(layer_caches, kvs):
        for part, new in kv.items():
            if isinstance(new, torch.Tensor):
                c[part].copy_(new)
                continue
            for n in ("k", "v"):
                c[part][n][:, :new[n].shape[1]] = new[n]


class _DenseCacheLoop:
    """What ``LM`` and ``EncDec`` share: remat, the chunked cross entropy,
    and the half of ``prefill`` and ``decode_step`` over the layers
    ``_cache_layers`` names (then the shared block's applications, which
    follow the layers ``shared_after`` maps to one)."""

    _cache_layers: nn.ModuleList
    # layer index -> the shared-block application after it (a hybrid LM's)
    shared_after: Dict[int, int] = {}

    def _remat(self) -> bool:
        return self.cfg.remat and torch.is_grad_enabled()

    def _run(self, fn, *args, **kw):
        """``fn(*args, **kw)``, recomputed in the backward pass under
        remat."""
        if self._remat():
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return fn(*args, **kw)

    def _chunk_loss(self, h: torch.Tensor, labels: torch.Tensor):
        logits = self.logits_fn(h).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp_min(0)[..., None].long())[..., 0]
        valid = (labels >= 0).float()
        return ((logz - gold) * valid).sum(), valid.sum()

    def _xent(self, h: torch.Tensor, labels: torch.Tensor, tail: bool):
        """(summed f32 cross entropy, valid labels) of ``h`` over
        ``loss_chunk`` sequence chunks, each recomputed under remat; the
        tail shorter than a chunk is dropped unless ``tail``."""
        s = labels.shape[1]
        chunk = min(self.cfg.loss_chunk, s)
        cuts = list(range(0, s - chunk + 1, chunk))
        if tail and s % chunk:
            cuts.append(s - s % chunk)
        tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo in cuts:
            sl = slice(lo, lo + chunk)
            t, c = self._run(self._chunk_loss, h[:, sl], labels[:, sl])
            tot, cnt = tot + t, cnt + c
        return tot, cnt

    def init_cache(self, batch: int, s_max: int,
                   dtype: Optional[torch.dtype] = None, device=None,
                   enc_len: int = 0) -> List[dict]:
        """Zeroed dense caches, one dict a layer: {"self": {"k", "v"}} of
        (batch, s_max rounded up to a multiple of 16, Hkv, Dh), and for a
        cross layer "cross" of ``enc_len`` rows rounded up the same way,
        in ``dtype`` (the compute dtype by default); a mamba layer's state
        of ``batch`` rows in f32; then a {"self"} one for each application
        of a hybrid stack's shared block."""
        cfg = self.cfg
        dtype = dtype or dtype_of(cfg)
        device = device or self.embed.table.device

        def kv(rows):
            return {n: torch.zeros((batch, _pages(rows), cfg.n_kv_heads,
                                    cfg.head_dim), dtype=dtype, device=device)
                    for n in ("k", "v")}

        out = []
        for layer in self._cache_layers:
            if isinstance(layer, MambaLayer):
                out.append(layer.mixer.init_state(batch, device=device))
                continue
            c = {"self": kv(s_max)}
            if layer.cross_attn is not None:
                c["cross"] = kv(enc_len)
            out.append(c)
        return out + [{"self": kv(s_max)} for _ in self.shared_after]

    def _decode_layers(self, x: torch.Tensor, cache: dict,
                       emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, 1, d) through every layer's ``decode`` at ``cache["pos"]``
        (and the shared block's, on x and the token's embedding ``emb``),
        the caches and states written in place; advances
        ``cache["pos"]``."""
        pos, layers = cache["pos"], cache["layers"]
        b, dev = x.shape[0], x.device
        attn = [c for c in layers if "self" in c]
        s = attn[0]["self"]["k"].shape[1] if attn else None
        if attn and pos >= s:
            raise ValueError(f"the dense cache holds {s} positions; "
                             f"position {pos} is past it")
        cross = attn[0].get("cross") if attn else None
        view = DecodeView(
            pos=pos,
            positions=torch.full((b, 1), pos, dtype=torch.int32, device=dev),
            table=dense_page_table(b, s, dev) if attn else None,
            lengths=torch.full((b,), pos + 1, dtype=torch.int32, device=dev),
            cross_table=None if cross is None else dense_page_table(
                b, cross["k"].shape[1], dev),
            cross_lengths=None if cross is None else torch.full(
                (b,), cache["enc_len"], dtype=torch.int32, device=dev))
        n = len(self._cache_layers)
        for i, (layer, c) in enumerate(zip(self._cache_layers, layers)):
            x = layer.decode(x, c, view)
            g = self.shared_after.get(i)
            if g is not None:
                x = self.shared.decode(x, emb, layers[n + g], view)
        cache["pos"] = pos + 1
        return x


def _blocks(cfg: ModelConfig, kinds: Tuple[str, ...], base: int, *,
            cross: bool = False, device=None,
            generator: Optional[torch.Generator] = None) -> nn.ModuleList:
    """The attention blocks of an encoder-decoder's stack, seeded as the
    JAX ``Stack(cfg, kinds, cross, seed=base)``."""
    pro_n = 0 if cross else prologue_len(cfg)
    return nn.ModuleList(
        TransformerBlock(cfg, kind, seed=seed, layer_idx=i, cross=cross,
                         device=device, generator=generator)
        for i, (kind, seed) in enumerate(
            zip(kinds, layer_seeds(kinds, pro_n, base=base))))


class LM(_DenseCacheLoop, nn.Module):
    """Decoder-only LM (tokens or stub-frontend embeddings in). With
    ``tie_embeddings`` the logits are ``h @ embed.table^T``; without, a
    dense ``head`` ``Linear(d_model, vocab_size)`` without bias in the
    parameter dtype computes them (the JAX ``LM.head``), its product a
    ``torch.matmul`` as the JAX package's is an XLA dot. The final softcap
    applies to either."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        pd = param_dtype_of(cfg)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, pd, device,
                               generator)
        kinds = cfg.layer_kinds
        pro_n, unit = prologue_len(cfg), repeat_unit(cfg)
        kw = dict(device=device, generator=generator)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, seed=seed, **kw) if kind == "mamba" else
            TransformerBlock(cfg, kind, seed=seed, layer_idx=i, **kw)
            for i, (kind, seed) in enumerate(
                zip(kinds, layer_seeds(kinds, pro_n, unit))))
        n_groups = (len(kinds) - pro_n) // unit
        self.shared = SharedAttnBlock(cfg, seed=501, **kw) \
            if is_hybrid(cfg) else None
        # layer index -> the group whose shared-block application follows it
        self.shared_after = {} if self.shared is None else {
            pro_n + (g + 1) * unit - 1: g for g in range(n_groups)}
        self.ln_f = RMSNorm(cfg.d_model, cfg.rms_eps, pd, device)
        if cfg.input_mode == "embeddings":
            # the 2-layer MLP projector of the stub frontend (llava)
            self.proj_in = Linear(cfg.frontend_dim, cfg.d_model, bias=True,
                                  dtype=pd, **kw)
            self.proj_mid = Linear(cfg.d_model, cfg.d_model, bias=True,
                                   dtype=pd, **kw)
        self.head = None if cfg.tie_embeddings else Linear(
            cfg.d_model, cfg.vocab_size, dtype=pd, device=device,
            generator=generator)

    @property
    def _cache_layers(self) -> nn.ModuleList:
        return self.layers

    def init_paged_cache(self, total_pages: int, page_size: int,
                         dtype: Optional[torch.dtype] = None,
                         device=None, quant_kv: bool = False,
                         slots: Optional[int] = None) -> List[dict]:
        """The serving cache: one flat dict of tensors a layer, then one a
        shared-block application (a hybrid stack's ``n_groups``). An
        attention layer's is a page pool with one extra write-discard page
        (no per-slot state); ``quant_kv`` makes it int8 with per-token f32
        scale buffers ``k_scale``/``v_scale`` of shape (P+1, page) beside
        it, and the attention step keys the int8 path on their presence. A
        mamba layer's is its state for each of ``slots`` slots, {"ssd":
        (slots, H, P, N), "conv": (slots, K - 1, C)} in f32 (``slots`` is
        needed only then). The shared block's pools stay full width with
        ``quant_kv``, as the JAX package's do."""
        cfg = self.cfg
        dtype = dtype or dtype_of(cfg)
        device = device or self.embed.table.device
        shape = (total_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)

        def pool(quant):
            if not quant:
                return {k: torch.zeros(shape, dtype=dtype, device=device)
                        for k in ("k_pages", "v_pages")}
            c = {k: torch.zeros(shape, dtype=torch.int8, device=device)
                 for k in ("k_pages", "v_pages")}
            c.update({k: torch.zeros(shape[:2], dtype=torch.float32,
                                     device=device)
                      for k in ("k_scale", "v_scale")})
            return c

        def entry(layer):
            if not isinstance(layer, MambaLayer):
                return pool(quant_kv)
            if slots is None:
                raise ValueError("a stack with mamba layers keeps state per "
                                 "slot: pass slots to init_paged_cache")
            return layer.mixer.init_state(slots, device=device)

        return [entry(layer) for layer in self.layers] + [
            pool(False) for _ in self.shared_after]

    def reset_slot_state(self, cache: List[dict], slot: int) -> None:
        """Zero one slot's SSM state in ``cache``, in place: a freed slot's
        new occupant must not inherit the previous sequence's state, which
        a chunk carries in unmasked (attention pages need no reset: stale
        KV is masked by the sequence length)."""
        for layer, c in zip(self.layers, cache):
            if isinstance(layer, MambaLayer):
                for t in c.values():
                    t[slot].zero_()

    def logits_fn(self, h: torch.Tensor) -> torch.Tensor:
        logits = self.embed.attend(h) if self.head is None else self.head(h)
        cap = self.cfg.final_softcap
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        return logits

    # -- training ------------------------------------------------------------

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        cdt = dtype_of(self.cfg)
        x = self.embed(tokens, dtype=cdt)
        if self.cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=cdt)
        return x

    def embed_in(self, tokens: Optional[torch.Tensor] = None,
                 embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The input in the compute dtype: token embeddings, or with
        ``input_mode="embeddings"`` the frontend's ``embeds`` (B, S,
        frontend_dim) through the projector (the tokens are then not
        read, as in the JAX package); scaled by sqrt(d_model) where the
        model asks for it."""
        cfg = self.cfg
        if cfg.input_mode != "embeddings":
            return self._embed_tokens(tokens)
        if embeds is None:
            raise ValueError(f"{cfg.name} reads the frontend's embeddings: "
                             f"pass embeds")
        cdt = dtype_of(cfg)
        x = self.proj_in(embeds.to(cdt))
        x = self.proj_mid(activation("gelu")(x))
        if cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)
        return x

    def _run_layers(self, x: torch.Tensor, collect: bool = False):
        """x (B, S, d) through the layers -> (final-normed hidden states,
        the MoE aux values summed over layers, and with ``collect`` each
        layer's KV (a mamba layer's final state) for the dense cache, then
        each shared-block application's, else [])."""
        emb = x
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        aux_tot: Dict[str, torch.Tensor] = {}
        kvs: List[dict] = []
        shared_kvs: List[dict] = []
        for i, layer in enumerate(self.layers):
            if collect:
                x, aux, kv = layer(x, positions, collect=True)
                kvs.append(kv)
            else:
                x, aux = self._run(layer, x, positions)
            for k, v in aux.items():
                aux_tot[k] = aux_tot[k] + v if k in aux_tot else v
            if i in self.shared_after:
                if collect:
                    x, kv = self.shared(x, emb, positions, collect=True)
                    shared_kvs.append(kv)
                else:
                    x = self._run(self.shared, x, emb, positions)
        return self.ln_f(x), aux_tot, kvs + shared_kvs

    def forward(self, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) int (or a stub frontend's ``embeds``, see
        ``embed_in``) -> (final-normed hidden states (B, S, d), the MoE
        blocks' aux values summed over layers, {} without MoE)."""
        h, aux, _ = self._run_layers(self.embed_in(tokens, embeds))
        return h, aux

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy of ``batch`` ({"tokens", "labels"},
        (B, S) int; a label < 0 is ignored), in f32, over ``loss_chunk``
        sequence chunks (a tail shorter than a chunk is dropped, as in the
        JAX package), plus the MoE aux terms. Returns (loss, {"loss",
        "tokens"}, and for MoE "moe_lb" and "moe_z" summed over layers);
        the metric "loss" is the cross entropy alone."""
        h, aux = self.forward(batch.get("tokens"), batch.get("embeds"))
        tot, cnt = self._xent(h, batch["labels"], tail=False)
        loss = tot / torch.clamp_min(cnt, 1.0)
        metrics = {"loss": loss, "tokens": cnt}
        for k, v in aux.items():
            loss = loss + _AUX_SCALE[k] * v.float() / len(self.layers)
            metrics[k] = v
        return loss, metrics

    # -- the dense-cache loop ------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], s_max: int
                ) -> Tuple[torch.Tensor, dict]:
        """Run the prompt ({"tokens": (B, S) int} or a stub frontend's
        {"embeds": (B, S, frontend_dim)}) and build a dense cache of
        ``s_max`` positions: (last-token logits (B, 1, V), {"layers": the
        caches, "pos": S, "enc_len": 0}); a mamba layer's state is the one
        the prompt ends with."""
        h, _, kvs = self._run_layers(
            self.embed_in(batch.get("tokens"), batch.get("embeds")),
            collect=True)
        b, s = h.shape[:2]
        layers = self.init_cache(b, s_max, device=h.device)
        _write_prefill(layers, kvs)
        return self.logits_fn(h[:, -1:]), {"layers": layers, "pos": s,
                                           "enc_len": 0}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict
                    ) -> Tuple[torch.Tensor, dict]:
        """One decode step of every row: token (B, 1) int (or (B, 1, F)
        frontend embeddings through the projector) -> (logits (B, 1, V),
        ``cache``, written in place at its position, which advances). A
        stub-frontend model embeds generated text tokens through the
        table: the frontend only feeds the prefill."""
        x = self._embed_tokens(token) if token.dim() == 2 \
            else self.embed_in(embeds=token)
        x = self._decode_layers(x, cache, emb=x)
        return self.logits_fn(self.ln_f(x)), cache

    # -- serving -------------------------------------------------------------

    @torch.no_grad()
    def paged_step(self, tokens: torch.Tensor, pos: torch.Tensor,
                   n_new: torch.Tensor, cache: List[dict],
                   page_table: torch.Tensor, *,
                   all_logits: bool = False,
                   slot_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One engine step: tokens (B, C) int, per-row start positions
        ``pos`` (B,) and valid counts ``n_new`` (B,), int32. C == 1 is a
        batched decode step, C > 1 one prefill chunk or a speculative verify
        chunk (pending token + drafts, ``n_new`` below C where a row drafted
        fewer). Updates the cache in place and returns the logits of each
        row's last valid token, (B, 1, V), or with ``all_logits`` those of
        every chunk position, (B, C, V): the verify step reads the greedy
        continuation after each draft. Logits at positions past a row's
        ``n_new`` are computed but mean nothing. Row i's SSM state is that
        of slot ``slot_ids[i]`` (B,), or of slot i without it (the engine's
        rows are its slots). A mamba layer folds a row's whole chunk into
        its state, padding past ``n_new`` included, as the JAX step does;
        the engine's prefill rows fill their chunk. Only token-input
        models serve here; a stub frontend feeds the dense-cache loop."""
        if self.cfg.input_mode != "tokens":
            raise NotImplementedError(
                "paged serving expects token inputs (stub frontends feed "
                "the dense-cache loop, launch.serve.generate_cached)")
        x = self.embed(tokens)
        if self.cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        emb = x
        if slot_ids is not None:
            slot_ids = slot_ids.long()
        shared = cache[len(self.layers):]
        for i, (layer, c) in enumerate(zip(self.layers, cache)):
            if isinstance(layer, MambaLayer):
                x = layer.paged_step(x, pos, n_new, c, page_table, slot_ids)
            else:
                x = layer.paged_step(x, pos, n_new, c, page_table)
            g = self.shared_after.get(i)
            if g is not None:
                x = self.shared.paged_step(x, emb, pos, n_new, shared[g],
                                           page_table)
        x = self.ln_f(x)
        if all_logits:
            return self.logits_fn(x)
        idx = torch.clamp(n_new.long() - 1, 0, x.shape[1] - 1)
        h_last = torch.gather(
            x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
        return self.logits_fn(h_last)


class EncDec(_DenseCacheLoop, nn.Module):
    """Encoder-decoder transformer (seamless-m4t's backbone): the encoder
    reads the stub frontend's frame embeddings, the decoder is a causal
    token LM with cross-attention to the encoder's output."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.enc_dec is None:
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        self.cfg = cfg
        ed, pd = cfg.enc_dec, param_dtype_of(cfg)
        kw = dict(device=device, generator=generator)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, pd, device,
                               generator)
        self.adapter = Linear(cfg.frontend_dim or cfg.d_model, cfg.d_model,
                              bias=True, dtype=pd, **kw)
        self.encoder = _blocks(cfg, ("global",) * ed.n_encoder_layers,
                               ENCODER_SEED, **kw)
        self.decoder = _blocks(cfg, ("global",) * ed.n_decoder_layers,
                               DECODER_SEED, cross=True, **kw)
        self.ln_enc = RMSNorm(cfg.d_model, cfg.rms_eps, pd, device)
        self.ln_f = RMSNorm(cfg.d_model, cfg.rms_eps, pd, device)

    @property
    def _cache_layers(self) -> nn.ModuleList:
        return self.decoder

    def logits_fn(self, h: torch.Tensor) -> torch.Tensor:
        """The tied head, with no final softcap (the JAX ``EncDec``)."""
        return self.embed.attend(h)

    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, Se, frontend_dim) -> the encoder's normed
        output (B, Se, d) in the compute dtype: the adapter, then the
        encoder's bidirectional layers."""
        x = self.adapter(embeds.to(dtype_of(self.cfg)))
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for layer in self.encoder:
            x, _ = self._run(layer, x, positions, causal=False)
        return self.ln_enc(x)

    def forward(self, tokens: torch.Tensor, embeds: torch.Tensor,
                collect: bool = False):
        """Decoder tokens (B, S) int and encoder frames ``embeds`` ->
        (final-normed decoder states (B, S, d), each decoder layer's KV
        for the dense cache with ``collect`` (self and cross), else [],
        the encoder's output). Under remat each layer is recomputed in the
        backward pass, and the encoder's output gets the gradients of
        every decoder layer's cross k and v projections."""
        enc_out = self.encode(embeds)
        x = self.embed(tokens, dtype=dtype_of(self.cfg))
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        kvs: List[dict] = []
        for layer in self.decoder:
            if collect:
                x, _, kv = layer(x, positions, enc_out=enc_out, collect=True)
                kvs.append(kv)
            else:
                x, _ = self._run(layer, x, positions, enc_out=enc_out)
        return self.ln_f(x), kvs, enc_out

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross entropy of the decoder's ``batch["tokens"]`` against
        ``batch["labels"]`` (B, S) int (a label < 0 is ignored), the encoder
        reading ``batch["embeds"]`` (B, Se, frontend_dim): f32 logits of
        the tied head, the mean over the valid labels of every position
        (the JAX ``EncDec.loss``; chunked here, the tail included). Returns
        (loss, {"loss", "tokens"})."""
        h, _, _ = self.forward(batch["tokens"], batch["embeds"])
        tot, cnt = self._xent(h, batch["labels"], tail=True)
        loss = tot / torch.clamp_min(cnt, 1.0)
        return loss, {"loss": loss, "tokens": cnt}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor], s_max: int
                ) -> Tuple[torch.Tensor, dict]:
        """Encode ``batch["embeds"]``, run the decoder prompt
        ``batch["tokens"]`` and build the dense caches (self of ``s_max``
        positions, cross of the encoder's frames, written once here):
        (last-token logits (B, 1, V), {"layers", "pos", "enc_len"})."""
        h, kvs, enc_out = self.forward(batch["tokens"], batch["embeds"],
                                       collect=True)
        b, s = h.shape[:2]
        enc_len = enc_out.shape[1]
        layers = self.init_cache(b, s_max, device=h.device, enc_len=enc_len)
        _write_prefill(layers, kvs)
        return self.logits_fn(h[:, -1:]), {"layers": layers, "pos": s,
                                           "enc_len": enc_len}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict
                    ) -> Tuple[torch.Tensor, dict]:
        """One decoder token per row (B, 1) int -> (logits (B, 1, V),
        ``cache``, its self caches written in place, its position
        advanced)."""
        x = self.embed(token, dtype=dtype_of(self.cfg))
        x = self._decode_layers(x, cache)
        return self.logits_fn(self.ln_f(x)), cache


def build_model(cfg: ModelConfig, *, device=None,
                generator: Optional[torch.Generator] = None):
    """``EncDec`` for an encoder-decoder configuration, else ``LM``."""
    cls = EncDec if cfg.enc_dec is not None else LM
    return cls(cfg, device=device, generator=generator)
