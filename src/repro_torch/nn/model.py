"""The decoder-only LM (port of ``repro.nn.model.LM``): the full-sequence
forward and chunked cross-entropy loss of training, and the paged serving
step.

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

With ``cfg.remat`` the training forward recomputes each layer, and the loss
each sequence chunk, in the backward pass (``torch.utils.checkpoint``); the
JAX package recomputes each scanned group of layers instead. The results
are the same, only the memory differs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .common import ModelConfig, dtype_of, param_dtype_of
from .layers import Embedding, Linear, RMSNorm
from .transformer import MambaLayer, SharedAttnBlock, TransformerBlock

# weight of each MoE aux value in the loss, as in the JAX package
_AUX_SCALE = {"moe_lb": 0.01, "moe_z": 1.0}


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
                unit: Optional[int] = None) -> List[int]:
    """Per-layer block seeds of the JAX stack: ``pro_n`` prologue blocks,
    then the scan slots of the rest (repeating ``unit`` layers, by default
    ``detect_unit``'s), then its epilogue."""
    rest = kinds[pro_n:]
    if not rest:
        return [1000 * i for i in range(len(kinds))]
    unit = unit or detect_unit(rest)
    scanned = (len(rest) // unit) * unit
    return [1000 * i for i in range(pro_n)] + [
        10 * (i % unit) + 1 if i < scanned else 2000 + 10 * (i - scanned)
        for i in range(len(rest))]


class LM(nn.Module):
    """Decoder-only token LM. With ``tie_embeddings`` the logits are
    ``h @ embed.table^T``; without, a dense ``head`` ``Linear(d_model,
    vocab_size)`` without bias in the parameter dtype computes them (the
    JAX ``LM.head``), its product a ``torch.matmul`` as the JAX package's
    is an XLA dot. The final softcap applies to either."""

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
        self.head = None if cfg.tie_embeddings else Linear(
            cfg.d_model, cfg.vocab_size, dtype=pd, device=device,
            generator=generator)

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

    def _remat(self) -> bool:
        return self.cfg.remat and torch.is_grad_enabled()

    def embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings in the compute dtype, scaled by sqrt(d_model)
        where the model asks for it."""
        cdt = dtype_of(self.cfg)
        x = self.embed(tokens, dtype=cdt)
        if self.cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=cdt)
        return x

    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) int -> (final-normed hidden states (B, S, d), the
        MoE blocks' aux values summed over layers, {} without MoE)."""
        x = self.embed_in(tokens)
        emb = x
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        aux_tot: Dict[str, torch.Tensor] = {}

        def run(fn, *args):
            if self._remat():
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        for i, layer in enumerate(self.layers):
            x, aux = run(layer, x, positions)
            for k, v in aux.items():
                aux_tot[k] = aux_tot[k] + v if k in aux_tot else v
            if i in self.shared_after:
                x = run(self.shared, x, emb, positions)
        return self.ln_f(x), aux_tot

    def _chunk_loss(self, h: torch.Tensor, labels: torch.Tensor):
        logits = self.logits_fn(h).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp_min(0)[..., None].long())[..., 0]
        valid = (labels >= 0).float()
        return ((logz - gold) * valid).sum(), valid.sum()

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy of ``batch`` ({"tokens", "labels"},
        (B, S) int; a label < 0 is ignored), in f32, over ``loss_chunk``
        sequence chunks (a tail shorter than a chunk is dropped, as in the
        JAX package), plus the MoE aux terms. Returns (loss, {"loss",
        "tokens"}, and for MoE "moe_lb" and "moe_z" summed over layers);
        the metric "loss" is the cross entropy alone."""
        h, aux = self.forward(batch["tokens"])
        labels = batch["labels"]
        s = labels.shape[1]
        chunk = min(self.cfg.loss_chunk, s)
        tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(s // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            if self._remat():
                t, c = checkpoint(self._chunk_loss, h[:, sl], labels[:, sl],
                                  use_reentrant=False)
            else:
                t, c = self._chunk_loss(h[:, sl], labels[:, sl])
            tot, cnt = tot + t, cnt + c
        loss = tot / torch.clamp_min(cnt, 1.0)
        metrics = {"loss": loss, "tokens": cnt}
        for k, v in aux.items():
            loss = loss + _AUX_SCALE[k] * v.float() / len(self.layers)
            metrics[k] = v
        return loss, metrics

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
        the engine's prefill rows fill their chunk."""
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
