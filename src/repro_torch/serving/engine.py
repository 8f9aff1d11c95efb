"""ServingEngine: continuous-batching inference over the paged cache (port of
``repro.serving.engine``).

One ``step()`` executes a scheduler plan: chunked prefill for sequences
still consuming their prompt, packed into one batched call per chunk length,
then one batched decode step for every running sequence. Every FFN junction
runs the ``csd_spmm_fwd`` kernel and every decode step the paged decode
kernel when the model lives on the card; on the CPU the same code runs the
plain versions.

Speculative decode (``spec_k > 0``, greedy only): a prompt-lookup drafter
proposes up to ``spec_k`` tokens per decode slot, and when any slot drafted
the decode step becomes one verify chunk of ``1 + spec_k`` positions over
every slot (the prefill chunk path: its junctions at M = slots x (1 +
spec_k), attention by gather), whose logits at every position give the
greedy continuation; the longest matching prefix of drafts is accepted and
the rejected KV rolled back with ``kv_cache.truncate``. The tokens are those
of plain greedy decode. A step where no slot drafted is the plain decode
step, paged decode kernel included.

At load the engine moves the model to its device and compute dtype once
(bf16 for the full configs): the JAX ``Linear`` casts its f32 weight on
every call, which here would triple the bytes each junction reads. It moves
and casts one part at a time (the embedding, each layer, the final norm,
the head), so that a model given on the host never lies on the card whole
in its parameter dtype: granite-34b's f32 parameters (~118 GB) would not
fit an 80 GB card, its bf16 ones do. The allocator stays on the host; each
step sends the page table, the positions and the valid counts to the
device.

int8 serving (``EngineConfig.quant``, or the model's
``SparsityConfig.quant`` when that is None): with ``weights`` every sparse
junction (MoE expert slabs included) is quantized once at load, from the
weights as given and before the cast to the compute dtype, and then runs
the int8 forward kernel; with ``kv`` the page pools are int8 with
per-token scales and decode runs the int8 paged-decode kernel.

MoE models serve only dropless (``capacity_factor >= n_routed / top_k``):
a batched step runs the rows of inactive slots too, and with a finite
expert capacity those rows could evict real tokens from their experts'
buffers.

Stacks with mamba layers (mamba2, zamba2) keep each slot's SSM state in
the cache beside the page pools (``LM.init_paged_cache(slots=...)``). A
slot admitted in a step has its state zeroed before its first chunk, and
such stacks serve without speculative decode (``spec_k`` is clamped to 0):
a recurrent state cannot be rolled back as paged KV can.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.quant import QuantConfig, quantize_model
from ..nn.common import dtype_of, resolve_device
from .scheduler import Request, Scheduler, StepPlan
from .spec import PromptLookupDrafter


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs. ``token_budget`` is the per-step work quantum (the
    paper's degree of parallelism ``z``), ``page_size`` the KV allocation
    granularity, ``max_slots`` the number of resident sequences."""
    max_slots: int = 8
    page_size: int = 16
    total_pages: int = 128
    max_pages_per_seq: int = 32
    token_budget: int = 64
    prefill_chunk: int = 32
    greedy: bool = True
    temperature: float = 1.0
    # speculative decode: up to spec_k prompt-lookup drafts per decode slot,
    # verified in one multi-token step (0 = off; greedy only)
    spec_k: int = 0
    spec_ngram: int = 3         # longest suffix n-gram the drafter matches
    # int8 inference: quantize the sparse junctions' slabs per block at load
    # (weights=True) and/or keep the KV pages in int8 with per-token scales
    # (kv=True). None falls back to the model's SparsityConfig.quant
    quant: Optional[QuantConfig] = None


def load(model, device: torch.device, dtype: torch.dtype, *,
          quantize: bool = False):
    """``model`` on ``device`` in ``dtype``, one part at a time: each of
    its top-level modules (and each layer of a ``ModuleList``) is moved to
    the device, its sparse junctions quantized from the weights as given
    when ``quantize`` is set (the scales stay f32 through the cast), then
    cast. Returns ``model``, changed in place."""
    parts = []
    for child in model.children():
        parts += list(child) if isinstance(child, torch.nn.ModuleList) \
            else [child]
    for part in parts:
        part.to(device=device)
        if quantize:
            quantize_model(part)
        part.to(dtype=dtype)
    return model.to(device=device, dtype=dtype)


class ServingEngine:
    """Continuous-batching engine: add requests any time, call ``step()``
    (or ``run()``) and collect finished generations."""

    def __init__(self, model, config: Optional[EngineConfig] = None, *,
                 device=None, seed: int = 0, **overrides):
        if overrides and config is not None:
            raise ValueError("pass EngineConfig or overrides, not both")
        cfg = config or EngineConfig(**overrides)
        mc = model.cfg
        moe = mc.moe
        if moe is not None and moe.capacity_factor * moe.top_k \
                < moe.n_routed:
            raise NotImplementedError(
                f"paged serving with capacity-constrained MoE "
                f"(capacity_factor={moe.capacity_factor}): rebuild the "
                f"model with capacity_factor >= n_routed/top_k = "
                f"{moe.n_routed / moe.top_k:.1f} (dropless decode)")
        self.device = resolve_device(device)
        qc = cfg.quant if cfg.quant is not None else mc.sparsity.quant
        self.quant = qc
        self.model = model = load(model, self.device, dtype_of(mc),
                                  quantize=qc is not None and qc.weights)
        self.config = cfg
        self.seed = seed
        # acceptance compares argmax continuations, so speculation is greedy
        # only, and it needs rollback: paged KV truncates, a mamba layer's
        # recurrent state does not
        self.spec_k = cfg.spec_k if cfg.greedy \
            and "mamba" not in mc.layer_kinds else 0
        self.sched = Scheduler(
            slots=cfg.max_slots, total_pages=cfg.total_pages,
            page_size=cfg.page_size,
            max_pages_per_seq=cfg.max_pages_per_seq,
            token_budget=cfg.token_budget,
            prefill_chunk=cfg.prefill_chunk,
            window=self._reclaim_window(mc), spec_k=self.spec_k,
            drafter=PromptLookupDrafter(cfg.spec_ngram) if self.spec_k
            else None)
        self.cache = model.init_paged_cache(
            cfg.total_pages, cfg.page_size, dtype_of(mc), self.device,
            quant_kv=qc is not None and qc.kv, slots=cfg.max_slots)
        self._next_id = 0
        self.outputs: Dict[int, np.ndarray] = {}

    @staticmethod
    def _reclaim_window(mc) -> Optional[int]:
        """Sliding-window page reclamation is sound only when every
        attention layer is windowed: all page pools share one page table,
        so a page may be freed only when no layer can still read it. Mamba
        layers hold no pages and do not constrain it; a hybrid stack's
        shared block attends globally."""
        kinds = set(mc.layer_kinds)
        if mc.attn_window is not None and kinds <= {"local", "mamba"} \
                and "local" in kinds and mc.hybrid is None:
            return int(mc.attn_window)
        return None

    # -- request intake ----------------------------------------------------

    def add_request(self, prompt, max_new_tokens: int,
                    req_id: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = len(prompt) + max_new_tokens
        cap = min(self.config.max_pages_per_seq,
                  self.config.total_pages) * self.config.page_size
        if need > cap:
            raise ValueError(
                f"request needs {need} tokens but a sequence can hold at "
                f"most {cap} (min(max_pages_per_seq, total_pages) * "
                f"page_size)")
        if req_id is None:
            req_id = self._next_id
        elif any(r.req_id == req_id for r in self.sched.waiting) or any(
                s is not None and s.req.req_id == req_id
                for s in self.sched.active):
            raise ValueError(f"req_id {req_id} is already queued or in flight")
        self._next_id = max(self._next_id, req_id) + 1
        self.sched.add(Request(req_id=req_id, prompt=prompt,
                               max_new_tokens=max_new_tokens))
        return req_id

    # -- sampling ----------------------------------------------------------

    def _sample(self, logits: torch.Tensor, slot: int) -> int:
        if self.config.greedy:
            return int(torch.argmax(logits))
        seq = self.sched.active[slot]
        # one stream per (request, absolute position): a preempted and
        # recomputed sequence re-draws identical tokens
        rng = np.random.default_rng((self.seed, seq.req.req_id,
                                     len(seq.tokens)))
        z = logits.double().cpu().numpy() / self.config.temperature
        p = np.exp(z - z.max())
        return int(rng.choice(len(p), p=p / p.sum()))

    # -- the step ----------------------------------------------------------

    def _run(self, tokens: np.ndarray, pos: np.ndarray,
             n_new: np.ndarray, all_logits: bool = False) -> torch.Tensor:
        dev = self.device
        return self.model.paged_step(
            torch.as_tensor(tokens, device=dev),
            torch.as_tensor(pos, dtype=torch.int32, device=dev),
            torch.as_tensor(n_new, device=dev), self.cache,
            torch.as_tensor(self.sched.state.page_table, device=dev),
            all_logits=all_logits)

    def step(self) -> Tuple[StepPlan, List[Tuple[int, np.ndarray]]]:
        """Run one engine step; returns (plan, finished) where finished is
        a list of (req_id, generated token ids)."""
        cfg = self.config
        plan = self.sched.schedule()
        # a re-admitted slot may have hosted another sequence: clear its
        # SSM state before the first prefill chunk touches it
        for slot in plan.admitted:
            self.model.reset_slot_state(self.cache, slot)
        slots = cfg.max_slots
        for group in plan.prefill_groups:
            # equal-length chunks of different sequences in ONE call; slots
            # without a chunk ride along inactive with n_new == 0
            c = len(group[0][2])
            tokens = np.zeros((slots, c), np.int32)
            pos = np.zeros((slots,), np.int32)
            n_new = np.zeros((slots,), np.int32)
            for slot, start, toks in group:
                tokens[slot, :len(toks)] = toks
                pos[slot] = start
                n_new[slot] = len(toks)
            logits = self._run(tokens, pos, n_new)
            for slot, _, toks in group:
                self.sched.advance_prefill(slot, len(toks))
                seq = self.sched.active[slot]
                if not seq.prefilling and len(seq.tokens) == seq.n_prefilled:
                    # prompt fully cached and no pending token yet (also
                    # true right after a preemption recompute): sample it
                    self.sched.append_token(
                        slot, self._sample(logits[slot, 0], slot))

        if plan.drafts:
            self._verify_decode(plan)
        elif plan.decode_slots:
            # plain decode (C == 1): the paged decode kernel
            tokens = np.zeros((slots, 1), np.int32)
            n_new = np.zeros((slots,), np.int32)
            for s in plan.decode_slots:
                tokens[s, 0] = self.sched.active[s].pending_token
                n_new[s] = 1
            logits = self._run(tokens, self.sched.state.seq_lens, n_new)
            greedy = torch.argmax(logits[:, 0], dim=-1).cpu().numpy() \
                if cfg.greedy else None
            for s in plan.decode_slots:
                self.sched.note_decoded(s)
                tok = int(greedy[s]) if cfg.greedy \
                    else self._sample(logits[s, 0], s)
                self.sched.append_token(s, tok)

        finished = []
        for s in range(slots):
            seq = self.sched.active[s]
            if seq is not None and seq.done:
                req, gen = self.sched.finish(s)
                self.outputs[req.req_id] = gen
                finished.append((req.req_id, gen))
        return plan, finished

    def _verify_decode(self, plan: StepPlan) -> None:
        """Verify pending + drafts of every decode slot in one multi-token
        ``paged_step``: ``n_new`` = 1 + drafts per row, the chunk padded to
        ``1 + spec_k`` over all slots. The argmax runs on the device and
        only the (slots, C) greedy tokens come to the host. The longest
        prefix of drafts that matches the greedy continuation is accepted,
        so the committed tokens are those plain decode would give; the
        rejected tail rolls back in ``note_verified``."""
        slots = self.config.max_slots
        tokens = np.zeros((slots, 1 + self.spec_k), np.int32)
        n_new = np.zeros((slots,), np.int32)
        for s in plan.decode_slots:
            row = [self.sched.active[s].pending_token] \
                + plan.drafts.get(s, [])
            tokens[s, :len(row)] = row
            n_new[s] = len(row)
        logits = self._run(tokens, self.sched.state.seq_lens, n_new,
                           all_logits=True)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()   # (slots, C)
        for s in plan.decode_slots:
            drafts = plan.drafts.get(s, [])
            g = greedy[s]
            m = 0
            while m < len(drafts) and drafts[m] == int(g[m]):
                m += 1
            # committed: the pending token and m drafts; emitted: their
            # greedy continuations g[0..m] (g[m] becomes the new pending
            # token, as after a plain decode step)
            self.sched.note_verified(s, n_written=1 + len(drafts),
                                     n_accepted=1 + m)
            for i in range(m + 1):
                self.sched.append_token(s, int(g[i]))

    # -- drain loop --------------------------------------------------------

    def run(self, prompts: Sequence, max_new_tokens,
            max_steps: int = 100_000) -> List[np.ndarray]:
        """Submit ``prompts`` (1-D int arrays) and step until all finish;
        returns the generated ids per prompt, in submission order.
        ``max_new_tokens`` is an int or a per-prompt list."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        ids = [self.add_request(p, n)
               for p, n in zip(prompts, max_new_tokens)]
        steps = 0
        while self.sched.has_work():
            plan, _ = self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("engine failed to drain (stuck plan?)")
            if plan.n_tokens == 0 and not plan.admitted \
                    and not plan.preempted:
                raise RuntimeError(
                    "scheduler produced an empty plan with work pending — "
                    "page pool too small for any resident sequence")
        return [self.outputs.pop(i) for i in ids]
