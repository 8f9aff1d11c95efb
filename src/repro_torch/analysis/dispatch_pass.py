"""Pass 2 — dispatch lint of the port's steps (the port's counterpart of
``repro.analysis.jaxpr_pass``).

PyTorch runs eagerly, so there is no jaxpr to read: the pass runs the real
steps under a ``TorchDispatchMode`` that records every aten op with the
dtypes, shapes and devices of its inputs and outputs, and lints that
record. The steps are those the entry points run, for every registered
config: ``LM.paged_step`` (one prefill chunk and one decode step, with
full-width and with int8 weights and KV pages; the MoE made dropless, as
the serving engine requires) and one ``Trainer.train_step`` (forward,
backward and the AdamW update). A config that serves only through the
dense-cache loop (an encoder-decoder or a stub frontend: seamless-m4t,
llava) steps what its entry point, ``launch.serve.generate_cached``, runs:
one ``prefill`` and one ``decode_step``, full width (it has no paged step,
and the dense-cache loop has no int8 form, in the JAX package neither),
and one ``Trainer.train_step`` on a batch with the frontend's ``embeds``.
They run at the smoke size on the CPU and at full width on the card (at
``card_depth``), where the step also runs under
``torch.cuda.set_sync_debug_mode("error")``. The CUDA kernels themselves
are ctypes calls the mode does not see; everything around them is.

Checks:

* **SL201** — a host sync inside a step: ``aten._local_scalar_dense``
  (``.item()``, ``int(t)``, ``float(t)``), ``aten.item``,
  ``aten.nonzero`` (one-argument ``where``), ``aten.is_nonzero``
  (``if t:``), indexing with a boolean mask, an op that sizes its output
  from the data (``masked_select``, ``bincount``, ``unique``,
  ``repeat_interleave`` with tensor repeats), or a copy from the card to
  the CPU; on the card also whatever the sync debug mode refuses. Each
  stalls the launch queue on a round trip every step.
* **SL203** — wide-dtype creep: any float64 or complex128 tensor in a step
  (nothing in the port should promote past f32).
* **SL206** — quantization-defeating upcast: an op that takes an int8
  tensor with the shape of a whole slab or a whole KV pool (an int8 input
  of the step of rank >= 4) and returns a float tensor of that shape. A
  full-width copy of the quantized tensor erases the int8 bandwidth win;
  the plain versions dequantize one slot or the gathered pages, the kernels
  one tile. The self-test subject (``--selftest-inject``) is a junction
  that dequantizes its whole slab and must trip it.

Codes of the reference with no counterpart yet:

* **SL202** (donation) — on the port, a step that allocates a second copy
  of a large parameter, optimizer or KV tensor instead of updating it in
  place. It comes with the CUDA-graph work (static buffers for the decode
  and training steps).
* **SL204** (baked constants) — on the port, a large tensor captured into
  a CUDA graph instead of passed as an input. It comes with the same work.
* **SL205** (shard_map collectives) — comes with the multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .findings import Finding

HOST_SYNC_OPS = {"aten._local_scalar_dense", "aten.item", "aten.nonzero",
                 "aten.is_nonzero"}
# ops whose output size depends on the data: the card must report it back
# before the host can go on (the CPU computes it in place, out of sight)
DATA_SIZED_OPS = {"aten.masked_select", "aten.bincount", "aten._unique2",
                  "aten.unique_dim", "aten.unique_consecutive"}
INDEX_OPS = {"aten.index", "aten.index_put", "aten.index_put_",
             "aten._index_put_impl_"}
COPY_OPS = {"aten._to_copy", "aten.copy_", "aten.copy"}
WIDE_DTYPES = (torch.float64, torch.complex128)


@dataclasses.dataclass
class OpRecord:
    op: str
    ins: List[Tuple[torch.dtype, Tuple[int, ...], str]]
    outs: List[Tuple[torch.dtype, Tuple[int, ...], str]]
    sync: Optional[str] = None  # why the op syncs with the host, if it does


def _meta(t: torch.Tensor):
    return t.dtype, tuple(t.shape), t.device.type


def _sync_reason(op: str, func, args, kwargs) -> Optional[str]:
    if op in HOST_SYNC_OPS:
        return "reads a value back"
    if op in DATA_SIZED_OPS:
        return "sizes its output from the data"
    if op == "aten.repeat_interleave" and "Tensor" in str(func) \
            and (kwargs or {}).get("output_size") is None:
        return "sizes its output from tensor repeats"
    if op in INDEX_OPS and len(args) > 1 and any(
            isinstance(t, torch.Tensor) and t.dtype in (torch.bool,
                                                        torch.uint8)
            for t in tree_leaves(args[1])):
        return "indexes with a boolean mask (a nonzero inside)"
    return None


class Recorder(TorchDispatchMode):
    """Records every aten op run under it: name, (dtype, shape, device) of
    each tensor input and output, and why it syncs with the host if it
    does."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = str(func.overloadpacket)
        self.ops.append(OpRecord(
            op,
            [_meta(t) for t in tree_leaves((args, kwargs))
             if isinstance(t, torch.Tensor)],
            [_meta(t) for t in tree_leaves(out)
             if isinstance(t, torch.Tensor)],
            _sync_reason(op, func, args, kwargs)))
        return out


def lint_ops(ops: Sequence[OpRecord], subject: str,
             slab_shapes: Set[Tuple[int, ...]] = frozenset()
             ) -> List[Finding]:
    """SL201, SL203 and SL206 over one step's op record."""
    f: List[Finding] = []
    seen = set()

    def once(key, finding):
        if key not in seen:
            seen.add(key)
            f.append(finding)

    for rec in ops:
        devices_in = {d for _, _, d in rec.ins}
        why = rec.sync
        if why is None and rec.op in COPY_OPS and "cuda" in devices_in \
                and any(d == "cpu" for _, _, d in rec.outs):
            why = "copies from the card to the CPU"
        if why is not None:
            once(("SL201", rec.op), Finding(
                "SL201", subject,
                f"'{rec.op}' inside the step {why}: a host sync "
                f"(inputs {[(str(t), s) for t, s, _ in rec.ins][:3]})",
                {"op": rec.op}))
        for dt, shape, _ in rec.ins + rec.outs:
            if dt in WIDE_DTYPES:
                once(("SL203", rec.op, dt), Finding(
                    "SL203", subject,
                    f"'{rec.op}' touches a {dt} tensor {shape} — unintended "
                    "wide-dtype promotion", {"dtype": str(dt)}))
        for dt, shape, _ in rec.ins:
            if dt == torch.int8 and shape in slab_shapes and any(
                    o_dt.is_floating_point and o_shape == shape
                    for o_dt, o_shape, _ in rec.outs):
                once(("SL206", shape), Finding(
                    "SL206", subject,
                    f"'{rec.op}' upcasts the whole int8 slab or KV pool "
                    f"{shape} to a float dtype — a full-width copy of the "
                    "quantized tensor; dequantize per slot / per page inside "
                    "the junction instead", {"shape": list(shape)}))
    return f


def int8_shapes(*tensors) -> Set[Tuple[int, ...]]:
    """Shapes of the whole int8 slabs / KV pools among ``tensors``."""
    return {tuple(t.shape) for t in tensors
            if isinstance(t, torch.Tensor) and t.dtype == torch.int8
            and t.dim() >= 4}


def trace(step: Callable[[], object], device: torch.device) -> Tuple[
        List[OpRecord], Optional[str]]:
    """Run ``step`` under the recorder (on the card also under the sync
    debug mode "error"); (op record, the sync error's message or None)."""
    rec = Recorder()
    sync_error = None
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
    try:
        with rec:
            step()
    except RuntimeError as e:
        if not on_card or "synchroniz" not in str(e).lower():
            raise
        sync_error = str(e).splitlines()[0]
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize(device)
    return rec.ops, sync_error


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _dropless(cfg):
    """The MoE with the capacity factor paged serving needs (as the serving
    engine requires it: n_routed / top_k)."""
    moe = cfg.moe
    if moe is None or moe.capacity_factor * moe.top_k >= moe.n_routed:
        return cfg
    return cfg.with_(moe=dataclasses.replace(
        moe, capacity_factor=moe.n_routed / moe.top_k))


# the f32 training state (parameters, gradients and AdamW's two moments,
# 16 bytes a parameter) the card's steps may hold at full depth; a config
# past it (gemma2-9b, qwen2-7b, granite-34b, llava-next-34b) runs its
# full-width steps at the depth of two of its repeating units, at least two
# layers (every layer of a unit runs the same ops)
CARD_STATE_BYTES = 64e9


def card_depth(cfg):
    """``cfg`` at the depth the card's dispatch-pass steps run: its own
    where the f32 training state fits ``CARD_STATE_BYTES``, else two of its
    repeating units of layers."""
    from ..nn.model import build_model, detect_unit
    n = sum(p.numel() for p in build_model(cfg, device="meta").parameters())
    if 16 * n <= CARD_STATE_BYTES:
        return cfg
    return cfg.with_(n_layers=min(cfg.n_layers,
                                  max(2, 2 * detect_unit(cfg.layer_kinds))))


def _model(cfg, device):
    from ..nn.model import build_model
    gen = torch.Generator(device=device).manual_seed(0)
    return build_model(cfg, device=device, generator=gen)


def _tokens(rng, cfg, shape) -> np.ndarray:
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int64)


# the traced steps' sizes: 2 serving rows, a prefill chunk of 8 tokens, a
# pool of 16 pages of 16 tokens; a training batch of 2 x 32 tokens
SLOTS, CHUNK, PAGE_SIZE, TOTAL_PAGES = 2, 8, 16, 16
TRAIN_BATCH, TRAIN_SEQ = 2, 32


def paged_steps(cfg, device, quant: bool):
    """(prefill, decode, int8 shapes) of ``cfg``'s paged step: closures
    running one prefill chunk of ``CHUNK`` tokens on ``SLOTS`` rows, then
    one decode step, on a fresh page pool (full width, or int8 weights and
    KV pages with ``quant``)."""
    slots, chunk = SLOTS, CHUNK
    from ..core.quant import quantize_model
    from ..nn.common import dtype_of
    cfg = _dropless(cfg)
    model = _model(cfg, device)
    if quant:
        quantize_model(model)
    model = model.to(dtype=dtype_of(cfg))
    cache = model.init_paged_cache(TOTAL_PAGES, PAGE_SIZE, dtype_of(cfg),
                                   device, quant_kv=quant, slots=slots)
    per_row = TOTAL_PAGES // slots
    table = np.full((slots, per_row), -1, np.int32)
    for i in range(slots):
        table[i] = np.arange(i * per_row, (i + 1) * per_row)
    rng = np.random.default_rng(0)
    n_new = np.array([chunk - i % chunk for i in range(slots)], np.int32)

    def run(tokens, pos, new):
        as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt,  # noqa: E731
                                                  device=device)
        args = (as_t(tokens), as_t(pos, torch.int32), as_t(new),
                cache, as_t(table))
        return lambda: model.paged_step(*args)

    prefill = run(_tokens(rng, cfg, (slots, chunk)).astype(np.int32),
                  np.zeros(slots, np.int32), n_new)
    decode = run(_tokens(rng, cfg, (slots, 1)).astype(np.int32), n_new,
                 np.ones(slots, np.int32))
    params = list(model.parameters()) + list(model.buffers()) + [
        t for c in cache for t in c.values()]
    return prefill, decode, int8_shapes(*params)


# the dense-cache loop's encoder frames
ENC_FRAMES = 24


def dense_loop_steps(cfg, device):
    """(prefill, decode) of ``cfg``'s dense-cache loop in its compute dtype:
    closures running one ``prefill`` of ``CHUNK`` prompt tokens on ``SLOTS``
    rows (a stub frontend's embeddings for them; an encoder-decoder's
    ``ENC_FRAMES`` frames) into a cache of ``2 * CHUNK`` positions, then
    one ``decode_step`` on the cache a first prefill (not traced) made."""
    from ..nn.common import dtype_of
    model = _model(cfg, device).to(dtype=dtype_of(cfg))
    rng = np.random.default_rng(0)
    frames = ENC_FRAMES if cfg.enc_dec is not None else CHUNK
    batch = {
        "tokens": torch.as_tensor(_tokens(rng, cfg, (SLOTS, CHUNK)),
                                  dtype=torch.int32, device=device),
        "embeds": torch.as_tensor(rng.normal(size=(
            SLOTS, frames, cfg.frontend_dim)), dtype=torch.float32,
            device=device)}
    cache = model.prefill(batch, 2 * CHUNK)[1]
    token = torch.as_tensor(_tokens(rng, cfg, (SLOTS, 1)), dtype=torch.int32,
                            device=device)
    return (lambda: model.prefill(batch, 2 * CHUNK),
            lambda: model.decode_step(token, cache))


def train_step(cfg, device):
    """A closure running one ``Trainer.train_step`` of ``cfg`` (forward,
    backward, AdamW) on a random batch; an encoder-decoder's or a stub
    frontend's batch also holds ``embeds``, an encoder-decoder's of
    ``ENC_FRAMES`` frames (not the tokens' count)."""
    from ..train.trainer import Trainer
    trainer = Trainer(_model(cfg, device), device=device)
    params, opt = trainer.init_state()
    rng = np.random.default_rng(0)
    toks = _tokens(rng, cfg, (TRAIN_BATCH, TRAIN_SEQ + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_dec is not None or cfg.input_mode != "tokens":
        frames = ENC_FRAMES if cfg.enc_dec is not None else TRAIN_SEQ
        batch["embeds"] = rng.normal(size=(
            TRAIN_BATCH, frames, cfg.frontend_dim)).astype(np.float32)
    data = trainer.to_device(batch)
    return lambda: trainer.train_step(params, opt, data)


def quant_inject_step(device):
    """Self-test subject: a junction that dequantizes its WHOLE int8 slab up
    front and feeds the float copy to ``csd_matmul``. Its full-slab upcast
    MUST trip SL206."""
    from ..core.block_pattern import make_block_pattern
    from ..core.quant import dequantize_slab, quantize_slab
    from ..kernels.ops import csd_matmul
    bp = make_block_pattern(512, 512, 0.5, block_in=128, block_out=128,
                            seed=0)
    g = torch.Generator(device=device).manual_seed(0)
    w, s = quantize_slab(torch.randn((bp.n_rb, bp.d_in_b, 128, 128),
                                     generator=g, device=device))
    x = torch.randn((4, bp.n_in), generator=g, device=device)
    idx = torch.as_tensor(bp.block_idx, dtype=torch.int32, device=device)

    def bad():
        with torch.no_grad():
            return csd_matmul(x, dequantize_slab(w, s), idx)

    return bad, int8_shapes(w)


def run(config_names: Optional[Sequence[str]] = None,
        device: str = "cpu", inject: bool = False
        ) -> Tuple[List[Finding], List[str], List[str]]:
    """Lint the paged steps (full width and int8) of every registered
    config, or the dense-cache loop's prefill and decode of one that
    serves only through it, and the training step of each: the smoke size
    on the CPU, full width on the card (at ``card_depth``). Returns
    (findings, covered subjects, errors); a step that fails to run is an
    error (gating): a hot path the linter cannot see is not a certified
    hot path."""
    from ..configs import ARCHS, canonical, get_config

    dev = torch.device(device)
    full = dev.type == "cuda"
    findings: List[Finding] = []
    covered: List[str] = []
    errors: List[str] = []

    def lint(subject, make):
        try:
            steps, shapes = make()
            for tag, step in steps:
                ops, sync = trace(step, dev)
                name = f"{subject}[{tag}]" if tag else subject
                findings.extend(lint_ops(ops, name, shapes))
                if sync is not None:
                    findings.append(Finding(
                        "SL201", name, f"the step synchronises with the "
                        f"host on the card: {sync}", {}))
                covered.append(name)
        except Exception as e:
            errors.append(f"{subject}: {type(e).__name__}: {e}")
        finally:
            if full:
                torch.cuda.empty_cache()

    for arch in (config_names or ARCHS):
        arch = canonical(arch)
        cfg = get_config(arch, smoke=not full)
        size = "full" if full else "smoke"
        if full and card_depth(cfg) is not cfg:
            cfg = card_depth(cfg)
            size = f"full@{cfg.n_layers}L"
        if cfg.enc_dec is not None or cfg.input_mode != "tokens":
            def make_dense(cfg=cfg):
                pre, dec = dense_loop_steps(cfg, dev)
                return [("prefill", pre), ("decode", dec)], set()
            lint(f"{arch}:{size}:dense_loop", make_dense)
        else:
            for quant in (False, True):
                def make(cfg=cfg, quant=quant):
                    pre, dec, shapes = paged_steps(cfg, dev, quant)
                    return [("prefill", pre), ("decode", dec)], shapes
                lint(f"{arch}:{size}:paged_step"
                     f"{'_int8' if quant else ''}", make)
        lint(f"{arch}:{size}:train_step",
             lambda cfg=cfg: ([("", train_step(cfg, dev))], set()))
    if inject:
        def make_inject():
            step, shapes = quant_inject_step(dev)
            return [("", step)], shapes
        lint("quant_inject[selftest]", make_inject)
    return findings, covered, errors
