"""Move a JAX parameter tree into the port: ``from_jax_params``.

The JAX ``LM`` keeps its layers as ``params["stack"]["prologue"][i]``
(deepseek-moe's dense layer 0), ``params["stack"]["scan"][u]`` (trees
whose leaves carry a leading group axis g, one entry per slot u of the
repeating unit) and ``params["stack"]["epilogue"][i]``. The port's flat
``layers`` list holds prologue block i at index i, scan slot u of group g
at ``pro_n + g * unit + u`` (``pro_n`` prologue blocks) and epilogue block
i after all scanned layers; an untied head
``params["head"]["w"]`` (d_model, vocab) maps onto ``head.weight``. The
repeating unit is the model's (``nn.model.repeat_unit``: zamba2's
``hybrid.period``). A mamba layer's leaves (``mixer.{in_proj, out_proj}``,
``mixer.{conv_w, conv_b, a_log, dt_bias, d_skip}``, ``mixer.norm``,
``ln``) keep their names, and a hybrid stack's ``params["stack"]
["shared"]`` maps onto the port's ``shared`` block. The tree is passed in
as numpy arrays, so this module needs no JAX.

A gradient tree from ``jax.grad`` of the LM's loss has the parameter
tree's structure, so the same function maps it onto the port's parameter
names; the training tests compare gradients that way.

A tree that the JAX package's ``quantize_tree`` has rewritten (int8 slab
``w`` with an f32 sibling ``w_scale``) loads into a port model that
``core.quant.quantize_model`` has quantized: the slabs and scales arrive
bit for bit.

A stub-frontend LM's projector ``proj_in`` and ``proj_mid`` ({"w", "b"})
map onto the port's ``Linear``s of those names. The JAX ``EncDec`` tree
(``embed``, ``adapter``, ``encoder`` and ``decoder`` stacks, ``ln_enc``,
``ln_f``) maps onto ``EncDec``: each stack as the LM's, flat under
``encoder.{i}`` and ``decoder.{i}``, a decoder block's ``cross`` onto its
``cross_attn`` (``q``, ``k``, ``v``, ``o`` as a self-attention's) and
``ln_cross`` as it is.

An MoE block's tree ``ffn: {router, up, gate, down[, shared]}`` maps onto
``MoE`` under the same names (``ffn.router``, ``ffn.up``, ...; a shared
expert's ``FFN`` under ``ffn.shared``), and the ``up_scale``,
``gate_scale`` and ``down_scale`` siblings that ``quantize_tree`` writes for
int8 expert slabs onto the buffers of those names.

``mlp_from_jax_params`` does the same for the paper's MLP: the JAX
``SparseMLP`` tree ``{"j{i}": {"w", "b"}}`` maps onto ``layers.{i}.weight``
and ``layers.{i}.bias`` in every mode (a dense or masked (n_in, n_out)
weight, a gather (n_out, d_in) weight, a block slab), and a block
junction's int8 slab with its ``w_scale`` sibling onto the int8 weight and
the ``layers.{i}.w_scale`` buffer of a model ``quantize_model`` has
quantized.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterator, Tuple

import numpy as np
import torch

from .nn.model import LM, EncDec, prologue_len, repeat_unit

if TYPE_CHECKING:
    from .nn.mlp import SparseMLP

_LEAF = {"w": "weight", "b": "bias"}
_ATTN = {"q": "wq", "k": "wk", "v": "wv", "o": "wo"}


def _items(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _block_name(path: tuple) -> str:
    names = list(path)
    if names[0] == "cross":
        names[0] = "cross_attn"
    if names[0] in ("attn", "cross_attn") and names[1] in _ATTN:
        names[1] = _ATTN[names[1]]
    names[-1] = _LEAF.get(names[-1], names[-1])
    return ".".join(names)


def _stack_arrays(stack: dict, prefix: str, n_layers: int, pro_n: int,
                  unit: int) -> Dict[str, np.ndarray]:
    """A JAX ``Stack`` tree's leaves under the port's flat names
    ``<prefix>.{i}.<block name>`` (the shared block's under
    ``shared.``)."""
    prologue = stack.get("prologue") or []
    if len(prologue) != pro_n:
        raise ValueError(f"prologue mismatch: the tree has {len(prologue)} "
                         f"prologue blocks, the model {pro_n}")
    n_groups = (n_layers - pro_n) // unit
    out: Dict[str, np.ndarray] = {}
    for i, blk in enumerate(prologue):
        for path, arr in _items(blk):
            out[f"{prefix}.{i}.{_block_name(path)}"] = arr
    for u, slot_tree in enumerate(stack["scan"]):
        for path, arr in _items(slot_tree):
            for g in range(n_groups):
                out[f"{prefix}.{pro_n + g * unit + u}."
                    f"{_block_name(path)}"] = arr[g]
    for i, blk in enumerate(stack["epilogue"]):
        for path, arr in _items(blk):
            out[f"{prefix}.{pro_n + n_groups * unit + i}."
                f"{_block_name(path)}"] = arr
    for path, arr in _items(stack.get("shared") or {}):
        out[f"shared.{_block_name(path)}"] = arr
    return out


def _dense_arrays(np_tree: dict, names) -> Dict[str, np.ndarray]:
    """The dense ``Linear``s ``names`` ({"w", "b"}) of a JAX tree."""
    return {f"{n}.{_LEAF[leaf]}": np.asarray(arr) for n in names
            for leaf, arr in np_tree[n].items()}


def _encdec_arrays(np_tree: dict, model: EncDec) -> Dict[str, np.ndarray]:
    # both stacks are global layers: one scan slot each (a unit of 1)
    ed = model.cfg.enc_dec
    out = _stack_arrays(np_tree["encoder"], "encoder", ed.n_encoder_layers,
                        prologue_len(model.cfg), 1)
    out.update(_stack_arrays(np_tree["decoder"], "decoder",
                             ed.n_decoder_layers, 0, 1))
    out.update(_dense_arrays(np_tree, ("adapter",)))
    out.update({f"{n}.scale": np.asarray(np_tree[n]["scale"])
                for n in ("ln_enc", "ln_f")})
    out["embed.table"] = np.asarray(np_tree["embed"]["table"])
    return out


def from_jax_params(np_tree: dict, model) -> Dict[str, torch.Tensor]:
    """The port's state dict (parameters, and the scale buffers of a
    quantized model: ``w_scale`` and the MoE ``*_scale``) for ``model``
    (an ``LM`` or ``EncDec``) from the JAX ``LM`` or ``EncDec`` parameter
    tree as numpy arrays. Raises if a parameter is missing, left over, or
    of another shape."""
    if isinstance(model, EncDec):
        out = _encdec_arrays(np_tree, model)
    else:
        out = _lm_arrays(np_tree, model)
    params = dict(model.named_parameters())
    params.update((n, b) for n, b in model.named_buffers()
                  if n.endswith("_scale"))
    if set(out) != set(params):
        raise ValueError(
            f"parameter mismatch: missing {sorted(set(params) - set(out))}, "
            f"unexpected {sorted(set(out) - set(params))}")
    sd = {}
    for name, arr in out.items():
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        if (p.dtype == torch.int8) != (arr.dtype == np.int8):
            raise ValueError(f"{name}: a {arr.dtype} array for a {p.dtype} "
                             f"tensor (int8 slabs load from a quantized "
                             f"tree into a quantized model)")
        sd[name] = torch.as_tensor(np.array(arr), dtype=p.dtype)
    return sd


def _lm_arrays(np_tree: dict, model: LM) -> Dict[str, np.ndarray]:
    cfg = model.cfg
    out = _stack_arrays(np_tree["stack"], "layers", cfg.n_layers,
                        prologue_len(cfg), repeat_unit(cfg))
    out["embed.table"] = np.asarray(np_tree["embed"]["table"])
    out["ln_f.scale"] = np.asarray(np_tree["ln_f"]["scale"])
    if ("head" in np_tree) != (model.head is not None):
        has = "has" if "head" in np_tree else "lacks"
        raise ValueError(
            f"head mismatch: the tree {has} an untied head ('head'), the "
            f"model's tie_embeddings is {cfg.tie_embeddings}")
    if "head" in np_tree:
        out["head.weight"] = np.asarray(np_tree["head"]["w"])
    if cfg.input_mode == "embeddings":
        out.update(_dense_arrays(np_tree, ("proj_in", "proj_mid")))
    return out


def mlp_from_jax_params(np_tree: dict, model: "SparseMLP"
                        ) -> Dict[str, torch.Tensor]:
    """The port's parameters for ``model`` (a ``nn.mlp.SparseMLP``) from the
    JAX ``SparseMLP`` parameter tree (or a gradient tree of the same
    structure) as numpy arrays, on the model's device; for a quantized
    tree and model also the ``w_scale`` buffers (load with
    ``load_state_dict(..., strict=False)``). Raises if a parameter is
    missing, left over, or of another shape or kind."""
    out = {f"layers.{k[1:]}.{_LEAF.get(leaf, leaf)}": arr
           for k, sub in np_tree.items() for leaf, arr in sub.items()}
    params = dict(model.named_parameters())
    params.update((n, b) for n, b in model.named_buffers()
                  if n.endswith(".w_scale"))
    if set(out) != set(params):
        raise ValueError(
            f"parameter mismatch: missing {sorted(set(params) - set(out))}, "
            f"unexpected {sorted(set(out) - set(params))}")
    sd = {}
    for name, arr in out.items():
        p = params[name]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        if (p.dtype == torch.int8) != (arr.dtype == np.int8):
            raise ValueError(f"{name}: a {arr.dtype} array for a {p.dtype} "
                             f"tensor (int8 slabs load from a quantized "
                             f"tree into a quantized model)")
        sd[name] = torch.as_tensor(np.array(arr), dtype=p.dtype,
                                   device=p.device)
    return sd
