"""Model configuration shared by the nn stack (port of the configuration
half of ``repro.nn.common``).

The fields and defaults are those of the JAX package's ``ModelConfig``,
``SparsityConfig``, ``MoEConfig``, ``SSMConfig``, ``HybridConfig`` and
``EncDecConfig`` that the ported slices read, with the int8 serving knob
``SparsityConfig.quant``; the TPU backend switch and the XLA attention
scan's chunk sizes have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Where and how pre-defined sparsity is applied inside a model: the
    FFN up/gate junctions get density ``rho_ffn[0]``, the down junction
    ``rho_ffn[1]`` (the paper's trend 3: later junctions denser)."""

    enabled: bool = False
    rho_ffn: Tuple[float, float] = (0.5, 0.75)
    rho_attn: Optional[float] = None  # None = attention projections dense
    # MoE expert junctions (up/gate/down of every routed expert) become
    # block-sparse too, one pattern per junction shared by all experts,
    # executed through the expert-batched csd_matmul; densities follow
    # rho_ffn
    moe_sparsity: bool = False
    method: str = "clashfree"
    cf_type: int = 1
    dither: bool = False
    block_in: int = 256
    block_out: int = 1024
    seed: int = 0
    # int8 inference (core.quant.QuantConfig); None = full width. Training
    # always runs full width: the serving engine applies it once at load,
    # when its EngineConfig.quant is None
    quant: Optional[QuantConfig] = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0           # per-expert hidden size
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    first_layer_dense: bool = False   # deepseek-moe: layer 0 is dense FFN
    dense_d_ff: int = 0               # hidden size of that dense layer


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """A Mamba2 mixer: ``expand * d_model`` inner width in heads of
    ``head_dim``, ``n_groups`` B/C groups of state size ``d_state``, a
    causal depthwise conv of width ``d_conv``, SSD chunks of ``chunk``."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    a_init_range: Tuple[float, float] = (1.0, 16.0)
    dt_limit: Tuple[float, float] = (1e-3, 1e2)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: a mamba backbone and one *shared* attention block (one
    parameter set) applied after every ``period`` layers."""
    period: int = 6
    shared_d_ff: int = 8192
    concat_embedding: bool = True  # shared block sees [h, embedding] (2*d)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """An encoder-decoder's stacks (seamless-m4t): the encoder reads the
    stub frontend's frames, the decoder cross-attends to its output."""
    n_encoder_layers: int = 12
    n_decoder_layers: int = 12


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 8192

    block_kind: str = "attn"     # attn | mamba
    layer_pattern: Tuple[str, ...] = ()  # per-layer kinds, cycled; () = all attn
    attn_window: Optional[int] = None    # sliding window for 'local' layers
    local_global_ratio: int = 0          # k local : 1 global (0 = all global)
    logit_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    post_norms: bool = False     # gemma2/3 sandwich norms (+ qk-norm)
    act: str = "silu"            # silu | gelu | gelu_tanh | relu
    ffn_gated: bool = True
    tie_embeddings: bool = True
    scale_embed: bool = False    # gemma multiplies embeddings by sqrt(d)

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    input_mode: str = "tokens"   # tokens | embeddings (audio/vlm frontends)
    frontend_dim: int = 0        # embedding width of the stub frontend

    sparsity: SparsityConfig = dataclasses.field(default_factory=SparsityConfig)

    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True           # recompute each layer and loss chunk
    loss_chunk: int = 512        # sequence chunk of the cross-entropy

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Resolved per-layer kind: 'global', 'local' or 'mamba'."""
        if self.layer_pattern:
            pat = self.layer_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.block_kind == "mamba":
            return ("mamba",) * self.n_layers
        if self.local_global_ratio > 0:
            k = self.local_global_ratio
            return tuple("local" if (i % (k + 1)) != k else "global"
                         for i in range(self.n_layers))
        return ("global",) * self.n_layers

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Asking for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "versions on the CPU")
    return dev


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)
