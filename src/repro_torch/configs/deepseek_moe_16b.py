"""deepseek-moe-16b [moe] — 28 layers, d_model 2048, 16 heads (16 KV heads,
one query head a KV head) of dim 128, vocab 102400; fine-grained MoE: 64
routed experts (d_expert 1408) top-6 and 2 shared experts; layer 0 is a
dense FFN (``dense_d_ff`` 10944, the JAX stack's unscanned prologue);
SwiGLU (silu), all-global attention, untied head. Pre-defined sparse
expert junctions (``moe_sparsity``) at densities (0.5, 0.75).

The same configuration as ``repro/configs/deepseek_moe_16b.py``. Its
junctions at full width, as ``fit_block_pattern`` fits them (n_lb x n_rb,
fan-in d_in_b, density):

=============================== ================== ==================
junction                        256 x 1024 (pub.)  64 x 64 (card)
=============================== ================== ==================
routed up / gate 2048 -> 1408   8 x 11, 8, 1.0     32 x 22, 16, 0.5
routed down 1408 -> 2048        11 x 2, 11, 1.0    22 x 32, 22, 1.0
shared up / gate 2048 -> 2816   8 x 11, 8, 1.0     32 x 44, 16, 0.5
shared down 2816 -> 2048        11 x 2, 11, 1.0    44 x 32, 33, 0.75
layer 0 up / gate 2048 -> 10944 8 x 171, 8, 1.0    32 x 171, 32, 1.0
layer 0 down 10944 -> 2048      171 x 2, 171, 1.0  171 x 32, 171, 1.0
=============================== ================== ==================

At the published blocks every junction is dense. The port serves it with
``block_in=64, block_out=64`` (``card_config``), which makes four of the six
junction families truly sparse and keeps every block a multiple of 64 (the
full-width kernel bodies, not the small-block forms). Two stay dense:

* the routed down junction: d_expert 1408 = 11 x 128 gives 11 or 22 left
  blocks at any block_in of 64 or more, the right-block counts are powers
  of two, and a pattern's density is a multiple of 1 / gcd(n_lb, n_rb),
  here 1/2: 0.75 rounds up to 1.0;
* layer 0: 10944 = 64 x 171 gives 171 blocks, coprime with every
  power-of-two count on the other side, so only density 1.0 fits.

Serving runs the MoE over all slot rows at the dropless capacity factor
``n_routed / top_k`` (64 / 6), set with ``with_`` where it is used; the
published 1.25 drops tokens, and the engine refuses it.
"""
import dataclasses

from ..nn.common import ModelConfig, MoEConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,   # per-expert hidden size
        vocab_size=102400,
        max_seq_len=16384,
        moe=MoEConfig(n_routed=64, top_k=6, n_shared=2, d_expert=1408,
                      capacity_factor=1.25, first_layer_dense=True,
                      dense_d_ff=10944),
        rope_theta=10000.0,
        act="silu",
        ffn_gated=True,
        tie_embeddings=False,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                moe_sparsity=True),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab_size=512, max_seq_len=512,
        moe=MoEConfig(n_routed=8, top_k=2, n_shared=1, d_expert=64,
                      capacity_factor=1.5, first_layer_dense=True,
                      dense_d_ff=128),
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16,
                                moe_sparsity=True),
    )


def card_config() -> ModelConfig:
    """The published configuration with the 64 x 64 blocks it is served
    with on the card (the published capacity factor; paged serving sets the
    dropless 64 / 6 on top)."""
    cfg = config()
    return cfg.with_(sparsity=dataclasses.replace(cfg.sparsity, block_in=64,
                                                  block_out=64))
