"""zamba2-1.2b [hybrid] — 38 layers, d_model 2048: a Mamba2 backbone
(d_inner 4096 in 64 heads of 64, one B/C group of state size 64) and one
*shared* attention block (32 heads over 32 KV heads of dim 128, a GeGLU
FFN of 8192) applied after every 6 layers to [hidden, embedding] (width
4096); vocab 32000, tied embeddings. 38 = 6 groups of 6 mamba layers, each
followed by the shared block, then 2 epilogue mamba layers.

The same configuration as ``repro/configs/zamba2_1p2b.py``. Its junctions
at the published 256 x 1024 blocks, as ``fit_block_pattern`` fits them:

============================= =====================================
junction                      n_lb x n_rb, blocks, fan-in, density
============================= =====================================
mamba in_proj 2048 -> 8384    8 x 131, 256 x 64, 8, 1.0
mamba out_proj 4096 -> 2048   16 x 2, 256 x 1024, 16, 1.0
shared up / gate 2048 -> 8192 8 x 8, 256 x 1024, 4, 0.5
shared down 8192 -> 2048      32 x 2, 256 x 1024, 32, 1.0
============================= =====================================

8384 = 64 x 131 leaves 64-wide right blocks, and 131 is prime, so
in_proj's density rounds up to 1.0; the shared up/gate junctions are truly
sparse. Every pattern, dense ones included, runs the junction forward. The
shared attention's projections are dense (``rho_attn`` None).
"""
from ..nn.common import (HybridConfig, ModelConfig, SSMConfig,
                         SparsityConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        n_layers=38,
        block_kind="mamba",
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,   # shared block: qk over the 2 x d_model input
        d_ff=8192,      # shared block FFN
        vocab_size=32000,
        max_seq_len=524288,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        hybrid=HybridConfig(period=6, shared_d_ff=8192,
                            concat_embedding=True),
        act="gelu",
        ffn_gated=True,
        tie_embeddings=True,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75)),
    )


def smoke_config() -> ModelConfig:
    """The JAX smoke configuration without its ``attn_chunk`` (the JAX
    training attention's query chunk; the port has no such field)."""
    return config().with_(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=128, vocab_size=512, max_seq_len=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=16),
        hybrid=HybridConfig(period=2, shared_d_ff=128,
                            concat_embedding=True),
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16),
    )
