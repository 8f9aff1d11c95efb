"""granite-34b [dense] — 88 layers, d_model 6144, 48 heads over one KV head
(multi-query attention: a group of 48) of dim 128, d_ff 24576, vocab 49152;
a llama-architecture code model: SwiGLU FFN (silu), all-global attention,
untied head. Pre-defined sparse FFN junctions at densities (0.5, 0.75),
which the block patterns quantize to 0.5 (up/gate, 24 x 24 blocks of
256 x 1024, fan-in 12) and 0.667 (down, 96 x 6 blocks of 256 x 1024, fan-in
64).

About 29.5 B parameters: in f32 (~118 GB) they do not fit one 80 GB card,
in bf16 (~59 GB) they do; ``launch.serve`` builds the served model in its
compute dtype.

The same configuration as ``repro/configs/granite_34b.py``
(arXiv:2405.04324); the smoke variant drops the JAX package's
``attn_chunk``, which the port's ``ModelConfig`` does not carry.
"""
from ..nn.common import ModelConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        max_seq_len=8192,
        rope_theta=10000.0,
        act="silu",
        ffn_gated=True,
        tie_embeddings=False,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75)),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=256, vocab_size=512, max_seq_len=512,
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16),
    )
