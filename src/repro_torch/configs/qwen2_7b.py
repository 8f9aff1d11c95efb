"""qwen2-7b [dense] — 28 layers, d_model 3584, 28 heads (GQA, 4 kv heads,
so 7 query heads a KV head) of dim 128, d_ff 18944, vocab 152064; QKV bias,
SwiGLU FFN (silu), all-global attention, untied head. Pre-defined sparse FFN
junctions at densities (0.5, 0.75); at full width the block counts are
coprime (up/gate 14 x 37 blocks of 256 x 512, down 74 x 7 of 256 x 512),
so the block patterns come out dense (density 1.0, fan-in 14 and 74).

The same configuration as ``repro/configs/qwen2_7b.py`` (arXiv:2407.10671);
the smoke variant drops the JAX package's ``attn_chunk``, which the port's
``ModelConfig`` does not carry.
"""
from ..nn.common import ModelConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        max_seq_len=32768,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        act="silu",
        ffn_gated=True,
        tie_embeddings=False,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75)),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, max_seq_len=512,
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16),
    )
