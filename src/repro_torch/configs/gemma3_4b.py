"""gemma3-4b — 34 layers, d_model 2560, 8 heads (GQA, 4 kv heads) of dim
256, d_ff 10240, vocab 262144; 5:1 local:global attention with a 1024-token
window on local layers; GeGLU FFN (tanh gelu), sandwich norms + qk-norm,
embeddings scaled by sqrt(d_model), tied head. Pre-defined sparse FFN
junctions at densities (0.5, 0.75), which the block patterns quantize to
0.5 (up/gate, 256 x 1024 blocks) and 0.8 (down, 256 x 512 blocks).

The same configuration as ``repro/configs/gemma3_4b.py``.
"""
from ..nn.common import ModelConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        max_seq_len=131072,
        local_global_ratio=5,
        attn_window=1024,
        rope_theta=1_000_000.0,
        post_norms=True,
        act="gelu_tanh",
        ffn_gated=True,
        tie_embeddings=True,
        scale_embed=True,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75)),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, max_seq_len=512, attn_window=16,
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16),
    )
