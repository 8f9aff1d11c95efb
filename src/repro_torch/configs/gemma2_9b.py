"""gemma2-9b [dense] — 42 layers, d_model 3584, 16 heads (GQA, 8 kv heads)
of dim 256, d_ff 14336, vocab 256000; alternating local (4096-token window)
and global attention, attention-logit softcap 50 and final-logit softcap 30,
GeGLU FFN (tanh gelu), sandwich norms + qk-norm, embeddings scaled by
sqrt(d_model), tied head. Pre-defined sparse FFN junctions at densities
(0.5, 0.75), which the block patterns quantize to 0.5 (up/gate, 14 x 14
blocks of 256 x 1024, fan-in 7) and 0.714 (down, 56 x 7 blocks of
256 x 512, fan-in 40).

The same configuration as ``repro/configs/gemma2_9b.py`` (arXiv:2408.00118);
the smoke variant drops the JAX package's ``attn_chunk``, the q-chunk of its
XLA attention scan, which the port's ``ModelConfig`` does not carry.
"""
from ..nn.common import ModelConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        max_seq_len=8192,
        local_global_ratio=1,       # alternating local:global
        attn_window=4096,
        logit_softcap=50.0,
        final_softcap=30.0,
        rope_theta=10000.0,
        post_norms=True,
        act="gelu_tanh",
        ffn_gated=True,
        tie_embeddings=True,
        scale_embed=True,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75)),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, max_seq_len=512, attn_window=16,
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16),
    )
