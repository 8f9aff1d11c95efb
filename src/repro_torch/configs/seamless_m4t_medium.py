"""seamless-m4t-medium [audio] — an encoder-decoder of 12 + 12 layers,
d_model 1024, 16 heads over 16 KV heads of dim 64, an ungated gelu FFN of
4096, vocab 256206, tied embeddings. [arXiv:2308.11596; hf]

The same configuration as ``repro/configs/seamless_m4t_medium.py``: the
backbone only. The speech frontend (w2v-BERT's conformer feature
extractor) is a stub that delivers frame embeddings (B, S, 1024) to the
encoder's adapter; rope takes the place of the original learned positions.
Its FFN junctions at full width, as ``fit_block_pattern`` fits them at the
published 256 x 1024 blocks: up 1024 -> 4096 4 x 4 blocks at density 0.5
(fan-in 2); down 4096 -> 1024 16 x 1 blocks, coprime, so density 1.0 at
fan-in 16 into one 1024-wide right block.

The smoke configuration leaves out the JAX one's ``attn_chunk`` (the q-chunk
of the reference's XLA attention scan), which has no field in the port.
"""
from ..nn.common import EncDecConfig, ModelConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        n_layers=24,                      # 12 enc + 12 dec
        enc_dec=EncDecConfig(n_encoder_layers=12, n_decoder_layers=12),
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        max_seq_len=32768,
        input_mode="embeddings",
        frontend_dim=1024,
        act="gelu",
        ffn_gated=False,
        tie_embeddings=True,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75)),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=4, enc_dec=EncDecConfig(2, 2),
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, frontend_dim=64, max_seq_len=512,
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16),
    )
