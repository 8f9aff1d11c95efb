"""llava-next-34b [vlm] — 60 layers, d_model 7168, 56 heads over 8 KV
heads (G 7) of dim 128, a SwiGLU FFN of 20480, vocab 64000, untied head;
anyres tiling frontend.
[hf:llava-hf/llava-v1.6-mistral-7b-hf scaled per assignment; unverified]

The same configuration as ``repro/configs/llava_next_34b.py``, its numbers
as the reference has them: the backbone only. The anyres vision tower is a
stub that delivers patch embeddings (B, S, 1024), which the 2-layer MLP
projector (``LM.proj_in``, gelu, ``LM.proj_mid``) maps into the LM; decode
embeds the generated text tokens through the embedding table. Its FFN
junctions at full width, at the published 256 x 1024 blocks: up and gate
7168 -> 20480 28 x 20 blocks at density 0.5 (fan-in 14); down 20480 ->
7168 80 x 7 blocks, density 1.0 at fan-in 80.

The smoke configuration leaves out the JAX one's ``attn_chunk``, which has
no field in the port.
"""
from ..nn.common import ModelConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        max_seq_len=32768,
        input_mode="embeddings",
        frontend_dim=1024,
        rope_theta=5_000_000.0,
        act="silu",
        ffn_gated=True,
        tie_embeddings=False,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75)),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, frontend_dim=48, max_seq_len=512,
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16),
    )
