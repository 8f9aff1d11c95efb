"""mamba2-130m [ssm] — 24 layers, d_model 768, attention-free: every layer
a Mamba2 mixer (SSD, state-space duality) with d_inner 2 x 768 = 1536 in
24 heads of 64, one B/C group of state size 128, a width-4 causal conv;
vocab 50280, tied embeddings. Pre-defined sparsity attaches to the mixer's
in/out projection junctions (densities (0.5, 0.75)); the SSD recurrence
has no weight junction.

The same configuration as ``repro/configs/mamba2_130m.py``. Its junctions
at the published 256 x 1024 blocks, as ``fit_block_pattern`` fits them:

======================== =====================================
junction                 n_lb x n_rb, blocks, fan-in, density
======================== =====================================
in_proj 768 -> 3352      dense (3352 = 8 x 419: no block >= 32)
out_proj 1536 -> 768     6 x 1, 256 x 768, 6, 1.0
======================== =====================================

The dense in_proj is a ``torch.matmul``, as the JAX package's is an XLA
dot; out_proj's one 768-wide right block runs the junction forward. The
smoke configuration's in_proj (64 -> 296) is dense too, its out_proj a
16 x 16 pattern (the small-block forms on the card).
"""
from ..nn.common import ModelConfig, SSMConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        n_layers=24,
        block_kind="mamba",
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        head_dim=1,
        d_ff=0,
        vocab_size=50280,
        max_seq_len=1048576,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        tie_embeddings=True,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75)),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=4, d_model=64, vocab_size=512, max_seq_len=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=16),
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16),
    )
