"""granite-moe-1b-a400m [moe] — 24 layers, d_model 1024, 16 heads (GQA, 8
kv heads) of dim 64, vocab 49155; 32 routed experts (d_expert 512) top-8,
no shared experts; SwiGLU experts (silu), all-global attention, tied head.
Pre-defined sparse expert junctions (``moe_sparsity``) at densities
(0.5, 0.75).

The same configuration as ``repro/configs/granite_moe_1b_a400m.py``. At
full width the default 256 x 1024 blocks make both expert junctions dense
(up/gate 4 x 1 blocks, down 2 x 1); the port trains and serves it with
``block_in=128, block_out=256`` (up/gate 8 x 2 blocks at fan-in 4, density
0.5; down 4 x 4 at fan-in 3, density 0.75), training at the published
capacity factor and serving at the dropless ``capacity_factor=4.0``
(``n_routed / top_k``) that paged serving needs, set with ``with_`` where
it is used.
"""
import dataclasses

from ..nn.common import ModelConfig, MoEConfig, SparsityConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,    # per-expert hidden size
        vocab_size=49155,
        max_seq_len=8192,
        moe=MoEConfig(n_routed=32, top_k=8, n_shared=0, d_expert=512,
                      capacity_factor=1.25),
        rope_theta=10000.0,
        act="silu",
        ffn_gated=True,
        tie_embeddings=True,
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                moe_sparsity=True),
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512, max_seq_len=512,
        moe=MoEConfig(n_routed=8, top_k=2, n_shared=0, d_expert=32,
                      capacity_factor=1.5),
        loss_chunk=16, dtype="float32",
        sparsity=SparsityConfig(enabled=True, rho_ffn=(0.5, 0.75),
                                block_in=16, block_out=16,
                                moe_sparsity=True),
    )


def card_config() -> ModelConfig:
    """The published configuration with the 128 x 256 expert blocks it is
    trained and served with on the card (the published capacity factor;
    paged serving sets the dropless 4.0 on top)."""
    cfg = config()
    return cfg.with_(sparsity=dataclasses.replace(cfg.sparsity, block_in=128,
                                                  block_out=256))
