"""granite-3-8b — dense GQA transformer.

[hf:ibm-granite/granite-3.0-8b-base; hf-verified family]  40L d_model=4096
32H (GQA kv=8) d_ff=12800 vocab=49155, RoPE, SwiGLU, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49_155,
        tie_embeddings=True,
        rope_theta=10_000.0,
        act="silu",
        source="hf:ibm-granite/granite-3.0-8b-base",
    )


def parallel() -> ParallelConfig:
    # 32 heads / 16 = 2 per shard — clean head TP; d_ff 12800 = 16·800.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_8b_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        tie_embeddings=True,
    )
