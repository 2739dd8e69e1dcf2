"""zamba2-7b — Mamba-2 backbone with a shared attention block.

[arXiv:2411.15242; unverified]  81 Mamba-2 layers d_model=3584, ssm_state=64,
one shared attention+MLP block (32H kv=32, d_ff=14336) applied every 6 SSM
layers with shared weights (13 applications + 3 tail SSM layers).
vocab=32000.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2_7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32_000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        attn_every=6,
        tie_embeddings=True,
        act="gelu",
        source="arXiv:2411.15242 (hf:Zyphra/Zamba2-7B, unverified)",
    )


def parallel() -> ParallelConfig:
    # SSM inner dim 7168 = 16·448 shards cleanly; attention heads 32 = 16·2.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2_7b_smoke",
        family="hybrid",
        num_layers=7,             # 2 groups of 3 + 1 tail layer
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        attn_every=3,
        tie_embeddings=True,
        act="gelu",
    )
