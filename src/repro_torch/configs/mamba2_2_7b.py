"""mamba2-2.7b — attention-free SSD (state-space duality) LM.

[arXiv:2405.21060; unverified]  64L d_model=2560, ssm_state=128,
head_dim=64 (80 heads at expand=2), vocab=50280.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_2_7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,              # attention-free
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        tie_embeddings=True,
        source="arXiv:2405.21060 (hf:state-spaces/mamba2-2.7b, unverified)",
    )


def parallel() -> ParallelConfig:
    # d_inner 5120 = 16·320 (80 heads = 16·5) → clean TP over SSM heads.
    return ParallelConfig(fsdp=True, remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_2_7b_smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        tie_embeddings=True,
    )
