"""phi4-mini-3.8b — dense GQA transformer.

[arXiv:2412.08905; hf-verified]  32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE, SwiGLU, tied embeddings.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4_mini_3_8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=200_064,
        tie_embeddings=True,
        rope_theta=10_000.0,
        act="silu",
        source="arXiv:2412.08905 (hf:microsoft/Phi-4-mini-instruct)",
    )


def parallel() -> ParallelConfig:
    # 24 heads / 8 kv heads do not divide 16 → TP on d_ff (8192 = 16·512)
    # and vocab; FSDP over data axes carries the rest.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4_mini_3_8b_smoke",
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
