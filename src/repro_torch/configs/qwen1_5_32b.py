"""qwen1.5-32b — dense GQA transformer with QKV bias.

[hf:Qwen/Qwen1.5-32B; hf-verified family]  64L d_model=5120 40H (kv=40)
d_ff=27392 vocab=152064, RoPE, SwiGLU, QKV bias.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1_5_32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        act="silu",
        source="hf:Qwen/Qwen1.5-32B",
    )


def parallel() -> ParallelConfig:
    # 40 heads do not divide 16 → heads replicate on 'model'; TP lands on
    # d_ff (27392 = 16·1712) and the vocab.  FSDP shards everything else.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1_5_32b_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=160,
        vocab_size=512,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
