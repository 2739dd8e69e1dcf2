"""paligemma-3b — SigLIP + gemma prefix-LM VLM backbone.

[arXiv:2407.07726; hf-verified]  18L d_model=2048 8H (GQA kv=1) head_dim=256
d_ff=16384 vocab=257216.  The SigLIP vision tower is a STUB:
``input_specs()`` provides 256 precomputed patch embeddings (dim 1152,
SigLIP-So400m feature width) which the trunk projects with ``mm_proj``.
Image tokens attend bidirectionally (prefix-LM); text is causal.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma_3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257_216,
        num_image_tokens=256,     # 224/14 squared
        prefix_lm=True,
        tie_embeddings=True,
        embed_scale=True,
        act="gelu",
        source="arXiv:2407.07726 (hf:google/paligemma-3b-pt-224)",
    )


def parallel() -> ParallelConfig:
    # MQA (kv=1): kv replicates over 'model'; q heads (8) also do not divide
    # 16 → TP lives on d_ff (16384 = 16·1024) and the 257k vocab.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma_3b_smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_image_tokens=4,
        prefix_lm=True,
        tie_embeddings=True,
        embed_scale=True,
        act="gelu",
    )
