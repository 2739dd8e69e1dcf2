"""seamless-m4t-large-v2 — encoder-decoder speech/text transformer backbone.

[arXiv:2308.11596; hf-verified]  24L (encoder) + 24L (decoder) d_model=1024
16H (kv=16) d_ff=8192 vocab=256206.  The modality frontend (w2v-BERT speech
encoder feature extractor) is a STUB: ``input_specs()`` provides precomputed
frame embeddings of dimension d_model.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless_m4t_large_v2",
        family="encdec",
        num_layers=24,            # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256_206,
        tie_embeddings=True,     # the enc-dec trunk shares embed/output proj
        rope_theta=10_000.0,
        act="relu",
        source="arXiv:2308.11596 (hf:facebook/seamless-m4t-v2-large)",
    )


def parallel() -> ParallelConfig:
    # 16 heads = model axis size: one head per model shard.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless_m4t_large_v2_smoke",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        tie_embeddings=True,
        act="relu",
    )
