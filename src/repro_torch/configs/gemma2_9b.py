"""gemma2-9b — dense GQA with local+global alternating attention and logit
softcaps.

[arXiv:2408.00118; hf-verified]  42L d_model=3584 16H (GQA kv=8) head_dim=256
d_ff=14336 vocab=256000; sliding window 4096 on local layers, attn softcap
50, final softcap 30, pre+post sandwich norms, tied + scaled embeddings.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig, PlanSpace


def plan_space() -> PlanSpace:
    # 42 layers factor as 2·3·7: stages beyond (1, 2, 6) leave ragged
    # stacks, and 16 GQA heads cap tensor at 8 without splitting a KV head.
    return PlanSpace(
        stages=(1, 2, 6),
        rings=(1, 2, 4, 8),
        tensors=(1, 2, 4, 8),
        remats=("none", "dots", "full"),
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2_9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        layer_pattern="local_global",
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_norms=True,
        tie_embeddings=True,
        embed_scale=True,
        query_scale=256.0 ** -0.5,
        act="gelu",
        source="arXiv:2408.00118 (hf:google/gemma-2-9b)",
    )


def parallel() -> ParallelConfig:
    # 16 heads divide the model axis exactly; TP over heads + d_ff + vocab.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2_9b_smoke",
        family="dense",
        num_layers=4,               # 2 local/global units
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,                # head_dim != d_model/heads, as in gemma-2
        d_ff=128,
        vocab_size=512,
        layer_pattern="local_global",
        sliding_window=8,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        post_norms=True,
        tie_embeddings=True,
        embed_scale=True,
        query_scale=32.0 ** -0.5,
        act="gelu",
    )
