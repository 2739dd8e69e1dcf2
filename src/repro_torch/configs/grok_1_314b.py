"""grok-1-314b — 8-expert top-2 MoE transformer.

[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, 8 experts top-2, attention + final logit softcap 30.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig, PlanSpace


def plan_space() -> PlanSpace:
    # 64 layers pipeline cleanly to 8 stages; 48 heads cap tensor at 8
    # (16 would split a head).  Experts stay replicated — 8 experts shard
    # each expert's d_ff via TP rather than true EP (see parallel()).
    return PlanSpace(
        stages=(1, 2, 4, 8),
        rings=(1, 2, 4),
        tensors=(1, 2, 4, 8),
        grad_buckets=(1, 2, 4, 8),
        remats=("full",),
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="grok_1_314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131_072,
        num_experts=8,
        moe_top_k=2,
        moe_d_ff=32768,
        attn_logit_softcap=30.0,
        final_logit_softcap=30.0,
        act="gelu",
        source="hf:xai-org/grok-1 (unverified)",
    )


def parallel() -> ParallelConfig:
    # 8 experts < 16 model shards → EP does not divide; TP shards each
    # expert's d_ff (32768 = 16·2048) instead, with FSDP over the 8-expert dim.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", shard_experts=False, remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok_1_314b_smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        moe_top_k=2,
        moe_d_ff=128,
        attn_logit_softcap=30.0,
        final_logit_softcap=30.0,
        act="gelu",
    )
