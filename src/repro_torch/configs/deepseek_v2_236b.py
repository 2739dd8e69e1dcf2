"""deepseek-v2-236b — MLA + fine-grained MoE (2 shared + 160 routed, top-6).

[arXiv:2405.04434; hf-verified]  60L d_model=5120 128H, MLA with
kv_lora=512 / q_lora=1536 / rope_head_dim=64 / nope=128 / v=128;
first layer dense (d_ff=12288), remaining 59 MoE with expert d_ff=1536.
vocab=102400.
"""

from repro_torch.configs.base import ModelConfig, ParallelConfig, PlanSpace


def plan_space() -> PlanSpace:
    # 60 layers minus the leading dense layer pipeline awkwardly past 4
    # stages; 160 routed experts divide by every power of two up to 8, and
    # expert parallelism rides the tensor (model) axis.
    return PlanSpace(
        stages=(1, 2, 4),
        rings=(1, 2, 4),
        experts=(1, 2, 4, 8),
        tensors=(1, 2, 4, 8),
        microbatches=(1, 2, 4, 8),
        remats=("full",),          # 236B never trains without full remat
    )


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_v2_236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=12288,               # the single dense layer
        vocab_size=102_400,
        num_experts=160,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1536,
        first_dense_layers=1,
        mla=True,
        q_lora=1536,
        kv_lora=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        act="silu",
        source="arXiv:2405.04434 (hf:deepseek-ai/DeepSeek-V2)",
    )


def parallel() -> ParallelConfig:
    # 160 experts = 16·10 → true expert parallelism over 'model';
    # 128 MLA heads = 16·8 → head TP for attention.
    return ParallelConfig(fsdp=True, attn_plan="tp_heads", shard_experts=True, remat="full")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_v2_236b_smoke",
        family="moe",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        num_experts=8,
        num_shared_experts=2,
        moe_top_k=2,
        moe_d_ff=32,
        first_dense_layers=1,
        mla=True,
        q_lora=32,
        kv_lora=32,
        rope_head_dim=8,
        nope_head_dim=16,
        v_head_dim=16,
        act="silu",
    )
