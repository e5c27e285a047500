"""OLMoE-1B-7B [arXiv:2409.02060]: 64-expert top-8 MoE (1B active / 7B total)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="64 experts top-8 [arXiv:2409.02060]",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    moe_mode="dense",
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1e4,
    fed_mode="parallel",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=128, vocab_size=512, num_experts=4,
        experts_per_token=2, dtype="float32")
