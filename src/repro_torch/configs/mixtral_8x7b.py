"""Mixtral-8x7B [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window
attention (W=4096).  Experts (8) are not divisible by the model axis (16) —
expert weights shard on d_ff instead (dist/sharding.py fallback)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    source="8 experts top-2, SWA [arXiv:2401.04088]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    experts_per_token=2,
    moe_mode="dense",        # baseline; "dispatch" is the hillclimbed variant
    sliding_window=4096,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1e6,
    fed_mode="sequential",   # ~47 GB params bf16
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=256, vocab_size=512, num_experts=4,
        experts_per_token=2, sliding_window=64, dtype="float32",
        fed_mode="parallel")
