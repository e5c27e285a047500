"""StarCoder2-7B [arXiv:2402.19173]: dense GQA (kv=4), RoPE."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    source="GQA, RoPE [arXiv:2402.19173]",
    num_layers=32,
    d_model=4608,
    num_heads=36,           # 36 % 16 != 0 — flat-dim sharding (DESIGN.md §3.3)
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1e5,
    fed_mode="parallel",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, dtype="float32")
