"""Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD (state-space duality).

48 layers, d_model 2048, d_inner 4096 (expand 2), 64 heads x head_dim 64,
state 128.  Decode is O(1) state — ``long_500k`` runs natively."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="SSD (state-space duality) [arXiv:2405.21060]",
    num_layers=48,
    d_model=2048,
    num_heads=0,            # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_groups=1,
    norm_type="rmsnorm",
    pos_type="none",
    fed_mode="parallel",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, ssm_state=16, ssm_head_dim=32,
        ssm_chunk=16, vocab_size=512, dtype="float32")
