"""RecurrentGemma-2B [arXiv:2402.19427]: RG-LRU + local attention, 1 attn : 2
recurrent (26 layers = 8 x (R,R,A) + 2 tail R).  Local window 2048 and O(1)
recurrent state make ``long_500k`` native."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="RG-LRU + local attn, 1:2 [arXiv:2402.19427]",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,          # MQA — KV replicated over the model axis
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    lru_width=2560,
    local_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    ssm_conv=4,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1e4,
    fed_mode="parallel",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    # hybrid needs >= one (R,R,A) block; 5 = 1 block + 2 tail exercises both paths
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=128, num_heads=4, num_kv_heads=1,
        head_dim=32, d_ff=256, vocab_size=512, lru_width=128, local_window=32,
        dtype="float32")
