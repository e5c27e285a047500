"""The paper's own §V model: CIFAR CNN from McMahan et al. [7] (~1-2e6 params).
Used by the faithful Figure-1 reproduction."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="cifar-cnn",
    family="cnn",
    source="McMahan et al. [7], as used in Güler & Yener §V",
    num_layers=2,
    d_model=384,
    vocab_size=10,
    dtype="float32",
    fed_mode="parallel",
    remat=False,
)


def smoke_config() -> ModelConfig:
    return CONFIG
