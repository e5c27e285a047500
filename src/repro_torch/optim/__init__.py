"""Optimizers and learning-rate schedules (port of the JAX package's
``optim``)."""
from repro_torch.optim.optimizers import (Optimizer, OptimizerConfig, adam,
                                          make_optimizer, sgd)
from repro_torch.optim.schedules import (constant, cosine, paper_theorem1,
                                         warmup_cosine)

__all__ = [
    "Optimizer", "OptimizerConfig", "adam", "make_optimizer", "sgd",
    "constant", "cosine", "paper_theorem1", "warmup_cosine",
]
