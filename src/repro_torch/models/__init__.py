"""Model zoo of the port: the dense, MoE and VLM transformer, Mamba2, the
RG-LRU hybrid and the encoder-decoder (served and trained), and the paper's
CIFAR CNN (trained)."""
from repro_torch.models.api import Model, get_model

__all__ = ["Model", "get_model"]
