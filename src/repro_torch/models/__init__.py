"""Model zoo of the port: the dense GQA transformer (served) and the
paper's CIFAR CNN (trained)."""
from repro_torch.models.api import Model, get_model

__all__ = ["Model", "get_model"]
