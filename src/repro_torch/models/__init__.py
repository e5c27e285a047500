"""Model zoo of the port: the dense GQA transformer in this slice."""
from repro_torch.models.api import Model, get_model

__all__ = ["Model", "get_model"]
