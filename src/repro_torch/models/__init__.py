"""Model code: shared layers and the dense transformer via a uniform API."""

from repro_torch.models.registry import Model, get_model

__all__ = ["Model", "get_model"]
