"""Models of the port."""
from decnet_tpu_torch.models.decnet import DecNet

__all__ = ["DecNet"]
