from .cunet import CUNet

__all__ = ["CUNet"]
