from .camels import CAMELSDataModule, get_dataset
from .grf import GRFDataModule, gaussian_random_field
from .registry import DataRegistry
from .transforms import (FieldNormalizer, crop_anchors, flip_and_permute,
                         periodic_crop)

__all__ = [
    "CAMELSDataModule",
    "DataRegistry",
    "FieldNormalizer",
    "GRFDataModule",
    "crop_anchors",
    "flip_and_permute",
    "gaussian_random_field",
    "get_dataset",
    "periodic_crop",
]
