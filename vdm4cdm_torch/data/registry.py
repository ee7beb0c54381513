"""JSON data registries: counterpart of ``vdm4cdm_tpu/data/registry.py``
(this package's own copy).

Same three-registry scheme as the reference (data_source*.json,
normalizations*.json, alphas*.json — reference CAMELS_3D_dataset.py:10-17),
with two fixes the reference needs (SURVEY.md §5 config row):
  * paths may be relative; they resolve against $VDM4CDM_DATA_ROOT (or an
    explicit root) instead of hardcoded absolute cluster paths;
  * registries load lazily from an explicit directory, not at module import.

Registry layout:
  data_source.json:     {dataset: {suite: {set: {z: {field: path.npy}}}}}
  normalizations.json:  {"<field>_m": mean, "<field>_s": std}
  alphas.json:          {field: alpha}
  params files:         params_{set}_{suite}.txt  (plain text, one row per sim)
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataRegistry:
    registry_dir: str
    suffix: str = ""  # "" for 2D registries, "_3d" for 3D
    data_root: Optional[str] = None

    def __post_init__(self):
        if self.data_root is None:
            self.data_root = os.environ.get("VDM4CDM_DATA_ROOT", "")
        self._data_source = self._load(f"data_source{self.suffix}.json")
        self._normalizations = self._load(f"normalizations{self.suffix}.json")
        self._alphas = self._load(f"alphas{self.suffix}.json")

    def _load(self, name):
        with open(os.path.join(self.registry_dir, name)) as f:
            return json.load(f)

    def _resolve(self, path: str) -> str:
        if os.path.isabs(path):
            return path
        return os.path.join(self.data_root, path)

    def field_path(self, dataset: str, suite: str, set_name: str, z: str, field: str) -> str:
        return self._resolve(self._data_source[dataset][suite][set_name][z][field])

    def load_field(self, dataset, suite, set_name, z, field, mmap: bool = True) -> np.ndarray:
        path = self.field_path(dataset, suite, set_name, z, field)
        if not mmap and os.environ.get("VDM4CDM_DIRECT_IO", "0") == "1":
            # RAM-resident load via the native O_DIRECT bulk reader: streams
            # the stack at device bandwidth instead of faulting 4K mmap pages
            # (native/fastloader.cpp fastloader_read_direct). Falls back to
            # np.load when the native library is unavailable.
            from . import native

            if native.available():
                return native.read_npy_direct(path)
        return np.load(path, mmap_mode="r" if mmap else None)

    def normalization(self, field: str) -> tuple[float, float]:
        return self._normalizations[f"{field}_m"], self._normalizations[f"{field}_s"]

    def alpha(self, field: str) -> float:
        return self._alphas[field]

    def params_path(self, set_name: str, suite: str) -> str:
        return self._resolve(f"params_new/params_{set_name}_{suite}.txt")

    def load_params(self, set_name: str, suite: str) -> np.ndarray:
        return np.loadtxt(self.params_path(set_name, suite))
