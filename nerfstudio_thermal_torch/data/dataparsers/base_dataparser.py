"""Dataparser base types (counterpart of nerfstudio_thermal_tpu/data/dataparsers/base_dataparser.py).

`DataparserOutputs`: image filenames, the port's `Cameras` (CPU tensors),
the scene box, the dataparser transform and scale, and per-image metadata;
`as_dict` gives the transform and scale for dataparser_transforms.json.
"""

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from nerfstudio_thermal_torch.cameras.cameras import Cameras


@dataclass
class DataparserOutputs:
    image_filenames: List[Path]
    cameras: Cameras
    scene_box: np.ndarray  # [2, 3] aabb
    mask_filenames: Optional[List[Path]] = None
    dataparser_transform: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32)[:3])
    dataparser_scale: float = 1.0
    metadata: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> dict:
        """The transform and scale, as ns-train writes them to
        dataparser_transforms.json."""
        return {
            "dataparser_transform": np.asarray(self.dataparser_transform).tolist(),
            "dataparser_scale": float(self.dataparser_scale),
        }


@dataclass
class DataParserConfig:
    data: Path = Path()


class DataParser:
    def __init__(self, config: DataParserConfig):
        self.config = config

    def get_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        return self._generate_dataparser_outputs(split=split, **kwargs)

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        raise NotImplementedError
