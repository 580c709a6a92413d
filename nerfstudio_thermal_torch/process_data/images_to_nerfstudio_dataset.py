"""Image-folder -> nerfstudio dataset converters.
(a copy of nerfstudio_thermal_tpu/process_data/images_to_nerfstudio_dataset.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/process_data/base_converter_to_nerfstudio_dataset.py`,
`colmap_converter_to_nerfstudio_dataset.py` and
`images_to_nerfstudio_dataset.py:36-133` — copy+downscale images, run SfM,
write transforms.json.
"""

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from nerfstudio_thermal_torch.process_data import colmap_utils, process_data_utils
from nerfstudio_thermal_torch.process_data.process_data_utils import CAMERA_MODELS


@dataclass
class BaseConverterToNerfstudioDataset:
    data: Path = Path()
    output_dir: Path = Path()
    verbose: bool = False

    @property
    def image_dir(self) -> Path:
        return self.output_dir / "images"

    def __post_init__(self):
        self.output_dir = Path(self.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def main(self) -> None:
        raise NotImplementedError


@dataclass
class ColmapConverterToNerfstudioDataset(BaseConverterToNerfstudioDataset):
    camera_type: str = "perspective"
    sfm_tool: str = "any"
    feature_type: str = "any"
    matcher_type: str = "any"
    num_downscales: int = 3
    skip_colmap: bool = False
    skip_image_processing: bool = False
    colmap_cmd: str = "colmap"
    matching_method: str = "sequential"
    gpu: bool = False
    crop_factor: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    eval_data: Optional[Path] = None
    same_dimensions: bool = True
    refine_pixsfm: bool = False

    @property
    def absolute_colmap_path(self) -> Path:
        return self.output_dir / "colmap"

    def _run_colmap(self, mask_path: Optional[Path] = None):
        self.absolute_colmap_path.mkdir(parents=True, exist_ok=True)
        image_dir = self.data if self.skip_image_processing else self.image_dir
        colmap_utils.run_colmap(
            image_dir=image_dir,
            colmap_dir=self.absolute_colmap_path,
            camera_model=CAMERA_MODELS[self.camera_type],
            camera_mask_path=mask_path,
            gpu=self.gpu,
            verbose=self.verbose,
            matching_method=self.matching_method,
            colmap_cmd=self.colmap_cmd,
        )


@dataclass
class ImagesToNerfstudioDataset(ColmapConverterToNerfstudioDataset):
    """(reference images_to_nerfstudio_dataset.py:25-133)."""

    def main(self) -> None:
        if not self.skip_image_processing:
            process_data_utils.copy_images(
                self.data,
                image_dir=self.image_dir,
                crop_factor=self.crop_factor,
                image_prefix="frame_train_" if self.eval_data is not None else "frame_",
                num_downscales=self.num_downscales,
                verbose=self.verbose,
                same_dimensions=self.same_dimensions,
            )
            if self.eval_data is not None:
                process_data_utils.copy_images(
                    self.eval_data,
                    image_dir=self.image_dir,
                    crop_factor=self.crop_factor,
                    image_prefix="frame_eval_",
                    num_downscales=self.num_downscales,
                    verbose=self.verbose,
                    same_dimensions=self.same_dimensions,
                    keep_image_dir=True,
                )
        if not self.skip_colmap:
            self._run_colmap()
            colmap_utils.colmap_to_json(
                self.absolute_colmap_path / "sparse" / "0", self.output_dir
            )
        print(f"processed images into {self.output_dir}")
