"""`ns-process-data video`: video -> frames -> COLMAP -> transforms.json.
(a copy of nerfstudio_thermal_tpu/process_data/video_to_nerfstudio_dataset.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference
`nerfstudio/process_data/video_to_nerfstudio_dataset.py:28-136` — extract
~num_frames_target evenly spaced frames (train + optional eval video with
frame_train_/frame_eval_ prefixes), downscale, run COLMAP, write
transforms.json. An equirectangular video (`--camera-type
equirectangular`) is cut into `images_per_equirect` planar projections per
frame first (equirect_utils), then goes through COLMAP as perspective
images.
"""

from dataclasses import dataclass
from typing import Optional

from nerfstudio_thermal_torch.process_data import colmap_utils, process_data_utils
from nerfstudio_thermal_torch.process_data.images_to_nerfstudio_dataset import (
    ColmapConverterToNerfstudioDataset,
)


@dataclass
class VideoToNerfstudioDataset(ColmapConverterToNerfstudioDataset):
    """(reference video_to_nerfstudio_dataset.py:28-42)."""

    num_frames_target: int = 300
    percent_radius_crop: float = 1.0
    images_per_equirect: int = 8

    def main(self) -> None:
        if self.camera_type == "equirectangular":
            return self._main_equirectangular()
        summary, n = process_data_utils.convert_video_to_images(
            self.data,
            image_dir=self.image_dir,
            num_frames_target=self.num_frames_target,
            num_downscales=self.num_downscales,
            crop_factor=self.crop_factor,
            verbose=self.verbose,
            image_prefix="frame_train_" if self.eval_data is not None else "frame_",
            keep_image_dir=False,
        )
        if self.eval_data is not None:
            summary_eval, n_eval = process_data_utils.convert_video_to_images(
                self.eval_data,
                image_dir=self.image_dir,
                num_frames_target=self.num_frames_target,
                num_downscales=self.num_downscales,
                crop_factor=self.crop_factor,
                verbose=self.verbose,
                image_prefix="frame_eval_",
                keep_image_dir=True,
            )
            summary += summary_eval
            n += n_eval

        if not self.skip_colmap:
            self._run_colmap()
            colmap_utils.colmap_to_json(
                self.absolute_colmap_path / "sparse" / "0", self.output_dir
            )
        for line in summary:
            print(line)
        print(f"processed video into {self.output_dir} ({n} frames)")

    def _main_equirectangular(self) -> None:
        """360 video: extract frames, project each into
        `images_per_equirect` perspective views, then the images pipeline
        (reference video_to_nerfstudio_dataset.py:52-115)."""
        import shutil

        from nerfstudio_thermal_torch.process_data import equirect_utils

        temp_dir = self.output_dir / "temp_images"
        temp_dir.mkdir(parents=True, exist_ok=True)
        summary, n = process_data_utils.convert_video_to_images(
            self.data, image_dir=temp_dir,
            num_frames_target=self.num_frames_target,
            num_downscales=0, crop_factor=(0.0, 0.0, 0.0, 0.0),
            verbose=self.verbose,
        )
        size = equirect_utils.compute_resolution_from_equirect(
            temp_dir, self.images_per_equirect
        )
        planar_dir = equirect_utils.generate_planar_projections_from_equirectangular(
            temp_dir, size, self.images_per_equirect, crop_factor=self.crop_factor
        )
        process_data_utils.copy_images(
            planar_dir, image_dir=self.image_dir,
            num_downscales=self.num_downscales, verbose=self.verbose,
        )
        shutil.rmtree(temp_dir, ignore_errors=True)
        self.camera_type = "perspective"
        if not self.skip_colmap:
            self._run_colmap()
            colmap_utils.colmap_to_json(
                self.absolute_colmap_path / "sparse" / "0", self.output_dir
            )
        for line in summary:
            print(line)
        print(
            f"processed 360 video into {self.output_dir} "
            f"({n} frames x {self.images_per_equirect} views)"
        )
