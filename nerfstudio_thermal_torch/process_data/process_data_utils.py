"""Image copy / downscale helpers for the data-processing CLI.
(a copy of nerfstudio_thermal_tpu/process_data/process_data_utils.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral spec: reference `nerfstudio/process_data/process_data_utils.py`
(copy_images with crop + renumbered `frame_%05d` names, downscale folders
`images_<k>`). The reference shells out to ffmpeg for resize/crop; this image
has no ffmpeg, so PIL does the resampling (same output contract).
"""

import shutil
from enum import Enum
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".tiff", ".bmp", ".gif")


class CameraModel(Enum):
    OPENCV = "OPENCV"
    OPENCV_FISHEYE = "OPENCV_FISHEYE"
    EQUIRECTANGULAR = "EQUIRECTANGULAR"
    PINHOLE = "PINHOLE"
    SIMPLE_PINHOLE = "SIMPLE_PINHOLE"


CAMERA_MODELS = {
    "perspective": CameraModel.OPENCV,
    "fisheye": CameraModel.OPENCV_FISHEYE,
    "equirectangular": CameraModel.EQUIRECTANGULAR,
    "pinhole": CameraModel.PINHOLE,
    "simple_pinhole": CameraModel.SIMPLE_PINHOLE,
}


def list_images(directory: Path) -> List[Path]:
    return sorted(
        p for p in Path(directory).iterdir()
        if p.is_file() and p.suffix.lower() in IMAGE_SUFFIXES
    )


def copy_images(
    data: Path,
    image_dir: Path,
    image_prefix: str = "frame_",
    crop_factor: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    num_downscales: int = 0,
    verbose: bool = False,
    keep_image_dir: bool = False,
    same_dimensions: bool = True,
) -> List[Path]:
    """Copy (and optionally crop) images into image_dir as
    `{prefix}{i:05d}.png`, writing `images_<2^k>` downscale folders."""
    from PIL import Image  # host-only: Pillow is not on the card's machine

    image_dir = Path(image_dir)
    if image_dir.exists() and not keep_image_dir:
        shutil.rmtree(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)

    source_paths = list_images(Path(data))
    copied = []
    start = len(list_images(image_dir)) if keep_image_dir else 0
    for i, src in enumerate(source_paths):
        dst = image_dir / f"{image_prefix}{start + i + 1:05d}{src.suffix.lower()}"
        if crop_factor != (0.0, 0.0, 0.0, 0.0):
            img = Image.open(src)
            w, h = img.size
            top, bottom, left, right = crop_factor
            img = img.crop(
                (int(left * w), int(top * h), int(w - right * w), int(h - bottom * h))
            )
            img.save(dst)
        else:
            shutil.copy(src, dst)
        copied.append(dst)

    downscale_images(image_dir, num_downscales, verbose=verbose)
    return copied


def downscale_images(
    image_dir: Path, num_downscales: int, folder_name: Optional[str] = None,
    verbose: bool = False,
) -> None:
    """Write images_2 / images_4 / ... downscale folders
    (reference process_data_utils.py downscale via ffmpeg; PIL here)."""
    from PIL import Image  # host-only: Pillow is not on the card's machine

    image_dir = Path(image_dir)
    folder_name = folder_name or image_dir.name
    for k in range(1, num_downscales + 1):
        factor = 2**k
        out_dir = image_dir.parent / f"{folder_name}_{factor}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for src in list_images(image_dir):
            img = Image.open(src)
            w, h = img.size
            img.resize((max(w // factor, 1), max(h // factor, 1)), Image.BILINEAR).save(
                out_dir / src.name
            )


def get_num_frames_in_video(video: Path) -> int:
    """Frame count (reference process_data_utils.py:98-113 shells out to
    ffprobe; this image has no ffmpeg, so cv2's demuxer is used)."""
    import cv2  # host-only: OpenCV is not on the card's machine

    cap = cv2.VideoCapture(str(video))
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def convert_video_to_images(
    video_path: Path,
    image_dir: Path,
    num_frames_target: int,
    num_downscales: int,
    crop_factor: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    verbose: bool = False,
    image_prefix: str = "frame_",
    keep_image_dir: bool = False,
) -> Tuple[List[str], int]:
    """Extract ~num_frames_target evenly spaced frames from a video into
    image_dir as {prefix}{i:05d}.png, plus downscale folders
    (reference process_data_utils.py:116-219, ffmpeg select filter ->
    cv2.VideoCapture here since ffmpeg is absent from this image)."""
    import cv2  # host-only: OpenCV is not on the card's machine

    video_path = Path(video_path)
    image_dir = Path(image_dir)
    if not keep_image_dir:
        for i in range(num_downscales + 1):
            d = image_dir if i == 0 else Path(f"{image_dir}_{2**i}")
            shutil.rmtree(d, ignore_errors=True)
    image_dir.mkdir(parents=True, exist_ok=True)

    for c in crop_factor:
        if c < 0 or c > 1:
            raise ValueError("crop factors must be in [0, 1]")
    if not video_path.is_file():
        raise FileNotFoundError(f"video does not exist: {video_path}")

    num_frames = get_num_frames_in_video(video_path)
    if num_frames == 0:
        raise ValueError(f"video has no frames: {video_path}")
    spacing = max(num_frames // max(num_frames_target, 1), 1)

    cap = cv2.VideoCapture(str(video_path))
    start = len(list_images(image_dir)) if keep_image_dir else 0
    idx = 0
    written = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % spacing == 0:
                h, w = frame.shape[:2]
                top, bottom, left, right = crop_factor
                if crop_factor != (0.0, 0.0, 0.0, 0.0):
                    frame = frame[
                        int(top * h) : int(h - bottom * h),
                        int(left * w) : int(w - right * w),
                    ]
                written += 1
                cv2.imwrite(
                    str(image_dir / f"{image_prefix}{start + written:05d}.png"),
                    frame,
                )
            idx += 1
    finally:
        cap.release()

    downscale_images(image_dir, num_downscales, verbose=verbose)
    summary = [
        f"Starting with {num_frames} video frames",
        f"We extracted {written} images with prefix '{image_prefix}'",
    ]
    return summary, written


def find_tool_feature_matcher_combination(sfm_tool, feature_type, matcher_type):
    """Resolve 'any' selections (reference :525-600, simplified: colmap with
    SIFT is the supported combination here; hloc is reported unavailable)."""
    if sfm_tool == "any":
        sfm_tool = "colmap"
    if sfm_tool == "colmap":
        return "colmap", "sift", "NN" if matcher_type == "any" else matcher_type
    return sfm_tool, feature_type, matcher_type
