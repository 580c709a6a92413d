"""Generate dynamic-object masks for NuScenes captures.
(a copy of nerfstudio_thermal_tpu/scripts/datasets/process_nuscenes_masks.py,
which imports no JAX; host-only: the card's machine has no OpenCV)

Behavioral spec: reference `nerfstudio/scripts/datasets/process_nuscenes_masks.py:29-155`
— for every sample/camera, project each *dynamic* cuboid annotation (any
frame's box velocity above a threshold) into the image and zero the pixels of
all six rasterized faces; the back camera additionally masks the ego-vehicle
trunk (bottom 100 rows). Masks are white (=keep) PNGs matching the image
filenames, consumed by the dataparser's mask plumbing.

The nuscenes devkit is import-gated; the geometry (face rasterization,
dynamic-instance chain walk) is pure and unit-testable without it.
"""

import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Tuple

import numpy as np

# the 6 faces of a NuScenes box.corners() cuboid (corner ordering per the
# devkit: 0-3 front face, 4-7 back face)
CUBOID_FACES = (
    (0, 1, 2, 3),  # front
    (4, 5, 6, 7),  # back
    (0, 1, 5, 4),  # top
    (2, 3, 7, 6),  # bottom
    (0, 3, 7, 4),  # left
    (1, 2, 6, 5),  # right
)


def project_points(points_3d: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """[3, N] camera-frame points -> [N, 2] pixel coords (perspective divide,
    the devkit's view_points(normalize=True))."""
    p = intrinsics @ points_3d
    return (p[:2] / np.maximum(p[2:3], 1e-9)).T


def rasterize_cuboid(mask: np.ndarray, corners_2d: np.ndarray) -> np.ndarray:
    """Zero the 6 projected faces of a cuboid in a {0,1} uint8 mask.
    corners_2d: [8, 2] pixel coords (box.corners() order)."""
    import cv2  # host-only: OpenCV is not on the card's machine

    pts = np.round(corners_2d).astype(np.int32)
    for face in CUBOID_FACES:
        cv2.fillPoly(mask, [pts[list(face)]], 0)
    return mask


def instance_is_dynamic(nusc, instance: dict, velocity_thresh: float) -> bool:
    """Walk the annotation chain; dynamic if any frame's speed >= thresh."""
    ann_token = instance["first_annotation_token"]
    while ann_token:
        velocity = nusc.box_velocity(ann_token)
        if np.linalg.norm(velocity) >= velocity_thresh:
            return True
        ann_token = nusc.get("sample_annotation", ann_token)["next"]
    return False


@dataclass
class ProcessNuScenesMasks:
    data_dir: Path = Path("data/nuscenes")
    output_dir: Path = Path("data/nuscenes_masks")
    version: str = "v1.0-mini"
    velocity_thresh: float = 0.75
    cameras: Tuple[str, ...] = field(
        default_factory=lambda: (
            "FRONT", "FRONT_LEFT", "FRONT_RIGHT",
            "BACK", "BACK_LEFT", "BACK_RIGHT",
        )
    )

    def main(self) -> int:
        try:
            from nuscenes.nuscenes import NuScenes as NuScenesDatabase
            from nuscenes.utils.geometry_utils import BoxVisibility
        except ImportError:
            print(
                "error: the nuscenes devkit is required "
                "(pip install nuscenes-devkit)", file=sys.stderr,
            )
            return 1

        nusc = NuScenesDatabase(
            version=self.version, dataroot=str(self.data_dir.absolute())
        )
        cameras = [f"CAM_{c}" for c in self.cameras]
        for camera in cameras:
            (self.output_dir / "masks" / camera).mkdir(parents=True, exist_ok=True)

        dynamic = {
            inst["token"]: instance_is_dynamic(nusc, inst, self.velocity_thresh)
            for inst in nusc.instance
        }

        import cv2  # host-only: OpenCV is not on the card's machine

        samples = sorted(nusc.sample, key=lambda x: (x["scene_token"], x["timestamp"]))
        for sample in samples:
            for camera in cameras:
                camera_data = nusc.get("sample_data", sample["data"][camera])
                calib = nusc.get(
                    "calibrated_sensor", camera_data["calibrated_sensor_token"]
                )
                intrinsics = np.asarray(calib["camera_intrinsic"])
                _, boxes, _ = nusc.get_sample_data(
                    sample["data"][camera], box_vis_level=BoxVisibility.ANY
                )
                mask = np.ones((900, 1600), np.uint8)
                if camera == "CAM_BACK":
                    mask[-100:] = 0  # ego-vehicle trunk
                for box in boxes:
                    ann = nusc.get("sample_annotation", box.token)
                    if not dynamic[ann["instance_token"]]:
                        continue
                    corners = project_points(box.corners(), intrinsics)
                    rasterize_cuboid(mask, corners)
                name = os.path.split(camera_data["filename"])[1].replace("jpg", "png")
                cv2.imwrite(
                    str(self.output_dir / "masks" / camera / name), mask * 255
                )
        print(f"wrote masks to {self.output_dir / 'masks'}")
        return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = ProcessNuScenesMasks()
    i = 0
    while i < len(argv):
        key = argv[i].lstrip("-").replace("-", "_")
        if argv[i] in ("-h", "--help"):
            print(
                "usage: process_nuscenes_masks --data-dir DIR --output-dir DIR "
                "[--version V] [--velocity-thresh T] [--cameras FRONT,BACK,...]"
            )
            return 0
        val = argv[i + 1]; i += 2
        if key in ("data_dir", "output_dir"):
            setattr(opts, key, Path(val))
        elif key == "velocity_thresh":
            opts.velocity_thresh = float(val)
        elif key == "version":
            opts.version = val
        elif key == "cameras":
            opts.cameras = tuple(val.split(","))
        else:
            print(f"error: unknown flag --{key.replace('_', '-')}", file=sys.stderr)
            return 2
    return opts.main()


def entrypoint():
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
