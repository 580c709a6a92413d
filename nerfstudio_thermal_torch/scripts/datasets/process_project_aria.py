"""Convert a Project Aria recording (VRS + MPS attachments) into a
nerfstudio dataset.
(counterpart of nerfstudio_thermal_tpu/scripts/datasets/process_project_aria.py;
the frames are written by the port's JPEG encoder, byte-equal to Pillow's
quality-75 RGB JPEG that the JAX script saves, so this script needs no
Pillow)

Behavioral spec: reference `nerfstudio/scripts/datasets/process_project_aria.py:36-253`
— read the camera-rgb stream's factory calibration (FISHEYE624: f, cx, cy +
12 distortion params) and every image from the VRS, pose each image by
nearest-timestamp lookup in the MPS closed-loop trajectory, compose
`t_world_device @ t_device_camera @ T_ARIA_NERFSTUDIO`, and write a
transforms.json with per-frame intrinsics/distortion, a fisheye crop radius
scaled from the canonical 1408-px sensor, and (when present) the MPS global
point cloud as a PLY for splatfacto seeding.

projectaria_tools/open3d are import-gated; the coordinate/time math is pure
and unit-testable without them.
"""

import json
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ARIA_CAMERA_MODEL = "FISHEYE624"

# Aria device frame: +Z forward, +Y down; nerfstudio camera: -Z forward,
# +Y up (reference :38-50).
T_ARIA_NERFSTUDIO = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, -1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)

CANONICAL_RGB_VALID_RADIUS = 707.5
CANONICAL_RGB_WIDTH = 1408


def rgb_valid_radius(width: int) -> float:
    """Fisheye crop radius for a given RGB stream width (reference :216-218)."""
    return CANONICAL_RGB_VALID_RADIUS * (width / CANONICAL_RGB_WIDTH)


def nearest_pose_index(timestamps_ns: np.ndarray, capture_ns: int) -> int:
    """Nearest-after trajectory sample for a capture time, clipped to the
    last sample (reference :144-147)."""
    idx = int(np.searchsorted(timestamps_ns, capture_ns))
    return min(idx, len(timestamps_ns) - 1)


def aria_frame_to_nerfstudio(
    t_world_device: np.ndarray,
    t_device_camera: np.ndarray,
    projection_params: np.ndarray,
    width: int,
    height: int,
    file_path: str,
    timestamp_ns: int,
) -> dict:
    """One transforms.json frame from Aria calibration + pose.

    projection_params: the FISHEYE624 vector [f, cx, cy, k0..k5, p0, p1,
    s0..s3] (reference get_camera_calibs :88-101)."""
    p = np.asarray(projection_params, np.float64)
    t_world_camera = (
        np.asarray(t_world_device) @ np.asarray(t_device_camera) @ T_ARIA_NERFSTUDIO
    )
    return {
        "fl_x": float(p[0]),
        "fl_y": float(p[0]),
        "cx": float(p[1]),
        "cy": float(p[2]),
        "distortion_params": p[3:15].tolist(),
        "w": int(width),
        "h": int(height),
        "file_path": file_path,
        "transform_matrix": t_world_camera.tolist(),
        "timestamp": int(timestamp_ns),
    }


@dataclass
class ProcessProjectAria:
    vrs_file: Path = Path("recording.vrs")
    mps_data_dir: Path = Path("mps")
    output_dir: Path = Path("aria_out")

    def main(self) -> int:
        try:
            from projectaria_tools.core import mps
            from projectaria_tools.core.data_provider import (
                create_vrs_data_provider,
            )
            from projectaria_tools.core.mps.utils import (
                filter_points_from_confidence,
            )
        except ImportError:
            print(
                "error: projectaria_tools is required "
                "(pip install projectaria-tools)", file=sys.stderr,
            )
            return 1

        from nerfstudio_thermal_torch.data.jpeg import encode_jpeg

        self.output_dir = self.output_dir.absolute()
        self.output_dir.mkdir(parents=True, exist_ok=True)

        provider = create_vrs_data_provider(str(self.vrs_file.absolute()))
        if provider is None:
            print(f"error: cannot open {self.vrs_file}", file=sys.stderr)
            return 1
        name = "camera-rgb"
        device_calib = provider.get_device_calibration()
        sensor_calib = device_calib.get_camera_calib(name)
        width = int(sensor_calib.get_image_size()[0])
        height = int(sensor_calib.get_image_size()[1])
        projection_params = np.asarray(sensor_calib.projection_params())
        t_device_camera = np.asarray(
            sensor_calib.get_transform_device_camera().to_matrix()
        )

        traj = mps.read_closed_loop_trajectory(
            str((self.mps_data_dir / "closed_loop_trajectory.csv").absolute())
        )
        timestamps_ns = np.asarray(
            [int(it.tracking_timestamp.total_seconds() * 1e9) for it in traj]
        )
        t_world_devices = [
            np.asarray(it.transform_world_device.to_matrix()) for it in traj
        ]

        stream_id = provider.get_stream_id_from_label(name)
        frames = []
        for index in range(provider.get_num_data(stream_id)):
            image_data = provider.get_image_data_by_index(stream_id, index)
            capture_ns = image_data[1].capture_timestamp_ns
            file_path = f"{name}_{capture_ns}.jpg"
            # Pillow's `.save` default: quality 75
            (self.output_dir / file_path).write_bytes(
                encode_jpeg(image_data[0].to_numpy_array(), quality=75)
            )
            pose_idx = nearest_pose_index(timestamps_ns, capture_ns)
            frames.append(
                aria_frame_to_nerfstudio(
                    t_world_devices[pose_idx], t_device_camera,
                    projection_params, width, height, file_path, capture_ns,
                )
            )

        out = {
            "camera_model": ARIA_CAMERA_MODEL,
            "frames": frames,
            "fisheye_crop_radius": rgb_valid_radius(width),
        }

        # MPS semidense point cloud -> PLY (splatfacto seeding)
        points_path = self.mps_data_dir / "global_points.csv.gz"
        if not points_path.exists():
            points_path = self.mps_data_dir / "semidense_points.csv.gz"
        if points_path.exists():
            points = filter_points_from_confidence(
                mps.read_global_point_cloud(str(points_path))
            )
            xyz = np.asarray([p.position_world for p in points], np.float32)
            from nerfstudio_thermal_torch.exporter.exporter_utils import write_ply

            write_ply(self.output_dir / "global_points.ply", xyz)
            out["ply_file_path"] = "global_points.ply"

        (self.output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
        print(f"wrote {self.output_dir / 'transforms.json'} ({len(frames)} frames)")
        return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = ProcessProjectAria()
    i = 0
    while i < len(argv):
        if argv[i] in ("-h", "--help"):
            print(
                "usage: process_project_aria --vrs-file FILE "
                "--mps-data-dir DIR --output-dir DIR"
            )
            return 0
        key = argv[i].lstrip("-").replace("-", "_")
        val = argv[i + 1]; i += 2
        if key in ("vrs_file", "mps_data_dir", "output_dir"):
            setattr(opts, key, Path(val))
        else:
            print(f"error: unknown flag --{key.replace('_', '-')}", file=sys.stderr)
            return 2
    return opts.main()


def entrypoint():
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
