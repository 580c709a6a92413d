"""COLMAP binary model readers (counterpart of
nerfstudio_thermal_tpu/data/utils/colmap_parsing_utils.py, a copy: the
port imports nothing of the JAX package): cameras.bin, images.bin and
points3D.bin, and the (w, x, y, z) quaternion to rotation matrix. Also
`parse_colmap_camera_params` and `CameraModel`, copies of what the COLMAP
parser takes from the JAX package's process_data modules.
"""

import struct
from collections import namedtuple
from enum import Enum
from typing import Any, Dict

import numpy as np

Camera = namedtuple("Camera", ["id", "model", "width", "height", "params"])
Image = namedtuple("Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"])
Point3D = namedtuple("Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODEL_PARAMS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODEL_PARAMS.items()}


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


def _read_next_bytes(fid, num_bytes, format_char_sequence, endian_character="<"):
    data = fid.read(num_bytes)
    return struct.unpack(endian_character + format_char_sequence, data)


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as fid:
        num_cameras = _read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_cameras):
            camera_id, model_id, width, height = _read_next_bytes(fid, 24, "iiQQ")
            model_name, num_params = CAMERA_MODEL_PARAMS[model_id]
            params = _read_next_bytes(fid, 8 * num_params, "d" * num_params)
            cameras[camera_id] = Camera(camera_id, model_name, width, height, np.array(params))
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as fid:
        num_images = _read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_images):
            props = _read_next_bytes(fid, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            char = fid.read(1)
            while char != b"\x00":
                name += char
                char = fid.read(1)
            num_points2d = _read_next_bytes(fid, 8, "Q")[0]
            data = _read_next_bytes(fid, 24 * num_points2d, "ddq" * num_points2d)
            xys = np.column_stack([list(map(float, data[0::3])), list(map(float, data[1::3]))])
            point3d_ids = np.array(list(map(int, data[2::3])))
            images[image_id] = Image(image_id, qvec, tvec, camera_id, name.decode("utf-8"), xys, point3d_ids)
    return images


def read_points3D_binary(path):
    points = {}
    with open(path, "rb") as fid:
        num_points = _read_next_bytes(fid, 8, "Q")[0]
        for _ in range(num_points):
            props = _read_next_bytes(fid, 43, "QdddBBBd")
            point_id = props[0]
            xyz = np.array(props[1:4])
            rgb = np.array(props[4:7])
            error = props[7]
            track_len = _read_next_bytes(fid, 8, "Q")[0]
            track = _read_next_bytes(fid, 8 * track_len, "ii" * track_len)
            points[point_id] = Point3D(point_id, xyz, rgb, error, np.array(track[0::2]), np.array(track[1::2]))
    return points


def qvec2rotmat(qvec):
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def parse_colmap_camera_params(camera) -> Dict[str, Any]:
    """COLMAP camera -> transforms.json intrinsics (the OPENCV family)."""
    out: Dict[str, Any] = {"w": camera.width, "h": camera.height}
    p = camera.params
    model = camera.model
    if model == "SIMPLE_PINHOLE":
        out.update(fl_x=float(p[0]), fl_y=float(p[0]), cx=float(p[1]), cy=float(p[2]), k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    elif model == "PINHOLE":
        out.update(fl_x=float(p[0]), fl_y=float(p[1]), cx=float(p[2]), cy=float(p[3]), k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    elif model == "SIMPLE_RADIAL":
        out.update(fl_x=float(p[0]), fl_y=float(p[0]), cx=float(p[1]), cy=float(p[2]),
                   k1=float(p[3]), k2=0.0, p1=0.0, p2=0.0)
    elif model == "RADIAL":
        out.update(fl_x=float(p[0]), fl_y=float(p[0]), cx=float(p[1]), cy=float(p[2]),
                   k1=float(p[3]), k2=float(p[4]), p1=0.0, p2=0.0)
    elif model == "OPENCV":
        out.update(fl_x=float(p[0]), fl_y=float(p[1]), cx=float(p[2]), cy=float(p[3]),
                   k1=float(p[4]), k2=float(p[5]), p1=float(p[6]), p2=float(p[7]))
    elif model == "OPENCV_FISHEYE":
        out.update(fl_x=float(p[0]), fl_y=float(p[1]), cx=float(p[2]), cy=float(p[3]),
                   k1=float(p[4]), k2=float(p[5]), k3=float(p[6]), k4=float(p[7]))
        out["camera_model"] = "OPENCV_FISHEYE"
        return out
    else:
        raise NotImplementedError(f"unsupported COLMAP camera model {model}")
    out["camera_model"] = "OPENCV"
    return out
