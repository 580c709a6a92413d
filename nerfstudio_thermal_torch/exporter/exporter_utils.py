"""Export helpers: depth-backprojected point clouds and PLY files
(counterpart of nerfstudio_thermal_tpu/exporter/exporter_utils.py).

The PLY writers and readers are numpy only and behave byte for byte as
the JAX package's. The renders go through the port's model API: the
parameters live in the model, and `get_outputs_for_camera` renders on
the model's device and returns host numpy [h, w, C]. Camera poses and
intrinsics are tensors here, moved to the host before numpy touches them.
"""

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from nerfstudio_thermal_torch.cameras.cameras import Cameras


def write_ply(
    path: Path,
    points: np.ndarray,  # [N, 3] float
    colors: Optional[np.ndarray] = None,  # [N, 3] float in [0,1]
    normals: Optional[np.ndarray] = None,
) -> None:
    """Binary little-endian PLY."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = points.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in "xyz"]
    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        header += [f"property float n{a}" for a in "xyz"]
        dtype += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        dtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header.append("end_header")

    data = np.empty(n, dtype=dtype)
    data["x"], data["y"], data["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        data["nx"], data["ny"], data["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        c = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        data["red"], data["green"], data["blue"] = c[:, 0], c[:, 1], c[:, 2]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(data.tobytes())


def _read_header(f) -> List[str]:
    header = []
    while True:
        line = f.readline().decode().strip()
        header.append(line)
        if line == "end_header":
            return header


def read_ply(path: Path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read back a PLY written by write_ply: (points [N, 3], colors [N, 3]
    in [0, 1] or None)."""
    with open(path, "rb") as f:
        header = _read_header(f)
        n = int(next(line for line in header if line.startswith("element vertex")).split()[-1])
        props = [line.split()[1:] for line in header if line.startswith("property")]
        dtype = [(name, "<f4" if typ == "float" else "u1") for typ, name in props]
        data = np.frombuffer(f.read(), dtype=dtype, count=n)
    points = np.stack([data["x"], data["y"], data["z"]], -1)
    colors = None
    if "red" in data.dtype.names:
        colors = np.stack([data["red"], data["green"], data["blue"]], -1) / 255.0
    return points, colors


def write_ply_mesh(
    path: Path,
    vertices: np.ndarray,  # [V, 3]
    faces: np.ndarray,  # [F, 3] int
    normals: Optional[np.ndarray] = None,  # [V, 3]
    colors: Optional[np.ndarray] = None,  # [V, 3] in [0,1]
) -> None:
    """Binary little-endian PLY triangle mesh (vertex list + int32 face
    list)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    nv, nf = vertices.shape[0], faces.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {nv}"]
    header += [f"property float {a}" for a in "xyz"]
    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        header += [f"property float n{a}" for a in "xyz"]
        dtype += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        dtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header += [f"element face {nf}", "property list uchar int vertex_indices", "end_header"]
    vdata = np.empty(nv, dtype=dtype)
    vdata["x"], vdata["y"], vdata["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if normals is not None:
        vdata["nx"], vdata["ny"], vdata["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        c = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        vdata["red"], vdata["green"], vdata["blue"] = c[:, 0], c[:, 1], c[:, 2]
    fdata = np.empty(nf, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    fdata["n"] = 3
    fdata["idx"] = faces.astype(np.int32)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(vdata.tobytes())
        f.write(fdata.tobytes())


def read_ply_mesh(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """Read back a mesh written by write_ply_mesh: (vertices [V, 3], faces
    [F, 3])."""
    with open(path, "rb") as f:
        header = _read_header(f)
        nv = int(next(line for line in header if line.startswith("element vertex")).split()[-1])
        nf = int(next(line for line in header if line.startswith("element face")).split()[-1])
        props = [
            line.split()[1:]
            for line in header[header.index(f"element vertex {nv}") + 1:]
            if line.startswith("property") and not line.startswith("property list")
        ]
        vdtype = [(name, "<f4" if typ == "float" else "u1") for typ, name in props]
        vdata = np.frombuffer(f.read(np.dtype(vdtype).itemsize * nv), dtype=vdtype)
        fdata = np.frombuffer(f.read(), dtype=[("n", "u1"), ("idx", "<i4", (3,))], count=nf)
    verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], -1)
    return verts, np.asarray(fdata["idx"])


def _intrinsics(cameras: Cameras, i: int) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy) of camera i as host floats."""
    return tuple(float(getattr(cameras, k)[i]) for k in ("fx", "fy", "cx", "cy"))


def render_cameras_for_export(
    model,
    cameras: Cameras,
    rgb_output_name: str = "rgb",
    depth_output_name: str = "depth",
    downscale_factor: int = 2,
    num_cameras: Optional[int] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray], np.ndarray, np.ndarray]:
    """Render every camera at reduced resolution for volumetric fusion.
    Returns (rgbs: list of [H, W, 3], depths: list of [H, W], c2ws [B, 4,
    4], Ks [B, 3, 3]): lists, because the cameras may have per-modality
    resolutions (RGB against thermal)."""
    cams = cameras.rescale_output_resolution(1.0 / downscale_factor)
    host = cams.to("cpu")
    n = min(num_cameras or len(cams), len(cams))
    rgbs, depths, c2ws, Ks = [], [], [], []
    for i in range(n):
        outputs = model.get_outputs_for_camera(cams, i)
        rgb = outputs[rgb_output_name]
        if rgb.shape[-1] == 1:
            rgb = np.repeat(rgb, 3, -1)
        rgbs.append(rgb[..., :3])
        depths.append(outputs[depth_output_name][..., 0])
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3] = host.camera_to_worlds[i].numpy()
        c2ws.append(c2w)
        fx, fy, cx, cy = _intrinsics(host, i)
        Ks.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32))
    return rgbs, depths, np.stack(c2ws), np.stack(Ks)


def generate_point_cloud(
    model,
    cameras: Cameras,
    num_cameras: Optional[int] = None,
    min_accumulation: float = 0.5,
    use_thermal_color: bool = False,
    stride: int = 4,
    return_normals: bool = False,
):
    """Backproject expected depth from the cameras into a coloured point
    cloud: every `stride`-th pixel whose accumulation exceeds
    `min_accumulation`, coloured by "rgb_thermal" where
    `use_thermal_color` asks for it and the model renders it, else "rgb".
    Returns (points [N, 3], colors [N, 3]) or, with return_normals=True,
    (points, colors, normals): the cross product of the point map's
    image-space gradients, oriented toward the camera."""
    host = cameras.to("cpu")
    points_all, colors_all, normals_all = [], [], []
    n = num_cameras if num_cameras is not None else len(cameras)
    for i in range(min(n, len(cameras))):
        outputs = model.get_outputs_for_camera(cameras, i)
        depth = outputs["expected_depth"][::stride, ::stride, 0]
        acc = outputs["accumulation"][::stride, ::stride, 0]
        rgb_key = "rgb_thermal" if use_thermal_color and "rgb_thermal" in outputs else "rgb"
        rgb = outputs[rgb_key][::stride, ::stride]
        if rgb.shape[-1] == 1:
            rgb = np.repeat(rgb, 3, -1)

        h, w = depth.shape
        fx, fy, cx, cy = (v / stride for v in _intrinsics(host, i))
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        # OpenGL camera: x right, y up, -z forward
        dirs = np.stack([(xs + 0.5 - cx) / fx, -(ys + 0.5 - cy) / fy, -np.ones_like(depth)], -1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        c2w = host.camera_to_worlds[i].numpy()
        world_dirs = dirs @ c2w[:3, :3].T
        origin = c2w[:3, 3]
        pts = origin + world_dirs * depth[..., None]

        mask = acc > min_accumulation
        points_all.append(pts[mask])
        colors_all.append(rgb[mask])
        if return_normals:
            du = np.gradient(pts, axis=1)
            dv = np.gradient(pts, axis=0)
            nrm = np.cross(du, dv)
            nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
            # orient toward the camera
            sign = np.sign(np.sum(nrm * (origin - pts), axis=-1, keepdims=True))
            nrm = nrm * np.where(sign == 0, 1.0, sign)
            normals_all.append(nrm[mask])
    if return_normals:
        return np.concatenate(points_all), np.concatenate(colors_all), np.concatenate(normals_all)
    return np.concatenate(points_all), np.concatenate(colors_all)
