"""Device-capture converters: Polycam, Record3D, Metashape, RealityCapture,
ODM, Skydio — each turns a vendor export into a nerfstudio transforms.json.
(a copy of nerfstudio_thermal_tpu/process_data/device_converters.py, which imports no JAX;
host-only, as there: the card's machine has no OpenCV, Pillow, exiftool,
COLMAP or ffmpeg.)

Behavioral specs (all in the reference nerfstudio's process_data/):
- polycam_utils.py:28-96 (per-frame camera jsons, blur filter, axis remap)
- record3d_utils.py:28-93 (metadata.json scalar-last quats, K transpose)
- metashape_utils.py:35-201 (cameras.xml sensors/components/transforms,
  axis permutation [2,0,1] + y/z flip)
- realitycapture_utils.py:29-127 (csv poses, 36mm-film focal conversion,
  yaw/pitch/roll rotation)
- odm_utils.py:29-207 (cameras.json + shots.geojson/reconstruction.json,
  Rodrigues rotations, OpenGL flip)
- skydio_to_nerfstudio_dataset.py:18-254 (the ThermalNeRF fork's Skydio
  RGB+IR drone pipeline: XMP metadata poses, gimbal orientation correction,
  is_thermal flags) — requires exiftool, gated like flir_utils.

All are host-side (CPU) conversion code; nothing here touches the card.
"""

import json
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from nerfstudio_thermal_torch.process_data import process_data_utils
from nerfstudio_thermal_torch.process_data.images_to_nerfstudio_dataset import (
    BaseConverterToNerfstudioDataset,
    ColmapConverterToNerfstudioDataset,
    ImagesToNerfstudioDataset,
)


# ---------------------------------------------------------------------------
# Polycam
# ---------------------------------------------------------------------------


def polycam_to_json(
    image_filenames: List[Path],
    depth_filenames: List[Path],
    cameras_dir: Path,
    output_dir: Path,
    min_blur_score: float = 0.0,
    crop_border_pixels: int = 0,
) -> List[str]:
    """(reference polycam_utils.py:28-96)."""
    use_depth = len(image_filenames) == len(depth_filenames)
    data = {"camera_model": "OPENCV", "orientation_override": "none"}
    frames, skipped = [], 0
    for i, img in enumerate(image_filenames):
        fj = json.loads((Path(cameras_dir) / f"{img.stem}.json").read_text())
        if fj.get("blur_score", np.inf) < min_blur_score:
            skipped += 1
            continue
        frame = {
            "fl_x": fj["fx"], "fl_y": fj["fy"],
            "cx": fj["cx"] - crop_border_pixels,
            "cy": fj["cy"] - crop_border_pixels,
            "w": fj["width"] - crop_border_pixels * 2,
            "h": fj["height"] - crop_border_pixels * 2,
            "file_path": f"./images/frame_{i + 1:05d}{img.suffix}",
            # ARKit row remap to nerfstudio convention (reference :73-79)
            "transform_matrix": [
                [fj["t_20"], fj["t_21"], fj["t_22"], fj["t_23"]],
                [fj["t_00"], fj["t_01"], fj["t_02"], fj["t_03"]],
                [fj["t_10"], fj["t_11"], fj["t_12"], fj["t_13"]],
                [0.0, 0.0, 0.0, 1.0],
            ],
        }
        if use_depth:
            frame["depth_file_path"] = (
                f"./depth/frame_{i + 1:05d}{depth_filenames[i].suffix}"
            )
        frames.append(frame)
    data["frames"] = frames
    (Path(output_dir) / "transforms.json").write_text(json.dumps(data, indent=4))
    if not frames:
        raise RuntimeError("no Polycam frames passed the blur filter")
    summary = []
    if skipped:
        summary.append(f"Skipped {skipped} frames due to low blur score.")
    summary.append(f"Final dataset is {len(frames)} frames.")
    return summary


@dataclass
class PolycamToNerfstudioDataset(BaseConverterToNerfstudioDataset):
    """`ns-process-data polycam` — data points at the polycam export dir
    (keyframes/{images,cameras,depth})."""

    min_blur_score: float = 25.0
    crop_border_pixels: int = 15
    use_depth: bool = False
    num_downscales: int = 3

    def main(self) -> None:
        data = Path(self.data)
        keyframes = data / "keyframes" if (data / "keyframes").exists() else data
        image_dir = keyframes / "corrected_images" if (
            keyframes / "corrected_images"
        ).exists() else keyframes / "images"
        cameras_dir = keyframes / "corrected_cameras" if (
            keyframes / "corrected_cameras"
        ).exists() else keyframes / "cameras"
        images = process_data_utils.list_images(image_dir)
        (self.output_dir / "images").mkdir(parents=True, exist_ok=True)
        for i, src in enumerate(images):
            shutil.copy(src, self.output_dir / "images" / f"frame_{i + 1:05d}{src.suffix}")
        process_data_utils.downscale_images(
            self.output_dir / "images", self.num_downscales
        )
        depths = (
            process_data_utils.list_images(keyframes / "depth")
            if self.use_depth and (keyframes / "depth").exists()
            else []
        )
        summary = polycam_to_json(
            images, depths, cameras_dir, self.output_dir,
            min_blur_score=self.min_blur_score,
            crop_border_pixels=self.crop_border_pixels,
        )
        for line in summary:
            print(line)


# ---------------------------------------------------------------------------
# Record3D
# ---------------------------------------------------------------------------


def record3d_to_json(
    images_paths: List[Path], metadata_path: Path, output_dir: Path,
    indices: np.ndarray,
) -> int:
    """(reference record3d_utils.py:28-93)."""
    from scipy.spatial.transform import Rotation

    md = json.loads(Path(metadata_path).read_text())
    poses = np.asarray(md["poses"])  # [N, 7]: scalar-last quat + translation
    c2w = np.concatenate(
        [Rotation.from_quat(poses[:, :4]).as_matrix(), poses[:, 4:, None]],
        axis=-1,
    ).astype(np.float32)[np.asarray(indices)]
    frames = []
    for i, p in enumerate(images_paths):
        m = np.concatenate([c2w[i], [[0, 0, 0, 1]]], axis=0)
        frames.append(
            {"file_path": p.as_posix(), "transform_matrix": m.tolist()}
        )
    K = np.asarray(md["K"]).reshape(3, 3).T
    out = {
        "fl_x": K[0, 0], "fl_y": K[0, 0],
        "cx": md["w"] / 2, "cy": md["h"] / 2,
        "w": md["w"], "h": md["h"],
        "camera_model": "PERSPECTIVE",
        "frames": frames,
    }
    (Path(output_dir) / "transforms.json").write_text(json.dumps(out, indent=4))
    return len(frames)


@dataclass
class Record3DToNerfstudioDataset(BaseConverterToNerfstudioDataset):
    """`ns-process-data record3d` — data points at the EXR_RGBD export."""

    num_downscales: int = 3
    max_dataset_size: int = 300

    def main(self) -> None:
        data = Path(self.data)
        rgb_dir = data / "rgb" if (data / "rgb").exists() else data
        images = process_data_utils.list_images(rgb_dir)
        idx = np.arange(len(images))
        if 0 < self.max_dataset_size < len(images):
            idx = np.linspace(0, len(images) - 1, self.max_dataset_size, dtype=int)
            images = [images[i] for i in idx]
        (self.output_dir / "images").mkdir(parents=True, exist_ok=True)
        rel = []
        for i, src in enumerate(images):
            dst = self.output_dir / "images" / f"frame_{i + 1:05d}{src.suffix}"
            shutil.copy(src, dst)
            rel.append(Path("images") / dst.name)
        process_data_utils.downscale_images(
            self.output_dir / "images", self.num_downscales
        )
        n = record3d_to_json(
            rel, data / "metadata.json", self.output_dir, idx
        )
        print(f"registered {n} record3d frames")


# ---------------------------------------------------------------------------
# Metashape
# ---------------------------------------------------------------------------


def metashape_to_json(
    image_filename_map: Dict[str, Path], xml_filename: Path, output_dir: Path,
    verbose: bool = False,
) -> List[str]:
    """(reference metashape_utils.py:35-201)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(xml_filename).getroot()
    chunk = root[0]
    sensors = chunk.find("sensors")
    if sensors is None:
        raise ValueError("no sensors in Metashape XML")

    def find_param(calib, name):
        e = calib.find(name)
        return float(e.text) if e is not None else 0.0

    model_by_type = {
        "frame": "OPENCV", "fisheye": "OPENCV_FISHEYE",
        "spherical": "EQUIRECTANGULAR",
    }
    sensor_dict = {}
    sensor_types = []
    for sensor in sensors:
        calib = sensor.find("calibration")
        if sensor.get("type") != "spherical" and calib is None:
            continue
        sensor_types.append(sensor.get("type"))
        res = sensor.find("resolution")
        s = {"w": int(res.get("width")), "h": int(res.get("height"))}
        if calib is None:
            s.update(fl_x=s["w"] / 2.0, fl_y=s["h"], cx=s["w"] / 2.0, cy=s["h"] / 2.0)
        else:
            f = float(calib.find("f").text)
            s.update(
                fl_x=f, fl_y=f,
                cx=find_param(calib, "cx") + s["w"] / 2.0,
                cy=find_param(calib, "cy") + s["h"] / 2.0,
                k1=find_param(calib, "k1"), k2=find_param(calib, "k2"),
                k3=find_param(calib, "k3"), k4=find_param(calib, "k4"),
                p1=find_param(calib, "p1"), p2=find_param(calib, "p2"),
            )
        sensor_dict[sensor.get("id")] = s
    if not sensor_dict:
        raise ValueError("no calibrated sensor found in Metashape XML")
    if len(set(sensor_types)) > 1:
        raise ValueError("mixed Metashape sensor types are unsupported")
    data = {"camera_model": model_by_type.get(sensor_types[0], "OPENCV")}

    comp_dict = {}
    components = chunk.find("components")
    if components is not None:
        for comp in components:
            tr = comp.find("transform")
            if tr is None:
                continue
            r = tr.find("rotation")
            R = (
                np.array([float(x) for x in r.text.split()]).reshape(3, 3)
                if r is not None else np.eye(3)
            )
            t = tr.find("translation")
            tv = (
                np.array([float(x) for x in t.text.split()])
                if t is not None else np.zeros(3)
            )
            sc = tr.find("scale")
            s = float(sc.text) if sc is not None else 1.0
            m = np.eye(4)
            m[:3, :3] = R
            m[:3, 3] = tv / s
            comp_dict[comp.get("id")] = m

    frames, skipped = [], 0
    for camera in chunk.find("cameras"):
        label = camera.get("label")
        if label not in image_filename_map:
            label = label.split(".")[0]
            if label not in image_filename_map:
                continue
        sid = camera.get("sensor_id")
        tr = camera.find("transform")
        if sid not in sensor_dict or tr is None:
            skipped += 1
            continue
        frame = {"file_path": image_filename_map[label].as_posix()}
        frame.update(sensor_dict[sid])
        m = np.array([float(x) for x in tr.text.split()]).reshape(4, 4)
        cid = camera.get("component_id")
        if cid in comp_dict:
            m = comp_dict[cid] @ m
        m = m[[2, 0, 1, 3], :]
        m[:, 1:3] *= -1
        frame["transform_matrix"] = m.tolist()
        frames.append(frame)
    data["frames"] = frames
    (Path(output_dir) / "transforms.json").write_text(json.dumps(data, indent=4))
    summary = []
    if skipped:
        summary.append(f"{skipped} images skipped (missing pose/calibration).")
    summary.append(f"Final dataset is {len(frames)} frames.")
    return summary


@dataclass
class MetashapeToNerfstudioDataset(BaseConverterToNerfstudioDataset):
    """`ns-process-data metashape --data images/ --xml cameras.xml`."""

    xml: Path = Path("cameras.xml")
    num_downscales: int = 3

    def main(self) -> None:
        images = process_data_utils.list_images(Path(self.data))
        copied = process_data_utils.copy_images(
            self.data, image_dir=self.image_dir,
            num_downscales=self.num_downscales,
        )
        name_map = {
            src.stem: Path("images") / dst.name
            for src, dst in zip(images, copied)
        }
        for line in metashape_to_json(name_map, self.xml, self.output_dir):
            print(line)


# ---------------------------------------------------------------------------
# RealityCapture
# ---------------------------------------------------------------------------


def _rc_rotation(yaw, pitch, roll):
    """(reference realitycapture_utils.py:113-127)."""
    sy, cy = np.sin(np.deg2rad(yaw)), np.cos(np.deg2rad(yaw))
    sp, cp = np.sin(np.deg2rad(pitch)), np.cos(np.deg2rad(pitch))
    sr, cr = np.sin(np.deg2rad(roll)), np.cos(np.deg2rad(roll))
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    ry = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ rx @ ry


def realitycapture_to_json(
    image_filename_map: Dict[str, Path], csv_filename: Path, output_dir: Path,
    verbose: bool = False,
) -> List[str]:
    """(reference realitycapture_utils.py:29-110)."""
    import csv as csv_mod

    from PIL import Image  # host-only: Pillow is not on the card's machine

    data = {"camera_model": "OPENCV", "orientation_override": "none"}
    cameras: Dict[str, list] = {}
    with open(csv_filename, encoding="utf-8") as f:
        for row in csv_mod.DictReader(f):
            for k, v in row.items():
                cameras.setdefault(k, []).append(v)

    frames, missing = [], 0
    for i, name in enumerate(cameras["#name"]):
        base = name.rpartition(".")[0]
        if base not in image_filename_map:
            missing += 1
            continue
        img = np.asarray(Image.open(Path(output_dir) / image_filename_map[base]))
        h, w = img.shape[:2]
        frame = {
            "h": int(h), "w": int(w),
            "file_path": image_filename_map[base].as_posix(),
            "fl_x": float(cameras["f"][i]) * max(w, h) / 36,
            "fl_y": float(cameras["f"][i]) * max(w, h) / 36,
            "cx": float(cameras["px"][i]) / 36.0 + w / 2.0,
            "cy": float(cameras["py"][i]) / 36.0 + h / 2.0,
            "k1": cameras["k1"][i], "k2": cameras["k2"][i],
            "k3": cameras["k3"][i], "k4": cameras["k4"][i],
            "p1": cameras["t1"][i], "p2": cameras["t2"][i],
        }
        m = np.eye(4)
        m[:3, :3] = _rc_rotation(
            -float(cameras["heading"][i]), float(cameras["pitch"][i]),
            float(cameras["roll"][i]),
        )
        m[:3, 3] = [float(cameras["x"][i]), float(cameras["y"][i]),
                    float(cameras["alt"][i])]
        frame["transform_matrix"] = m.tolist()
        frames.append(frame)
    data["frames"] = frames
    (Path(output_dir) / "transforms.json").write_text(json.dumps(data, indent=4))
    summary = []
    if missing:
        summary.append(f"Missing image data for {missing} cameras.")
    summary.append(f"Final dataset is {len(frames)} frames.")
    return summary


@dataclass
class RealityCaptureToNerfstudioDataset(BaseConverterToNerfstudioDataset):
    """`ns-process-data realitycapture --data images/ --csv poses.csv`."""

    csv: Path = Path("poses.csv")
    num_downscales: int = 3

    def main(self) -> None:
        images = process_data_utils.list_images(Path(self.data))
        copied = process_data_utils.copy_images(
            self.data, image_dir=self.image_dir,
            num_downscales=self.num_downscales,
        )
        name_map = {
            src.stem: Path("images") / dst.name
            for src, dst in zip(images, copied)
        }
        for line in realitycapture_to_json(name_map, self.csv, self.output_dir):
            print(line)


# ---------------------------------------------------------------------------
# ODM
# ---------------------------------------------------------------------------


def rodrigues_vec_to_rotation_mat(r: np.ndarray) -> np.ndarray:
    """(reference odm_utils.py:29-46)."""
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def cameras2nerfds(
    image_filename_map: Dict[str, Path], cameras_file: Path, shots_file: Path,
    reconstruction_file: Path, output_dir: Path, verbose: bool = False,
) -> List[str]:
    """(reference odm_utils.py:81-207)."""
    cameras = json.loads(Path(cameras_file).read_text())
    if len(cameras) > 1:
        raise ValueError("only one ODM camera is supported")
    cam = next(iter(cameras.values()))
    model_map = {
        "brown": "OPENCV", "perspective": "OPENCV",
        "fisheye": "OPENCV_FISHEYE", "fisheye_opencv": "OPENCV_FISHEYE",
        "spherical": "EQUIRECTANGULAR", "equirectangular": "EQUIRECTANGULAR",
    }
    if cam["projection_type"] not in model_map:
        raise ValueError(f"unsupported ODM camera {cam['projection_type']}")
    data = {"camera_model": model_map[cam["projection_type"]]}
    w, h = int(cam["width"]), int(cam["height"])
    s = {
        "w": w, "h": h,
        "fl_x": cam.get("focal_x", cam.get("focal")) * max(w, h),
        "fl_y": cam.get("focal_y", cam.get("focal")) * max(w, h),
        "cx": cam["c_x"] + (w - 1.0) / 2.0,
        "cy": cam["c_y"] + (h - 1.0) / 2.0,
    }
    for p in ("k1", "k2", "p1", "p2", "k3"):
        if p in cam:
            s[p] = cam[p]

    shots_dict = {}
    if Path(reconstruction_file).exists():
        recon = json.loads(Path(reconstruction_file).read_text())
        if isinstance(recon, list):
            recon = recon[0]
        for filename, shot in recon.get("shots", {}).items():
            R = rodrigues_vec_to_rotation_mat(np.asarray(shot["rotation"]))
            w2c = np.eye(4)
            w2c[:3, :3] = R
            w2c[:3, 3] = shot["translation"]
            m = np.linalg.inv(w2c)
            m[0:3, 1:3] *= -1
            shots_dict[Path(filename).stem] = m
    else:
        shots = json.loads(Path(shots_file).read_text())["features"]
        for shot in shots:
            props = shot["properties"]
            R = rodrigues_vec_to_rotation_mat(-np.asarray(props["rotation"]))
            m = np.eye(4)
            m[:3, :3] = R
            m[:3, 3] = props["translation"]
            shots_dict[Path(props["filename"]).stem] = m

    frames, skipped = [], 0
    for name, path in image_filename_map.items():
        if name not in shots_dict:
            skipped += 1
            continue
        frame = {"file_path": path.as_posix(), **s,
                 "transform_matrix": shots_dict[name].tolist()}
        frames.append(frame)
    data["frames"] = frames
    (Path(output_dir) / "transforms.json").write_text(json.dumps(data, indent=4))
    summary = []
    if skipped:
        summary.append(f"{skipped} images skipped (missing shot pose).")
    summary.append(f"Final dataset is {len(frames)} frames.")
    return summary


@dataclass
class ODMToNerfstudioDataset(BaseConverterToNerfstudioDataset):
    """`ns-process-data odm` — data points at the ODM project root."""

    num_downscales: int = 3

    def main(self) -> None:
        data = Path(self.data)
        image_dir = data / "images"
        images = process_data_utils.list_images(image_dir)
        copied = process_data_utils.copy_images(
            image_dir, image_dir=self.image_dir,
            num_downscales=self.num_downscales,
        )
        name_map = {
            src.stem: Path("images") / dst.name
            for src, dst in zip(images, copied)
        }
        for line in cameras2nerfds(
            name_map,
            data / "cameras.json",
            data / "odm_report" / "shots.geojson",
            data / "opensfm" / "reconstruction.nerfstudio.json",
            self.output_dir,
        ):
            print(line)


# ---------------------------------------------------------------------------
# Skydio (the ThermalNeRF fork's RGB+IR drone pipeline)
# ---------------------------------------------------------------------------


def _yaw(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])


def _pitch(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


def _roll(a):
    return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])


@dataclass
class SkydioToNerfstudioDataset(ImagesToNerfstudioDataset):
    """`ns-process-data skydio` (reference
    skydio_to_nerfstudio_dataset.py:18-254): reads Skydio XMP metadata via
    exiftool, writes RGB + thermal frames with `is_thermal` flags and
    metadata poses (gimbal-corrected), then optionally refines RGB poses
    with COLMAP."""

    rgb_only: bool = False
    use_quat_poses: bool = False
    coordinate_convention: str = "NED"
    max_num_images: int = -1

    @property
    def thermal_image_dir(self) -> Path:
        return self.output_dir / "images_thermal"

    def main(self) -> None:
        from nerfstudio_thermal_torch.process_data.flir_utils import (
            exiftool_available,
        )

        if not exiftool_available():
            raise RuntimeError(
                "skydio processing requires exiftool on PATH to read XMP "
                "pose metadata"
            )
        import subprocess

        files = process_data_utils.list_images(Path(self.data))
        raw = subprocess.run(
            ["exiftool", "-json", "-G"] + [str(f) for f in files],
            capture_output=True, text=True, check=True,
        ).stdout
        metadata = json.loads(raw)

        self.image_dir.mkdir(parents=True, exist_ok=True)
        self.thermal_image_dir.mkdir(parents=True, exist_ok=True)
        transforms = {"camera_model": "OPENCV", "frames": []}
        n_rgb = n_thermal = 0
        cc = self.coordinate_convention
        for file, md in zip(files, metadata):
            frame = {}
            if "XMP:CameraSource" not in md:
                continue
            frame["is_thermal"] = 1 if md["XMP:CameraSource"] == "INFRARED" else 0
            if frame["is_thermal"] and "APP1:AtmosphericTransAlpha1" not in md:
                continue
            if self.rgb_only and frame["is_thermal"]:
                continue
            if self.use_quat_poses:
                from scipy.spatial.transform import Rotation

                R = Rotation.from_quat([
                    md[f"XMP:CameraOrientationQuat{cc}X"],
                    md[f"XMP:CameraOrientationQuat{cc}Y"],
                    md[f"XMP:CameraOrientationQuat{cc}Z"],
                    md[f"XMP:CameraOrientationQuat{cc}W"],
                ]).as_matrix()
                pitch_cam = 0.0
            else:
                R = (
                    _yaw(np.deg2rad(md["XMP:CameraOrientationNEDYaw"]))
                    @ _pitch(np.deg2rad(md["XMP:CameraOrientationNEDPitch"]))
                    @ _roll(np.deg2rad(md["XMP:CameraOrientationNEDRoll"]))
                )
                pitch_cam = np.pi
            # camera-in-gimbal correction (reference :91-99)
            R = R @ (_yaw(np.deg2rad(270.0)) @ _pitch(pitch_cam) @ _roll(np.pi / 2))
            M = np.eye(4)
            M[:3, :3] = R
            M[:3, 3] = [
                md[f"XMP:CameraPosition{cc}X"],
                md[f"XMP:CameraPosition{cc}Y"],
                md[f"XMP:CameraPosition{cc}Z"],
            ]
            frame["transform_matrix"] = M.tolist()
            frame["fl_x"] = md["XMP:CalibratedFocalLengthX"]
            frame["fl_y"] = md["XMP:CalibratedFocalLengthY"]
            frame["cx"] = md["XMP:CalibratedOpticalCenterX"]
            frame["cy"] = md["XMP:CalibratedOpticalCenterY"]
            k = [float(x) for x in md["XMP:DewarpData"].split(",")]
            frame["k1"], frame["k2"], frame["k3"] = k[:3]
            frame["p1"] = frame["p2"] = 0.0
            frame["w"] = md["File:ImageWidth"]
            frame["h"] = md["File:ImageHeight"]

            if frame["is_thermal"]:
                n_thermal += 1
                dst = self.thermal_image_dir / f"frame_{n_thermal:05d}.jpg"
                frame["file_path"] = f"images_thermal/{dst.name}"
            else:
                n_rgb += 1
                dst = self.image_dir / f"frame_{n_rgb:05d}.jpg"
                frame["file_path"] = f"images/{dst.name}"
            shutil.copy(file, dst)
            transforms["frames"].append(frame)
            if -1 < self.max_num_images <= n_rgb + n_thermal:
                break

        (self.output_dir / "transforms.json").write_text(
            json.dumps(transforms, indent=4)
        )
        print(
            f"skydio: wrote {n_rgb} RGB + {n_thermal} thermal frames to "
            f"{self.output_dir}"
        )
