"""Scene-capture dataparsers (counterpart of
nerfstudio_thermal_tpu/data/dataparsers/scene_parsers.py): ScanNet,
ScanNet++, ARKitScenes, Sitcoms3D, NeRF-OSR, Phototourism, NuScenes and
DyCheck, with the shared pose handling (orient, center, auto-scale).
Image sizes come from the files' headers; ARKitScenes turns its
axis-angle poses into rotations with Rodrigues' formula in numpy; NuScenes
needs the nuscenes devkit, as in the JAX package.
"""

import dataclasses
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from nerfstudio_thermal_torch.cameras.camera_utils import auto_orient_and_center_poses
from nerfstudio_thermal_torch.cameras.cameras import CameraType
from nerfstudio_thermal_torch.data.dataparsers.base_dataparser import (
    DataParser,
    DataParserConfig,
    DataparserOutputs,
    make_cameras,
)
from nerfstudio_thermal_torch.data.datasets import image_size


def fraction_split_indices(n: int, train_split_fraction: float, split: str):
    """Equally-spaced train indices + remaining eval (the pattern every
    reference scene parser repeats, e.g. scannet_dataparser.py:100-116)."""
    num_train = math.ceil(n * train_split_fraction)
    i_train = np.linspace(0, n - 1, num_train, dtype=int)
    i_eval = np.setdiff1d(np.arange(n), i_train)
    return i_train if split == "train" else i_eval


def orient_center_scale(
    poses: np.ndarray,  # [N, 4, 4] or [N, 3, 4]
    orientation_method: str = "none",
    center_method: str = "poses",
    auto_scale: bool = True,
    scale_factor: float = 1.0,
):
    """Returns (poses [N, 3, 4], transform [3, 4], applied scale)."""
    poses34, transform = auto_orient_and_center_poses(
        poses[:, :3, :4], method=orientation_method, center_method=center_method
    )
    poses34 = np.array(poses34)
    s = 1.0
    if auto_scale:
        s /= float(np.max(np.abs(poses34[:, :3, 3]))) or 1.0
    s *= scale_factor
    poses34[:, :3, 3] *= s
    return poses34.astype(np.float32), np.asarray(transform, np.float32), s


def _perspective_cameras(poses, fx, fy, cx, cy, w, h):
    n = len(poses)
    as_arr = lambda v: (
        np.full((n,), v, np.float32) if np.isscalar(v) else np.asarray(v, np.float32)
    )
    return make_cameras(
        camera_to_worlds=np.asarray(poses, np.float32),
        fx=as_arr(fx), fy=as_arr(fy), cx=as_arr(cx), cy=as_arr(cy),
        width=(
            np.full((n,), w, np.int32) if np.isscalar(w)
            else np.asarray(w, np.int32)
        ),
        height=(
            np.full((n,), h, np.int32) if np.isscalar(h)
            else np.asarray(h, np.int32)
        ),
        distortion_params=np.zeros((n, 6), np.float32),
        camera_type=np.full((n,), CameraType.PERSPECTIVE.value, np.int32),
    )


# ---------------------------------------------------------------------------
# ScanNet
# ---------------------------------------------------------------------------


@dataclass
class ScanNetDataParserConfig(DataParserConfig):
    data: Path = Path("data/scannet/scene0423_02")
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    depth_unit_scale_factor: float = 1e-3


class ScanNet(DataParser):
    config: ScanNetDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        data = Path(self.config.data)
        by_idx = lambda p: int(p.name.split(".")[0])
        imgs = sorted((data / "color").iterdir(), key=by_idx)
        depths = sorted((data / "depth").iterdir(), key=by_idx)
        pose_files = sorted((data / "pose").iterdir(), key=by_idx)
        K = np.loadtxt(data / "intrinsic" / "intrinsic_color.txt")

        w, h = image_size(imgs[0])

        image_filenames, depth_filenames, poses = [], [], []
        for img, dep, pf in zip(imgs, depths, pose_files):
            pose = np.loadtxt(pf).reshape(4, 4)
            if not np.isfinite(pose).all():
                continue
            pose[:3, 1] *= -1
            pose[:3, 2] *= -1
            poses.append(pose)
            image_filenames.append(img)
            depth_filenames.append(dep)

        poses = np.stack(poses).astype(np.float32)
        poses34, transform, scale = orient_center_scale(
            poses, "none", self.config.center_method,
            self.config.auto_scale_poses, self.config.scale_factor,
        )
        idx = fraction_split_indices(
            len(image_filenames), self.config.train_split_fraction, split
        )
        s = self.config.scene_scale
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=_perspective_cameras(
                poses34[idx], K[0, 0], K[1, 1], K[0, 2], K[1, 2], w, h
            ),
            scene_box=np.array([[-s] * 3, [s] * 3], np.float32),
            dataparser_scale=scale,
            dataparser_transform=transform,
            metadata={
                "depth_filenames": [depth_filenames[i] for i in idx],
                "depth_unit_scale_factor": self.config.depth_unit_scale_factor,
            },
        )


# ---------------------------------------------------------------------------
# ScanNet++
# ---------------------------------------------------------------------------


@dataclass
class ScanNetppDataParserConfig(DataParserConfig):
    data: Path = Path("scannetpp/410c470782")
    scale_factor: float = 1.0
    scene_scale: float = 1.5
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    images_dir: Path = Path("dslr/resized_images")
    masks_dir: Path = Path("dslr/resized_anon_masks")
    transforms_path: Path = Path("dslr/nerfstudio/transforms.json")


class ScanNetpp(DataParser):
    config: ScanNetppDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        cfg = self.config
        data = Path(cfg.data)
        meta = json.loads((data / cfg.transforms_path).read_text())
        data_dir = data / cfg.images_dir
        mask_dir = data / cfg.masks_dir

        frames = meta["frames"] + meta.get("test_frames", [])
        test_set = {f["file_path"] for f in meta.get("test_frames", [])}
        frames.sort(key=lambda x: x["file_path"])

        image_filenames, mask_filenames, poses = [], [], []
        i_train, i_eval = [], []
        for i, fr in enumerate(frames):
            image_filenames.append(data_dir / fr["file_path"])
            poses.append(np.asarray(fr["transform_matrix"], np.float32))
            if meta.get("has_mask", True) and "mask_path" in fr:
                mask_filenames.append(mask_dir / fr["mask_path"])
            (i_eval if fr["file_path"] in test_set else i_train).append(i)

        poses = np.stack(poses)
        orientation = meta.get("orientation_override", cfg.orientation_method)
        poses34, transform, scale = orient_center_scale(
            poses, orientation, cfg.center_method, cfg.auto_scale_poses,
            cfg.scale_factor,
        )
        idx = np.asarray(i_train if split == "train" else i_eval, int)
        s = cfg.scene_scale
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=_perspective_cameras(
                poses34[idx],
                float(meta["fl_x"]), float(meta["fl_y"]),
                float(meta["cx"]), float(meta["cy"]),
                int(meta["w"]), int(meta["h"]),
            ),
            scene_box=np.array([[-s] * 3, [s] * 3], np.float32),
            mask_filenames=(
                [mask_filenames[i] for i in idx] if mask_filenames else None
            ),
            dataparser_scale=scale,
            dataparser_transform=transform,
        )


# ---------------------------------------------------------------------------
# ARKitScenes
# ---------------------------------------------------------------------------


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix (what cv2.Rodrigues gives)."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.cos(theta) * np.eye(3) + (1.0 - np.cos(theta)) * np.outer(k, k) + np.sin(theta) * kx


def traj_string_to_matrix(line: str):
    """(reference arkitscenes_dataparser.py:32-57): timestamp + axis-angle +
    translation -> (ts, c2w)."""
    tok = line.split()
    ts = tok[0]
    R = rodrigues(np.asarray([float(t) for t in tok[1:4]]))
    ext = np.eye(4)
    ext[:3, :3] = R
    ext[:3, 3] = [float(t) for t in tok[4:7]]
    return ts, np.linalg.inv(ext)


@dataclass
class ARKitScenesDataParserConfig(DataParserConfig):
    data: Path = Path("data/ARKitScenes/3dod/Validation/41069021")
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    depth_unit_scale_factor: float = 1e-3


class ARKitScenes(DataParser):
    config: ARKitScenesDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        cfg = self.config
        data = Path(cfg.data)
        vid = data.name
        image_dir = data / f"{vid}_frames" / "lowres_wide"
        depth_dir = data / f"{vid}_frames" / "lowres_depth"
        intr_dir = data / f"{vid}_frames" / "lowres_wide_intrinsics"
        traj = (data / f"{vid}_frames" / "lowres_wide.traj").read_text().splitlines()

        frame_ids = sorted(
            p.name.split(".png")[0].split("_")[1] for p in depth_dir.iterdir()
        )
        pose_map = {}
        for line in traj:
            ts, Rt = traj_string_to_matrix(line)
            pose_map[f"{round(float(ts), 3):.3f}"] = Rt

        def get_pose(fid):
            if fid in pose_map:
                p = np.array(pose_map[fid])
            else:
                p = None
                for k in pose_map:
                    if abs(float(fid) - float(k)) < 0.005:
                        p = np.array(pose_map[k])
                assert p is not None, f"no pose for frame {fid}"
            p[0:3, 1:3] *= -1
            p = p[[1, 0, 2, 3], :]
            p[2, :] *= -1
            return p

        def get_K(fid):
            for cand in (fid, f"{float(fid) - 0.001:.3f}", f"{float(fid) + 0.001:.3f}"):
                f = intr_dir / f"{vid}_{cand}.pincam"
                if f.exists():
                    _, _, fx, fy, hw, hh = np.loadtxt(f)
                    return np.array([[fx, 0, hw], [0, fy, hh], [0, 0, 1]])
            raise FileNotFoundError(f"no intrinsics for frame {fid}")

        w, h = np.loadtxt(sorted(intr_dir.iterdir())[0])[:2]
        image_filenames, depth_filenames, Ks, poses = [], [], [], []
        for fid in frame_ids:
            Ks.append(get_K(fid))
            poses.append(get_pose(fid))
            image_filenames.append(image_dir / f"{vid}_{fid}.png")
            depth_filenames.append(depth_dir / f"{vid}_{fid}.png")

        poses = np.stack(poses).astype(np.float32)
        Ks = np.stack(Ks)
        poses34, transform, scale = orient_center_scale(
            poses, "none", cfg.center_method, cfg.auto_scale_poses,
            cfg.scale_factor,
        )
        idx = fraction_split_indices(
            len(image_filenames), cfg.train_split_fraction, split
        )
        s = cfg.scene_scale
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=_perspective_cameras(
                poses34[idx], Ks[idx, 0, 0], Ks[idx, 1, 1],
                Ks[idx, 0, 2], Ks[idx, 1, 2], int(w), int(h),
            ),
            scene_box=np.array([[-s] * 3, [s] * 3], np.float32),
            dataparser_scale=scale,
            dataparser_transform=transform,
            metadata={
                "depth_filenames": [depth_filenames[i] for i in idx],
                "depth_unit_scale_factor": cfg.depth_unit_scale_factor,
            },
        )


# ---------------------------------------------------------------------------
# Sitcoms3D
# ---------------------------------------------------------------------------


@dataclass
class Sitcoms3DDataParserConfig(DataParserConfig):
    data: Path = Path("data/sitcoms3d/TBBT-big_living_room")
    include_semantics: bool = True
    downscale_factor: int = 4
    scene_scale: float = 2.0


class Sitcoms3D(DataParser):
    config: Sitcoms3DDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        cfg = self.config
        data = Path(cfg.data)
        meta = json.loads((data / "cameras.json").read_text())
        frames = meta["frames"]
        bbox = np.asarray(meta["bbox"], np.float32)

        suffix = f"_{cfg.downscale_factor}" if cfg.downscale_factor != 1 else ""
        images_folder = f"images{suffix}"
        seg_folder = f"segmentations{suffix}"

        image_filenames, fx, fy, cx, cy, poses = [], [], [], [], [], []
        for fr in frames:
            image_filenames.append(data / images_folder / fr["image_name"])
            K = np.asarray(fr["intrinsics"])
            fx.append(K[0, 0]); fy.append(K[1, 1])
            cx.append(K[0, 2]); cy.append(K[1, 2])
            poses.append(np.asarray(fr["camtoworld"], np.float32)[:3])
        poses = np.stack(poses)

        # z-up rotation (reference :93-96)
        rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
        poses = rot[None] @ poses
        bbox = (rot @ bbox.T).T

        center = (bbox[0] + bbox[1]) / 2.0
        bbox = bbox - center
        poses[..., 3] -= center
        lengths = bbox[1] - bbox[0]
        scale = cfg.scene_scale / float(lengths.max())
        bbox *= scale
        poses[..., 3] *= scale

        metadata = {}
        if cfg.include_semantics:
            sem_files = [
                Path(
                    str(f).replace(f"/{images_folder}/", f"/{seg_folder}/thing/")
                ).with_suffix(".png")
                for f in image_filenames
            ]
            pano = json.loads((data / "panoptic_classes.json").read_text())
            metadata["semantics"] = {
                "filenames": sem_files,
                "classes": pano["thing"],
                "colors": np.asarray(pano["thing_colors"], np.float32) / 255.0,
                "mask_classes": ["person"],
            }

        cams = _perspective_cameras(
            poses, np.asarray(fx), np.asarray(fy), np.asarray(cx),
            np.asarray(cy),
            # sitcoms3d cameras.json stores full-res intrinsics; infer sizes
            # from 2*principal point like the reference Cameras default
            (2 * np.asarray(cx)).astype(int), (2 * np.asarray(cy)).astype(int),
        ).rescale_output_resolution(1.0 / cfg.downscale_factor)
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cams,
            scene_box=np.sort(bbox, axis=0),
            dataparser_scale=scale,
            metadata=metadata,
        )


# ---------------------------------------------------------------------------
# NeRF-OSR
# ---------------------------------------------------------------------------


@dataclass
class NeRFOSRDataParserConfig(DataParserConfig):
    data: Path = Path("data/NeRF-OSR/Data")
    scene: str = "stjacob"
    scene_scale: float = 1.0
    scale_factor: float = 1.0
    use_masks: bool = False
    orientation_method: str = "vertical"
    center_method: str = "focus"
    auto_scale_poses: bool = True


class NeRFOSR(DataParser):
    config: NeRFOSRDataParserConfig

    @staticmethod
    def _find(d: Path, exts):
        out = []
        for e in exts:
            out += sorted(Path(d).glob(e))
        return out

    @classmethod
    def _camera_params(cls, scene_dir: Path, split: str):
        split_dir = scene_dir / split
        intr = [np.loadtxt(f).reshape(4, 4) for f in cls._find(split_dir / "intrinsics", ["*.txt"])]
        poses = []
        for f in cls._find(split_dir / "pose", ["*.txt"]):
            p = np.loadtxt(f).reshape(4, 4)
            p[0:3, 1:3] *= -1  # OpenCV -> nerfstudio
            poses.append(p)
        return np.stack(intr), np.stack(poses)

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        cfg = self.config
        split = "validation" if split == "val" else split
        sub = "final_clean" if cfg.scene == "trevi" else "final"
        scene_dir = Path(cfg.data) / cfg.scene / sub

        Ks, poses, counts = [], [], {}
        for sp in ("train", "validation", "test"):
            K, P = self._camera_params(scene_dir, sp)
            Ks.append(K); poses.append(P); counts[sp] = len(P)
        Ks = np.concatenate(Ks); poses = np.concatenate(poses)
        poses34, transform, scale = orient_center_scale(
            poses, cfg.orientation_method, cfg.center_method,
            cfg.auto_scale_poses, cfg.scale_factor,
        )
        start = {"train": 0, "validation": counts["train"],
                 "test": counts["train"] + counts["validation"]}[split]
        n = counts[split]
        idx = np.arange(start, start + n)

        split_dir = scene_dir / split
        image_filenames = self._find(split_dir / "rgb", ["*.png", "*.jpg", "*.JPG", "*.PNG"])
        w, h = image_size(image_filenames[0])
        mask_filenames = None
        if cfg.use_masks:
            mask_filenames = self._find(split_dir / "mask", ["*.png", "*.jpg"])
        s = cfg.scene_scale
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=_perspective_cameras(
                poses34[idx], Ks[idx, 0, 0], Ks[idx, 1, 1],
                Ks[idx, 0, 2], Ks[idx, 1, 2], w, h,
            ),
            scene_box=np.array([[-s] * 3, [s] * 3], np.float32),
            mask_filenames=mask_filenames,
            dataparser_scale=scale,
            dataparser_transform=transform,
        )


# ---------------------------------------------------------------------------
# Phototourism
# ---------------------------------------------------------------------------


@dataclass
class PhototourismDataParserConfig(DataParserConfig):
    data: Path = Path("data/phototourism/brandenburg-gate")
    scale_factor: float = 3.0
    alpha_color: str = "white"
    train_split_fraction: float = 0.9
    scene_scale: float = 1.0
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True


class Phototourism(DataParser):
    config: PhototourismDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        from nerfstudio_thermal_torch.data.utils.colmap_parsing_utils import (
            qvec2rotmat,
            read_cameras_binary,
            read_images_binary,
        )

        cfg = self.config
        data = Path(cfg.data)
        cams = read_cameras_binary(data / "dense/sparse/cameras.bin")
        imgs = read_images_binary(data / "dense/sparse/images.bin")

        poses, fxs, fys, cxs, cys, ws, hs, image_filenames = (
            [], [], [], [], [], [], [], []
        )
        for _id, cam in cams.items():
            img = imgs[_id]
            assert cam.model == "PINHOLE", "phototourism expects PINHOLE"
            w2c = np.eye(4)
            w2c[:3, :3] = qvec2rotmat(img.qvec)
            w2c[:3, 3] = img.tvec
            c2w = np.linalg.inv(w2c)
            c2w[..., 1:3] *= -1  # OpenCV -> nerfstudio
            poses.append(c2w)
            fxs.append(cam.params[0]); fys.append(cam.params[1])
            cxs.append(cam.params[2]); cys.append(cam.params[3])
            ws.append(cam.width); hs.append(cam.height)
            image_filenames.append(data / "dense/images" / img.name)

        poses = np.stack(poses).astype(np.float32)
        poses34, transform, scale = orient_center_scale(
            poses, cfg.orientation_method, cfg.center_method,
            cfg.auto_scale_poses, cfg.scale_factor,
        )
        idx = fraction_split_indices(
            len(image_filenames), cfg.train_split_fraction, split
        )
        s = cfg.scene_scale
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=_perspective_cameras(
                poses34[idx], np.asarray(fxs)[idx], np.asarray(fys)[idx],
                np.asarray(cxs)[idx], np.asarray(cys)[idx],
                np.asarray(ws)[idx], np.asarray(hs)[idx],
            ),
            scene_box=np.array([[-s] * 3, [s] * 3], np.float32),
            dataparser_scale=scale,
            dataparser_transform=transform,
        )


# ---------------------------------------------------------------------------
# NuScenes (gated on the nuscenes devkit)
# ---------------------------------------------------------------------------


@dataclass
class NuScenesDataParserConfig(DataParserConfig):
    data: Path = Path("scene-0103")
    data_dir: Path = Path("/mnt/local/NuScenes")
    version: str = "v1.0-mini"
    cameras: Tuple[str, ...] = ("FRONT",)
    mask_dir: Optional[Path] = None
    train_split_fraction: float = 0.9
    verbose: bool = False


class NuScenes(DataParser):
    config: NuScenesDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        try:
            from nuscenes.nuscenes import NuScenes as NuScenesDatabase
        except ImportError as e:
            raise ImportError(
                "the `nuscenes` devkit is required for nuscenes-data "
                "(pip install nuscenes-devkit); it is not baked into this "
                "image"
            ) from e
        from pyquaternion import Quaternion  # ships with the devkit

        cfg = self.config
        nusc = NuScenesDatabase(
            version=cfg.version, dataroot=str(Path(cfg.data_dir).absolute()),
            verbose=cfg.verbose,
        )
        cameras = ["CAM_" + c for c in cfg.cameras]
        assert len(cameras) == 1, "multi-camera nuscenes not supported yet"
        samples = [
            s for s in nusc.sample
            if nusc.get("scene", s["scene_token"])["name"] == str(cfg.data)
        ]
        samples.sort(key=lambda x: (x["scene_token"], x["timestamp"]))

        T1 = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]])
        image_filenames, Ks, poses = [], [], []
        for sample in samples:
            for camera in cameras:
                cd = nusc.get("sample_data", sample["data"][camera])
                cs = nusc.get("calibrated_sensor", cd["calibrated_sensor_token"])
                ep = nusc.get("ego_pose", cd["ego_pose_token"])

                def rt_to_pose(rot, trans):
                    m = np.eye(4)
                    m[:3, :3] = Quaternion(rot).rotation_matrix
                    m[:3, 3] = trans
                    return m

                pose = rt_to_pose(ep["rotation"], ep["translation"]) @ rt_to_pose(
                    cs["rotation"], cs["translation"]
                )
                pose = T1 @ pose
                pose[0:3, 1:3] *= -1
                poses.append(pose)
                Ks.append(np.asarray(cs["camera_intrinsic"]))
                image_filenames.append(
                    Path(cfg.data_dir) / cd["filename"]
                )

        poses = np.stack(poses).astype(np.float32)
        Ks = np.stack(Ks)
        # center + scale like the reference (:158-166)
        poses[:, :3, 3] -= poses[:, :3, 3].mean(0)
        poses[:, :3, 3] /= np.abs(poses[:, :3, 3]).max() or 1.0
        idx = fraction_split_indices(
            len(image_filenames), cfg.train_split_fraction, split
        )
        return DataparserOutputs(
            image_filenames=[image_filenames[i] for i in idx],
            cameras=_perspective_cameras(
                poses[idx, :3, :4], Ks[idx, 0, 0], Ks[idx, 1, 1],
                Ks[idx, 0, 2], Ks[idx, 1, 2], 1600, 900,
            ),
            scene_box=np.array([[-1, -1, -1], [1, 1, 1]], np.float32),
        )


# ---------------------------------------------------------------------------
# DyCheck (iphone subset)
# ---------------------------------------------------------------------------


@dataclass
class DycheckDataParserConfig(DataParserConfig):
    data: Path = Path("data/iphone/mochi-high-five")
    scale_factor: float = 5.0
    alpha_color: str = "white"
    downscale_factor: int = 1
    scene_box_bound: float = 1.5


class Dycheck(DataParser):
    config: DycheckDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs):
        cfg = self.config
        data = Path(cfg.data)
        scene = json.loads((data / "scene.json").read_text())
        center = np.asarray(scene["center"], np.float32)
        scale = float(scene["scale"])
        far = float(scene["far"])

        dataset = json.loads((data / "dataset.json").read_text())
        metadata = json.loads((data / "metadata.json").read_text())
        all_time_ids = np.array(
            [metadata[k]["warp_id"] for k in dataset["ids"]], np.uint32
        )

        splits_dir = data / "splits"
        split_name = split if (splits_dir / f"{split}.json").exists() else "train"
        sd = json.loads((splits_dir / f"{split_name}.json").read_text())
        frame_names = list(sd["frame_names"])
        time_ids = np.asarray(sd["time_ids"])
        if split != "train" and len(frame_names) == 0:
            sd = json.loads((splits_dir / "train.json").read_text())
            frame_names = list(sd["frame_names"])[:1]
            time_ids = np.asarray(sd["time_ids"])[:1]

        # scene scaled so far plane fills the box (reference :228-231)
        sf = cfg.scene_box_bound / 4 / (scale * far)
        d = cfg.downscale_factor

        image_filenames, depth_filenames = [], []
        poses, fx, fy, cx, cy, ws, hs, times = [], [], [], [], [], [], [], []
        for i, frame in enumerate(frame_names):
            image_filenames.append(data / f"rgb/{d}x/{frame}.png")
            depth_filenames.append(data / f"processed_depth/{d}x/{frame}.npy")
            cj = json.loads((data / f"camera/{frame}.json").read_text())
            R = np.asarray(cj["orientation"]).T
            position = np.asarray(cj["position"]) - center
            position *= scale * sf
            pose = np.zeros((3, 4), np.float32)
            pose[:3, :3] = R
            pose[:3, 3] = position
            pose[0:3, 1:3] *= -1
            pose = pose[[1, 0, 2], :]
            pose[2, :] *= -1
            pose = pose[[1, 2, 0], :]
            poses.append(pose)
            fx.append(cj["focal_length"] / d)
            fy.append(cj["focal_length"] * cj["pixel_aspect_ratio"] / d)
            cx.append(cj["principal_point"][0] / d)
            cy.append(cj["principal_point"][1] / d)
            ws.append(cj["image_size"][0] // d)
            hs.append(cj["image_size"][1] // d)
            times.append(time_ids[i] / max(all_time_ids.max(), 1))

        b = cfg.scene_box_bound
        cams = _perspective_cameras(
            np.stack(poses), np.asarray(fx), np.asarray(fy), np.asarray(cx),
            np.asarray(cy), np.asarray(ws), np.asarray(hs),
        )
        cams = dataclasses.replace(cams, times=torch.as_tensor(np.asarray(times, np.float32)))
        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cams,
            scene_box=np.array([[-b] * 3, [b] * 3], np.float32),
            dataparser_scale=scale * sf,
            metadata={
                "depth_filenames": depth_filenames,
                "depth_unit_scale_factor": 1.0,
            },
        )
