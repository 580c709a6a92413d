"""The port's sixteen dataparsers against their JAX twins, on the CPU.

Each parser reads the same fixture in both packages (written here with
Pillow as tests/data/test_*parsers.py write theirs, PNG or JPEG, or the
committed COLMAP scene of tests/data/jpeg/colmap_sphere) for every split
it has; the outputs must agree: image and mask filenames, every Cameras
field (rtol 1e-6, atol 1e-6: both sides hold float32 from the same
float64 math; integer fields exact), scene box, dataparser transform and
scale (the same tolerance), and metadata (paths and lists exact, arrays as
the cameras). Also:
- the COLMAP binary readers (cameras.bin, images.bin, points3D.bin) and
  `qvec2rotmat` / `parse_colmap_camera_params` against JAX's (exact);
- `build_dataparser` gives the same parser class for every registry key
  (NuScenes raises the same ImportError without the nuscenes devkit);
- the `camera_res_scale_factor` hazard, pinned: the data manager's images
  shrink with the factor, its cameras do not (as in the JAX package).
"""

import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.configs import dataparser_configs as jax_registry
from nerfstudio_thermal_tpu.data.datamanagers import VanillaDataManager as JaxDataManager
from nerfstudio_thermal_tpu.data.datamanagers import VanillaDataManagerConfig as JaxDataManagerConfig
from nerfstudio_thermal_tpu.data.utils import colmap_parsing_utils as jax_colmap
from nerfstudio_thermal_tpu.process_data.colmap_utils import parse_colmap_camera_params as jax_parse_camera

from nerfstudio_thermal_torch.configs import dataparser_configs as registry
from nerfstudio_thermal_torch.data.datamanagers import VanillaDataManager, VanillaDataManagerConfig
from nerfstudio_thermal_torch.data.utils import colmap_parsing_utils as colmap
from tests.fixtures import look_at, make_synthetic_rgbt_dataset
from tests.test_all_methods_train import make_blender_fixture, make_ingp_fixture

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
TOL = dict(rtol=1e-6, atol=1e-6)
CAMERA_FIELDS = ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height", "distortion_params", "camera_type",
                 "times")


def _image(path: Path, hw=(8, 10), seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (*hw, 3), np.uint8)).save(path)


def _compare(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _compare(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], (str, Path)):
        assert [str(v) for v in got] == [str(v) for v in want], where
    elif want is None or isinstance(want, (str, bool, Path)) or (isinstance(want, list) and not want):
        assert got == want, where
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, where
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), err_msg=where, **TOL)


def assert_outputs_equal(port, ref):
    assert [str(p) for p in port.image_filenames] == [str(p) for p in ref.image_filenames]
    for name in CAMERA_FIELDS:
        got, want = getattr(port.cameras, name), getattr(ref.cameras, name)
        if want is None:
            assert got is None, name
            continue
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype.kind == want.dtype.kind, name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    _compare(port.scene_box, ref.scene_box, "scene_box")
    _compare(port.dataparser_transform, ref.dataparser_transform, "dataparser_transform")
    assert port.dataparser_scale == pytest.approx(ref.dataparser_scale, rel=1e-6)
    _compare(port.mask_filenames, ref.mask_filenames, "mask_filenames")
    _compare(port.metadata, ref.metadata, "metadata")


# ---- fixtures, one writer per parser -------------------------------------


def _colmap_binaries(sparse: Path, n=4):
    sparse.mkdir(parents=True, exist_ok=True)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(1, n + 1):
            f.write(struct.pack("<iiQQ", i, 1, 10, 8))  # PINHOLE
            f.write(struct.pack("<dddd", 50.0 + i, 51.0, 5.0, 4.0))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(1, n + 1):
            q = np.array([1.0, 0.1 * i, -0.05 * i, 0.02])
            q /= np.linalg.norm(q)
            f.write(struct.pack("<idddddddi", i, *q, 0.1 * i, 0.2, -0.3 * i, i))
            f.write(f"img{i}.jpg".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<ddqddq", 1.5, 2.5, 7, 3.0, 4.0, -1))
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for pid in (7, 9):
            f.write(struct.pack("<QdddBBBd", pid, 0.1 * pid, -0.2, 0.3, 10, 20, 30, 0.5))
            f.write(struct.pack("<Q", 2))
            f.write(struct.pack("<iiii", 1, 0, 2, 1))


def fx_blender(root):
    return make_blender_fixture(root, n=4)


def fx_dnerf(root):
    make_blender_fixture(root, n=4)
    for split in ("train", "val", "test"):
        meta = json.loads((root / f"transforms_{split}.json").read_text())
        for i, frame in enumerate(meta["frames"]):
            frame["time"] = i / 3
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))
    return root


def fx_ingp(root):
    return make_ingp_fixture(root, n=6)


def fx_ingp_jpeg_fov(root):
    """JPEG frames, no w / h in the file (sizes from the JPEG header), a
    y field of view, a fisheye flag, distortion and masks."""
    frames = []
    for i in range(5):
        _image(root / "images" / f"f_{i}.jpg", hw=(12, 16), seed=i)
        c2w = look_at(2.5 * np.array([np.cos(i), np.sin(i), 0.3]))
        frames.append({"file_path": f"images/f_{i}.jpg", "transform_matrix": c2w.tolist(),
                       "mask_path": f"masks/f_{i}.png"})
    meta = {"x_fov": 50.0, "y_fov": 40.0, "aabb_scale": 4, "k1": 0.01, "p2": -0.002, "is_fisheye": True,
            "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def fx_nerfstudio(root):
    return make_synthetic_rgbt_dataset(root, num_pairs=3)


def fx_minimal(root):
    names = []
    for i in range(3):
        _image(root / f"img_{i}.png", seed=i)
        names.append(f"img_{i}.png")
    c2w = np.tile(np.eye(4), (3, 1, 1)).astype(np.float32)
    c2w[:, 0, 3] = np.arange(3)
    np.savez(root / "train.npz", image_filenames=np.array(names), cameras_to_worlds=c2w, fx=8.0, cx=5.0,
             scene_box=np.array([[-2, -2, -2], [2, 2, 2]], np.float32))
    np.savez(root / "val.npz", image_filenames=np.array(names[:1]), cameras_to_worlds=c2w[:1],
             width=np.asarray(10), height=np.asarray(8))
    return root


def fx_sdfstudio(root):
    K = [[50.0, 0, 5, 0], [0, 52.0, 4, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    frames = []
    for i in range(5):
        _image(root / f"im_{i}.png", seed=i)
        np.save(root / f"depth_{i}.npy", np.full((8, 10), 1.0 + i, np.float32))
        np.save(root / f"normal_{i}.npy", np.full((3, 8, 10), 0.25, np.float32))
        c2w = look_at(2.0 * np.array([np.cos(i), np.sin(i), 0.5]))
        frames.append({"rgb_path": f"im_{i}.png", "intrinsics": K, "camtoworld": c2w.tolist(),
                       "mono_depth_path": f"depth_{i}.npy", "mono_normal_path": f"normal_{i}.npy",
                       "foreground_mask": f"mask_{i}.png"})
    meta = {"height": 8, "width": 10, "scene_box": {"aabb": [[-1, -1, -1], [1, 1, 1]]}, "frames": frames,
            "has_mono_prior": True}
    (root / "meta_data.json").write_text(json.dumps(meta))
    return root


def fx_scannet(root):
    for d in ("color", "depth", "pose", "intrinsic"):
        (root / d).mkdir(parents=True)
    K = np.array([[50.0, 0, 5, 0], [0, 50, 4, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt", K)
    for i in range(7):
        _image(root / "color" / f"{i}.jpg", seed=i)
        _image(root / "depth" / f"{i}.png", seed=i)
        pose = look_at(2.0 * np.array([np.cos(i), np.sin(i), 0.4]))
        if i == 6:
            pose[1, 3] = np.inf  # skipped
        np.savetxt(root / "pose" / f"{i}.txt", pose)
    return root


def fx_scannetpp(root):
    img_dir = root / "dslr" / "resized_images"
    (root / "dslr" / "nerfstudio").mkdir(parents=True)
    frames, test_frames = [], []
    for i in range(5):
        _image(img_dir / f"f{i}.jpg", seed=i)
        fr = {"file_path": f"f{i}.jpg", "transform_matrix": look_at(2.0 * np.array([np.cos(i), 1.0, 0.3])).tolist(),
              "mask_path": f"f{i}.png"}
        (test_frames if i >= 4 else frames).append(fr)
    meta = {"frames": frames, "test_frames": test_frames, "fl_x": 60.0, "fl_y": 61.0, "cx": 5.0, "cy": 4.0,
            "w": 10, "h": 8}
    (root / "dslr" / "nerfstudio" / "transforms.json").write_text(json.dumps(meta))
    return root


def fx_arkitscenes(root):
    scene = root / "41069021"
    vid = scene.name
    base = scene / f"{vid}_frames"
    for d in ("lowres_wide", "lowres_depth", "lowres_wide_intrinsics"):
        (base / d).mkdir(parents=True)
    lines = []
    for i in range(4):
        ts = f"{i + 0.1:.3f}"
        _image(base / "lowres_wide" / f"{vid}_{ts}.png", seed=i)
        _image(base / "lowres_depth" / f"{vid}_{ts}.png", seed=i)
        np.savetxt(base / "lowres_wide_intrinsics" / f"{vid}_{ts}.pincam", np.array([[10, 8, 40.0 + i, 41.0, 5.0, 4.0]]))
        lines.append(f"{ts} {0.1 * i} {-0.2} {0.05 * i + 0.01} {0.1 * i} 0.0 0.5")
    (base / "lowres_wide.traj").write_text("\n".join(lines))
    return scene


def fx_sitcoms3d(root):
    frames = []
    for i in range(3):
        _image(root / "images_4" / f"im{i}.jpg", seed=i)
        c2w = np.eye(4)
        c2w[0, 3] = i * 0.5
        frames.append({"image_name": f"im{i}.jpg", "intrinsics": [[80.0, 0, 40.0], [0, 80.0, 30.0], [0, 0, 1]],
                       "camtoworld": c2w.tolist()})
    (root / "cameras.json").write_text(json.dumps({"frames": frames, "bbox": [[-2, -1, -1], [2, 1, 1]]}))
    (root / "panoptic_classes.json").write_text(json.dumps(
        {"thing": ["person", "sofa"], "thing_colors": [[255, 0, 0], [0, 255, 0]]}))
    return root


def fx_nerfosr(root):
    scene = root / "stjacob" / "final"
    rng = np.random.default_rng(0)
    for sp, n in (("train", 4), ("validation", 2), ("test", 2)):
        for d in ("intrinsics", "pose", "rgb"):
            (scene / sp / d).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            K = np.eye(4)
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 50 + i, 50, 5, 4
            np.savetxt(scene / sp / "intrinsics" / f"{i:02d}.txt", K.reshape(-1))
            pose = look_at(rng.uniform(1, 2, 3))
            np.savetxt(scene / sp / "pose" / f"{i:02d}.txt", pose.reshape(-1))
            _image(scene / sp / "rgb" / f"{i:02d}.png", seed=i)
    return root


def fx_phototourism(root):
    _colmap_binaries(root / "dense" / "sparse")
    for i in range(1, 5):
        _image(root / "dense" / "images" / f"img{i}.jpg", seed=i)
    return root


def fx_colmap(root):
    _colmap_binaries(root / "colmap" / "sparse" / "0")
    for i in range(1, 5):
        _image(root / "images" / f"img{i}.jpg", seed=i)
    return root


def fx_dycheck(root):
    (root / "splits").mkdir(parents=True)
    (root / "camera").mkdir()
    names = [f"0_{i:05d}" for i in range(3)]
    (root / "scene.json").write_text(json.dumps({"center": [0.1, 0, 0], "scale": 1.5, "near": 0.1, "far": 2.0}))
    (root / "dataset.json").write_text(json.dumps({"ids": names}))
    (root / "metadata.json").write_text(json.dumps({n: {"warp_id": i, "camera_id": 0} for i, n in enumerate(names)}))
    (root / "splits" / "train.json").write_text(json.dumps({"frame_names": names, "time_ids": list(range(3))}))
    (root / "splits" / "val.json").write_text(json.dumps({"frame_names": [], "time_ids": []}))
    for i, n in enumerate(names):
        _image(root / "rgb" / "1x" / f"{n}.png", seed=i)
        (root / "camera" / f"{n}.json").write_text(json.dumps({
            "orientation": look_at(np.array([1.0, 2.0, 0.5 + i]))[:3, :3].tolist(),
            "position": [0, 0.1 * i, 2], "focal_length": 50.0, "pixel_aspect_ratio": 1.1,
            "principal_point": [5.0, 4.0], "image_size": [10, 8],
        }))
    return root


CASES = {
    # registry key: (fixture writer, extra config fields, splits)
    "nerfstudio-data": (fx_nerfstudio, {}, ("train", "val")),
    "thermalnerf-data": (fx_nerfstudio, {}, ("train", "val")),
    "blender-data": (fx_blender, {"scale_factor": 0.5}, ("train", "val", "test")),
    "colmap": (fx_colmap, {"train_split_fraction": 0.75}, ("train", "val")),
    "minimal-parser": (fx_minimal, {}, ("train", "val", "test")),
    "instant-ngp-data": (fx_ingp, {"train_split_fraction": 0.5}, ("train", "val")),
    "dnerf-data": (fx_dnerf, {}, ("train", "val")),
    "sdfstudio-data": (fx_sdfstudio, {"include_mono_prior": True, "skip_every_for_val_split": 2}, ("train", "val")),
    "scannet-data": (fx_scannet, {"train_split_fraction": 0.5}, ("train", "val")),
    "scannetpp-data": (fx_scannetpp, {}, ("train", "val")),
    "arkitscenes-data": (fx_arkitscenes, {"train_split_fraction": 0.75}, ("train", "val")),
    "sitcoms3d-data": (fx_sitcoms3d, {}, ("train",)),
    "nerfosr-data": (fx_nerfosr, {"scene": "stjacob"}, ("train", "val", "test")),
    "phototourism-data": (fx_phototourism, {"train_split_fraction": 0.75}, ("train", "val")),
    "dycheck-data": (fx_dycheck, {}, ("train", "val")),
}


def _configs(key, data, extra):
    port = type(registry.dataparser_configs[key])(data=data, **extra)
    ref = type(jax_registry.dataparser_configs[key])(data=data, **extra)
    return port, ref


@pytest.mark.parametrize("key", sorted(CASES))
def test_parser_matches_jax(tmp_path, key):
    writer, extra, splits = CASES[key]
    data = writer(tmp_path / "scene")
    port_cfg, ref_cfg = _configs(key, data, extra)
    port, ref = registry.build_dataparser(port_cfg), jax_registry.build_dataparser(ref_cfg)
    for split in splits:
        want = ref.get_dataparser_outputs(split)
        got = port.get_dataparser_outputs(split)
        assert len(got.image_filenames) > 0 or split != "train"
        assert_outputs_equal(got, want)


def test_ingp_parser_jpeg_fov_matches_jax(tmp_path):
    data = fx_ingp_jpeg_fov(tmp_path / "scene")
    for mode in ("fraction", "interval", "all"):
        port_cfg, ref_cfg = _configs("instant-ngp-data", data, {"eval_mode": mode, "eval_interval": 2})
        for split in ("train", "val"):
            assert_outputs_equal(registry.build_dataparser(port_cfg).get_dataparser_outputs(split),
                                 jax_registry.build_dataparser(ref_cfg).get_dataparser_outputs(split))


def test_committed_colmap_jpeg_scene_matches_jax():
    data = FIXTURES / "colmap_sphere"
    for fraction in (0.9, 1.0):
        port_cfg, ref_cfg = _configs("colmap", data, {"train_split_fraction": fraction})
        for split in ("train", "val"):
            assert_outputs_equal(registry.build_dataparser(port_cfg).get_dataparser_outputs(split),
                                 jax_registry.build_dataparser(ref_cfg).get_dataparser_outputs(split))


def test_nuscenes_needs_its_devkit_in_both():
    port_cfg, ref_cfg = _configs("nuscenes-data", Path("scene-0103"), {})
    with pytest.raises(ImportError) as ref_err:
        jax_registry.build_dataparser(ref_cfg).get_dataparser_outputs("train")
    with pytest.raises(ImportError) as port_err:
        registry.build_dataparser(port_cfg).get_dataparser_outputs("train")
    assert str(port_err.value) == str(ref_err.value)


def test_build_dataparser_for_every_key():
    assert list(registry.dataparser_configs) == list(jax_registry.dataparser_configs)
    for key, cfg in registry.dataparser_configs.items():
        ref = jax_registry.dataparser_configs[key]
        assert type(registry.build_dataparser(cfg)).__name__ == type(jax_registry.build_dataparser(ref)).__name__
        assert type(cfg).__name__ == type(ref).__name__
        assert {f: getattr(cfg, f) for f in vars(cfg)} == {f: getattr(ref, f) for f in vars(ref)}, key


@pytest.mark.parametrize("key", list(registry.dataparser_configs))
def test_parser_config_round_trips(tmp_path, key):
    """Each parser config in a MethodConfig goes through config.yml and back
    (ns-eval and ns-render reload such runs), with the JAX package's tree."""
    from nerfstudio_thermal_tpu.configs.serialization import to_dict as jax_to_dict

    from nerfstudio_thermal_torch.configs.method_configs import get_method_config
    from nerfstudio_thermal_torch.configs.serialization import load_config, save_config, to_dict
    from tests.test_torch_config_cli import _port_tags

    method = get_method_config("instant-ngp")
    method.dataparser = registry.dataparser_configs[key]
    save_config(method, tmp_path / "config.yml")
    loaded = load_config(tmp_path / "config.yml")
    assert loaded == method and type(loaded.dataparser) is type(method.dataparser)
    assert to_dict(method.dataparser) == _port_tags(jax_to_dict(jax_registry.dataparser_configs[key]))


def test_colmap_readers_match_jax(tmp_path):
    sparse = tmp_path / "sparse"
    _colmap_binaries(sparse)
    for name in ("read_cameras_binary", "read_images_binary", "read_points3D_binary"):
        got = getattr(colmap, name)(sparse / f"{name[5:-7]}.bin")
        want = getattr(jax_colmap, name)(sparse / f"{name[5:-7]}.bin")
        assert set(got) == set(want) and len(got) > 0
        for k in want:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{name} {k}")
            if name == "read_cameras_binary":
                assert colmap.parse_colmap_camera_params(got[k]) == jax_parse_camera(want[k])
            if name == "read_images_binary":
                np.testing.assert_array_equal(colmap.qvec2rotmat(got[k].qvec), jax_colmap.qvec2rotmat(want[k].qvec))
    for model, params in (("SIMPLE_PINHOLE", [40.0, 5, 4]), ("SIMPLE_RADIAL", [40.0, 5, 4, 0.1]),
                          ("RADIAL", [40.0, 5, 4, 0.1, 0.02]),
                          ("OPENCV", [40.0, 41, 5, 4, 0.1, 0.02, 0.001, -0.002]),
                          ("OPENCV_FISHEYE", [40.0, 41, 5, 4, 0.1, 0.02, 0.003, 0.004])):
        cam = colmap.Camera(1, model, 10, 8, np.asarray(params))
        assert colmap.parse_colmap_camera_params(cam) == jax_parse_camera(jax_colmap.Camera(*cam))
    assert colmap.CAMERA_MODEL_IDS == jax_colmap.CAMERA_MODEL_IDS


def test_camera_res_scale_factor_resizes_images_not_cameras(tmp_path):
    """The JAX package's hazard, kept: the images shrink with the factor,
    the data manager's cameras keep the full-size intrinsics and sizes."""
    data = make_ingp_fixture(tmp_path / "scene", n=4, hw=(24, 32))
    port_cfg, ref_cfg = _configs("instant-ngp-data", data, {"train_split_fraction": 0.75})
    port = VanillaDataManager(VanillaDataManagerConfig(camera_res_scale_factor=0.5, use_native_sampler=False),
                              registry.build_dataparser(port_cfg))
    ref = JaxDataManager(JaxDataManagerConfig(camera_res_scale_factor=0.5, use_native_sampler=False),
                         jax_registry.build_dataparser(ref_cfg))
    for i in range(len(port.train_dataset)):
        got, want = port.train_dataset.get_image(i), ref.train_dataset.get_image(i)
        assert got.shape == want.shape == (12, 16, 3)
        np.testing.assert_array_equal(got, want)
    for name in ("width", "height", "fx", "cx"):
        got = getattr(port.train_cameras, name).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(ref.train_cameras, name)))
    assert int(port.train_cameras.width[0]) == 32 and int(port.train_cameras.height[0]) == 24
