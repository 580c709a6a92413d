"""The port's host-only scripts and converters against the JAX package's, on
the CPU: the same inputs, built from a numpy seed in `tmp_path`, go through
both packages.

- ns-process-data's vendor modes (polycam, record3d, metashape,
  realitycapture, odm with either pose file, skydio with exiftool stubbed
  on PATH): transforms.json equal to 1e-12, every written file byte-equal.
- ns-process-data video, perspective and equirectangular (COLMAP skipped),
  on a short MJPG video written with OpenCV: byte-equal frames.
- `eyeful_to_nerfstudio_transforms` / `subsample_transforms` /
  `process_eyeful_capture` and `equirect2persp`: equal to 1e-6.
- ns-download-data: equal registries and `resolve_source`;
  `download_capture` with `_download_url` stubbed to write a local zip /
  tar / tar.gz gives the same tree; eyefultower converts a capture on disk.
- ns-install-cli with HOME in `tmp_path`: installing twice leaves one
  block, a JAX block already in the rc file survives install and uninstall,
  and the completed method names are the port's registry, which is JAX's.
- The Aria and nuScenes dataset scripts' pure math (equal to 1e-12), and
  the Aria conversion with projectaria_tools faked in `sys.modules`: the
  port's frames (its own JPEG encoder, quality 75) are Pillow's bytes.

No JAX trainer is built here.
"""

import dataclasses
import datetime
import io
import json
import os
import stat
import sys
import tarfile
import types
import zipfile
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.process_data import equirect_utils as jax_equirect
from nerfstudio_thermal_tpu.process_data import eyeful_utils as jax_eyeful
from nerfstudio_thermal_tpu.scripts import download_data as jax_download
from nerfstudio_thermal_tpu.scripts import install_cli as jax_install
from nerfstudio_thermal_tpu.scripts import process_data as jax_script
from nerfstudio_thermal_tpu.scripts.datasets import process_nuscenes_masks as jax_nuscenes
from nerfstudio_thermal_tpu.scripts.datasets import process_project_aria as jax_aria

from nerfstudio_thermal_torch.process_data import equirect_utils, eyeful_utils, hloc_utils
from nerfstudio_thermal_torch.scripts import download_data, install_cli
from nerfstudio_thermal_torch.scripts import process_data as port_script
from nerfstudio_thermal_torch.scripts.datasets import process_nuscenes_masks, process_project_aria

torch.set_num_threads(1)
cv2.setNumThreads(1)

PACKAGES = (("port", port_script), ("jax", jax_script))


def assert_close_tree(got, want, tol=1e-12, where="$"):
    """Equal JSON-like trees, floats to `tol` (absolute and relative)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_close_tree(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert abs(float(got) - float(want)) <= tol * max(1.0, abs(float(want))), (where, got, want)
    else:
        assert got == want, (where, got, want)


def assert_same_outputs(port_out: Path, jax_out: Path, tol=1e-12):
    """The same files under both directories; transforms.json equal to
    `tol`, every other file byte-equal."""
    files = sorted(p.relative_to(jax_out) for p in jax_out.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(port_out) for p in port_out.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".json":
            assert_close_tree(json.loads((port_out / rel).read_text()), json.loads((jax_out / rel).read_text()), tol)
        else:
            assert (port_out / rel).read_bytes() == (jax_out / rel).read_bytes(), rel


def _images(directory: Path, n: int, gen, hw=(24, 32), suffix=".jpg", names=None) -> list:
    directory.mkdir(parents=True, exist_ok=True)
    out = []
    for i in range(n):
        p = directory / f"{names[i] if names else f'img{i}'}{suffix}"
        Image.fromarray(gen.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(p)
        out.append(p)
    return out


def _rotation(gen) -> np.ndarray:
    q, _ = np.linalg.qr(gen.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


# ---------------------------------------------------------------- vendor exports


def _polycam(root: Path, gen) -> list:
    kf = root / "keyframes"
    images = _images(kf / "images", 3, gen, names=["100", "200", "300"])
    (kf / "cameras").mkdir()
    for i, img in enumerate(images):
        cam = {"fx": 30.0 + gen.random(), "fy": 31.0 + gen.random(), "cx": 16.0 + gen.random(),
               "cy": 12.0 + gen.random(), "width": 32, "height": 24, "blur_score": [40.0, 10.0, 30.0][i]}
        cam.update({f"t_{r}{c}": float(gen.normal()) for r in range(3) for c in range(4)})
        (kf / "cameras" / f"{img.stem}.json").write_text(json.dumps(cam))
    return ["--num-downscales", "1", "--crop-border-pixels", "2"]


def _record3d(root: Path, gen) -> list:
    _images(root / "rgb", 4, gen, names=[str(i) for i in range(4)])
    quats = gen.normal(size=(4, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    poses = np.concatenate([quats, gen.normal(size=(4, 3))], 1)
    K = [30.5, 0, 0, 0, 30.5, 0, 16.0, 12.0, 1]
    (root / "metadata.json").write_text(json.dumps({"poses": poses.tolist(), "K": K, "w": 32, "h": 24}))
    return ["--num-downscales", "1", "--max-dataset-size", "3"]


def _metashape(root: Path, gen) -> list:
    _images(root / "images", 3, gen)
    cams = "".join(
        f'<camera id="{i}" sensor_id="0" component_id="0" label="img{i}.jpg">'
        f"<transform>{' '.join(str(float(v)) for v in np.r_[np.c_[_rotation(gen), gen.normal(size=3)].ravel(), 0, 0, 0, 1])}"
        f"</transform></camera>" for i in range(3)
    ) + '<camera id="9" sensor_id="0" label="img_missing"/>'
    rot = " ".join(str(float(v)) for v in _rotation(gen).ravel())
    xml = (
        '<document><chunk><sensors><sensor id="0" type="frame"><resolution width="32" height="24"/>'
        "<calibration><f>29.5</f><cx>0.25</cx><cy>-0.5</cy><k1>0.01</k1><k2>-0.002</k2><p1>0.0003</p1>"
        "</calibration></sensor></sensors><components><component id=\"0\"><transform>"
        f"<rotation>{rot}</rotation><translation>0.5 -1.0 2.0</translation><scale>1.5</scale>"
        f"</transform></component></components><cameras>{cams}</cameras></chunk></document>"
    )
    (root / "cameras.xml").write_text(xml)
    return ["--xml", str(root / "cameras.xml"), "--num-downscales", "1"]


def _realitycapture(root: Path, gen) -> list:
    _images(root / "images", 3, gen)
    rows = ["#name,x,y,alt,heading,pitch,roll,f,px,py,k1,k2,k3,k4,t1,t2"]
    for i in range(3):
        v = gen.normal(size=15)
        rows.append(f"img{i}.jpg," + ",".join(repr(float(x)) for x in v))
    rows.append("absent.jpg," + ",".join(["0.0"] * 15))
    (root / "poses.csv").write_text("\n".join(rows) + "\n")
    return ["--csv", str(root / "poses.csv"), "--num-downscales", "1"]


def _odm(root: Path, gen, geojson: bool) -> list:
    images = _images(root / "images", 3, gen)
    cam = {"projection_type": "brown", "width": 32, "height": 24, "focal_x": 0.9, "focal_y": 0.91,
           "c_x": 0.01, "c_y": -0.02, "k1": 0.01, "k2": -0.001, "p1": 0.0002, "p2": 0.0001, "k3": 0.0}
    (root / "cameras.json").write_text(json.dumps({"v2 cam": cam}))
    shots = {p.name: {"rotation": gen.normal(size=3).tolist(), "translation": gen.normal(size=3).tolist()}
             for p in images[:2]}
    if geojson:
        (root / "odm_report").mkdir()
        feats = [{"properties": {"filename": k, **v}} for k, v in shots.items()]
        (root / "odm_report" / "shots.geojson").write_text(json.dumps({"features": feats}))
    else:
        (root / "opensfm").mkdir()
        (root / "opensfm" / "reconstruction.nerfstudio.json").write_text(json.dumps([{"shots": shots}]))
    return ["--num-downscales", "1"]


EXIFTOOL = """#!{python}
import json, sys
files = [a for a in sys.argv[1:] if not a.startswith("-")]
print(json.dumps([json.load(open(f + ".json")) for f in files]))
"""


def _skydio(root: Path, gen, quat: bool) -> list:
    bin_dir = root.parent / "bin"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "exiftool").write_text(EXIFTOOL.format(python=sys.executable))
    (bin_dir / "exiftool").chmod(0o755 | stat.S_IEXEC)
    images = _images(root, 5, gen)
    for i, img in enumerate(images):
        q = gen.normal(size=4)
        q /= np.linalg.norm(q)
        md = {"XMP:CameraSource": "INFRARED" if i % 2 else "VISIBLE",
              "XMP:CalibratedFocalLengthX": 30.0 + i, "XMP:CalibratedFocalLengthY": 30.5 + i,
              "XMP:CalibratedOpticalCenterX": 16.1, "XMP:CalibratedOpticalCenterY": 11.9,
              "XMP:DewarpData": ",".join(str(float(v)) for v in gen.normal(size=5) * 0.01),
              "File:ImageWidth": 32, "File:ImageHeight": 24,
              **{f"XMP:CameraPositionNED{a}": float(gen.normal()) for a in "XYZ"},
              **{f"XMP:CameraOrientationNED{a}": float(gen.uniform(-180, 180)) for a in ("Yaw", "Pitch", "Roll")},
              **{f"XMP:CameraOrientationQuatNED{a}": float(v) for a, v in zip("XYZW", q)}}
        if i != 3:  # a thermal frame without radiometry is skipped
            md["APP1:AtmosphericTransAlpha1"] = 0.006
        Path(str(img) + ".json").write_text(json.dumps(md))
    return ["--use-quat-poses", str(quat)]


VENDORS = {
    "polycam": _polycam,
    "record3d": _record3d,
    "metashape": _metashape,
    "realitycapture": _realitycapture,
    "odm": lambda root, gen: _odm(root, gen, geojson=False),
    "odm_geojson": lambda root, gen: _odm(root, gen, geojson=True),
    "skydio": lambda root, gen: _skydio(root, gen, quat=False),
    "skydio_quat": lambda root, gen: _skydio(root, gen, quat=True),
}


@pytest.mark.parametrize("vendor", sorted(VENDORS))
def test_device_converters_match_jax(tmp_path, monkeypatch, vendor):
    src = tmp_path / "src"
    src.mkdir()
    flags = VENDORS[vendor](src, np.random.default_rng(sorted(VENDORS).index(vendor)))
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    mode = vendor.split("_")[0]
    data = src / "images" if mode in ("metashape", "realitycapture") else src
    for name, script in PACKAGES:
        assert script.main([mode, "--data", str(data), "--output-dir", str(tmp_path / name), *flags]) == 0
    assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    frames = json.loads((tmp_path / "port" / "transforms.json").read_text())["frames"]
    assert len(frames) == {"polycam": 2, "record3d": 3, "metashape": 3, "realitycapture": 3, "odm": 2,
                           "skydio": 4}[mode]


# ---------------------------------------------------------------- video


def _write_video(path: Path, frames: np.ndarray) -> None:
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()


@pytest.mark.parametrize("camera_type", ["perspective", "equirectangular"])
def test_video_mode_matches_jax(tmp_path, camera_type):
    gen = np.random.default_rng(5)
    hw = (16, 24) if camera_type == "perspective" else (32, 64)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    frames = np.stack([np.stack([(x * 7 + t * 13) % 256, (y * 11 + t * 5) % 256, gen.integers(0, 256, hw)], -1)
                       for t in range(12)]).astype(np.uint8)
    video = tmp_path / "clip.avi"
    _write_video(video, frames)
    flags = ["--num-frames-target", "4", "--num-downscales", "1", "--skip-colmap", "true",
             "--camera-type", camera_type, "--images-per-equirect", "8"]
    for name, script in PACKAGES:
        assert script.main(["video", "--data", str(video), "--output-dir", str(tmp_path / name), *flags]) == 0
    assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    n = len(list((tmp_path / "port" / "images").iterdir()))
    assert n == (4 if camera_type == "perspective" else 4 * 8)


def test_equirect2persp_matches_jax():
    gen = np.random.default_rng(6)
    img = gen.integers(0, 256, (40, 80, 3), dtype=np.uint8)
    for fov, theta, phi, hd, wd in ((120.0, -180.0, 45.0, 20, 20), (110.0, 30.0, 0.0, 16, 24), (90.0, 77.5, -45.0, 9, 13)):
        got = equirect_utils.equirect2persp(img, fov, theta, phi, hd, wd)
        want = jax_equirect.equirect2persp(img, fov, theta, phi, hd, wd)
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=0, atol=1e-6)
    assert equirect_utils._crop_bound_arr_vertical([-45.0, 0.0, 45.0], 120.0, (0.2, 0.3, 0, 0)) == \
        jax_equirect._crop_bound_arr_vertical([-45.0, 0.0, 45.0], 120.0, (0.2, 0.3, 0, 0))


# ---------------------------------------------------------------- eyeful tower


def _eyeful_capture(gen, model: str, n: int = 6) -> tuple:
    krt = []
    for i in range(n):
        w, h = (2048, 1368) if i % 2 else (1368, 2048)
        K = np.array([[900.0 + i, 0, w / 2 + 0.5], [0, 905.0, h / 2 - 0.25], [0, 0, 1]])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = _rotation(gen), gen.normal(size=3)
        krt.append({"cameraId": f"{i // 2}/{i}", "width": w, "height": h, "K": K.T.tolist(), "T": T.T.tolist(),
                    "distortionModel": model, "distortion": (gen.normal(size=8) * 0.01).tolist()})
    splits = {"train": [c["cameraId"] for c in krt[:4]], "test": [c["cameraId"] for c in krt[4:]]}
    return {"KRT": krt}, splits


@pytest.mark.parametrize("model,capture", [("RadialAndTangential", "riverview"), ("Fisheye", "office1a")])
def test_eyeful_transforms_match_jax(tmp_path, model, capture):
    cameras, splits = _eyeful_capture(np.random.default_rng(7), model)
    got = eyeful_utils.eyeful_to_nerfstudio_transforms(capture, cameras, splits, 1368, 2048)
    want = jax_eyeful.eyeful_to_nerfstudio_transforms(capture, cameras, splits, 1368, 2048)
    assert_close_tree(got, want, 1e-6)
    assert_close_tree(eyeful_utils.subsample_transforms(got, 3), jax_eyeful.subsample_transforms(want, 3), 1e-6)
    for name, module in (("port", eyeful_utils), ("jax", jax_eyeful)):
        d = tmp_path / name / capture
        d.mkdir(parents=True)
        (d / "cameras.json").write_text(json.dumps(cameras))
        (d / "splits.json").write_text(json.dumps(splits))
        module.process_eyeful_capture(d, resolution="jpeg_1k", subsample=4)
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", 1e-6)


# ---------------------------------------------------------------- ns-download-data


def test_download_registries_match_jax():
    assert set(download_data.FAMILIES) == set(jax_download.FAMILIES)
    for name, fam in jax_download.FAMILIES.items():
        assert dataclasses.asdict(download_data.FAMILIES[name]) == dataclasses.asdict(fam), name
        caps = [None, *fam.captures, "no-such-capture"]
        for cap in caps:
            try:
                want = jax_download.resolve_source(name, cap)
            except Exception as e:  # an unknown capture; eyefultower, which has none
                with pytest.raises(type(e)) as got:
                    download_data.resolve_source(name, cap)
                assert got.value.args == e.args
                continue
            assert download_data.resolve_source(name, cap) == want, (name, cap)
    assert download_data.NERFSTUDIO_DATASET_SUBSET == jax_download.NERFSTUDIO_DATASET_SUBSET
    assert download_data._usage().replace("ns-download-data-torch", "ns-download-data") == jax_download._usage()


def _fake_download(tree: Path):
    """A `_download_url` that writes `tree` as the archive `dest` names."""

    def download(url: str, dest: Path) -> None:
        dest.parent.mkdir(parents=True, exist_ok=True)
        files = sorted(p for p in tree.rglob("*") if p.is_file())
        if dest.name.endswith(".zip"):
            with zipfile.ZipFile(dest, "w") as zf:
                for p in files:
                    zf.write(p, p.relative_to(tree.parent))
        else:
            with tarfile.open(dest, "w:gz" if dest.name.endswith((".tar.gz", ".tgz")) else "w") as tf:
                for p in files:
                    tf.add(p, p.relative_to(tree.parent))

    return download


@pytest.mark.parametrize("argv,top", [
    (["blender"], "nerf_synthetic"),  # zip, renamed to blender/
    (["nerfstudio", "--capture-name", "poster"], "poster"),  # zip
    (["sdfstudio", "--capture-name", "dtu"], "DTU"),  # tar
    (["mill19", "--capture-name=rubble"], "rubble-pixsfm"),  # tgz
    (["phototourism", "--capture-name", "all"], "scene"),  # tar.gz, every capture
])
def test_download_capture_matches_jax(tmp_path, monkeypatch, argv, top):
    tree = tmp_path / "archive" / top
    (tree / "images").mkdir(parents=True)
    (tree / "images" / "a.png").write_bytes(b"png bytes")
    (tree / "transforms.json").write_text('{"frames": []}')
    for name, module in (("port", download_data), ("jax", jax_download)):
        monkeypatch.setattr(module, "_download_url", _fake_download(tree))
        assert module.main([*argv, "--save-dir", str(tmp_path / name)]) == 0
    assert_same_outputs(tmp_path / "port", tmp_path / "jax")


def test_download_failures_and_eyefultower_match_jax(tmp_path, monkeypatch, capsys):
    def offline(url, dest):
        raise OSError("no network")

    for name, module in (("port", download_data), ("jax", jax_download)):
        monkeypatch.setattr(module, "_download_url", offline)
        assert module.main(["record3d", "--save-dir", str(tmp_path / name)]) == 1
        assert module.main(["nerfstudio", "--capture-name", "nope", "--save-dir", str(tmp_path / name)]) == 2
        assert module.main(["no-such-dataset"]) == 2
        assert module.main(["blender", "--capture-name", "all"]) == 2
        assert module.main(["eyefultower", "--capture-name", "table", "--save-dir", str(tmp_path / name)]) == 1
        cameras, splits = _eyeful_capture(np.random.default_rng(8), "Fisheye")
        d = tmp_path / name / "eyefultower" / "table"
        d.mkdir(parents=True)
        (d / "cameras.json").write_text(json.dumps(cameras))
        (d / "splits.json").write_text(json.dumps(splits))
        assert module.main(["eyefultower", "--capture-name", "table", "--resolution-name", "jpeg_4k",
                            "--save-dir", str(tmp_path / name)]) == 0
    assert_same_outputs(tmp_path / "port", tmp_path / "jax", 1e-6)


# ---------------------------------------------------------------- ns-install-cli


def test_install_cli_blocks_and_methods(tmp_path, monkeypatch):
    from nerfstudio_thermal_tpu.configs.method_configs import method_configs as jax_methods

    from nerfstudio_thermal_torch.configs.method_configs import method_names

    monkeypatch.setenv("HOME", str(tmp_path))
    (tmp_path / ".bashrc").write_text("export KEEP=1\n")
    assert jax_install.main(["--shell", "bash"]) == 0
    jax_rc = (tmp_path / ".bashrc").read_text()
    for _ in range(2):
        assert install_cli.main([]) == 0
    for rc in (".bashrc", ".zshrc"):
        text = (tmp_path / rc).read_text()
        assert text.count(install_cli.HEADER) == text.count(install_cli.FOOTER) == 1, rc
    text = (tmp_path / ".bashrc").read_text()
    assert text.startswith(jax_rc.rstrip("\n")) and "export KEEP=1" in text
    assert text.count(jax_install.HEADER) == 1
    script = (tmp_path / ".nerfstudio_thermal_torch" / "completions" / "setup.bash").read_text()
    assert (tmp_path / ".nerfstudio_thermal_tpu" / "completions" / "setup.bash").exists()
    words = script.split("_complete_ns_train_torch()", 1)[1].split('compgen -W "', 1)[1].split('"', 1)[0].split()
    assert words == sorted(method_names()) == sorted(jax_methods)
    commands = {line.split()[-1] for line in script.splitlines() if line.startswith("complete -F")}
    assert commands == {f"{cmd}-torch" for cmd in jax_install.ENTRY_POINTS}
    assert install_cli.main(["--mode", "uninstall"]) == 0
    # the blank line written before the block stays, as with the JAX script
    assert (tmp_path / ".bashrc").read_text().rstrip("\n") == jax_rc.rstrip("\n")
    assert install_cli.HEADER not in (tmp_path / ".zshrc").read_text()
    assert install_cli.main(["--bogus"]) == 2


# ---------------------------------------------------------------- dataset scripts


def test_aria_and_nuscenes_math_match_jax():
    gen = np.random.default_rng(9)
    for w in (1408, 704, 1000):
        assert process_project_aria.rgb_valid_radius(w) == jax_aria.rgb_valid_radius(w)
    ts = np.sort(gen.integers(0, 10**9, 20))
    for t in (-5, int(ts[3]), int(ts[3]) + 1, 10**10):
        assert process_project_aria.nearest_pose_index(ts, t) == jax_aria.nearest_pose_index(ts, t)
    args = (np.r_[np.c_[_rotation(gen), gen.normal(size=3)], [[0, 0, 0, 1]]],
            np.r_[np.c_[_rotation(gen), gen.normal(size=3)], [[0, 0, 0, 1]]],
            gen.normal(size=15), 1408, 1408, "camera-rgb_1.jpg", 12345)
    assert_close_tree(process_project_aria.aria_frame_to_nerfstudio(*args), jax_aria.aria_frame_to_nerfstudio(*args))

    K = np.array([[800.0, 0, 400], [0, 800, 300], [0, 0, 1]])
    pts = gen.normal(size=(3, 8)) + np.array([[0], [0], [6.0]])
    got, want = process_nuscenes_masks.project_points(pts, K), jax_nuscenes.project_points(pts, K)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    masks = [module.rasterize_cuboid(np.ones((60, 80), np.uint8), got / 10) for module in
             (process_nuscenes_masks, jax_nuscenes)]
    np.testing.assert_array_equal(*masks)
    assert 0 < masks[0].sum() < masks[0].size

    class FakeNuScenes:
        def __init__(self, speeds):
            self.speeds = speeds

        def box_velocity(self, token):
            return np.array([self.speeds[token], 0.0, 0.0])

        def get(self, table, token):
            assert table == "sample_annotation"
            return {"next": token + 1 if token + 1 < len(self.speeds) else ""}

    for speeds in ([0.1, 0.2, 0.3], [0.1, 0.9, 0.0], [0.76]):
        inst = {"first_annotation_token": 0}
        assert (process_nuscenes_masks.instance_is_dynamic(FakeNuScenes(speeds), inst, 0.75)
                == jax_nuscenes.instance_is_dynamic(FakeNuScenes(speeds), inst, 0.75))


def _fake_projectaria(gen, frames: np.ndarray) -> dict:
    """projectaria_tools' modules as ProcessProjectAria.main uses them."""
    obj = types.SimpleNamespace
    mat = lambda m: obj(to_matrix=lambda: m)  # noqa: E731
    t_device_camera = np.r_[np.c_[_rotation(gen), gen.normal(size=3)], [[0, 0, 0, 1]]]
    calib = obj(get_image_size=lambda: np.array([frames.shape[2], frames.shape[1]]),
                projection_params=lambda: gen.normal(size=15) + 300.0,
                get_transform_device_camera=lambda: mat(t_device_camera))
    images = [(obj(to_numpy_array=lambda f=f: f), obj(capture_timestamp_ns=int(1e9 * (i + 0.4))))
              for i, f in enumerate(frames)]
    provider = obj(get_device_calibration=lambda: obj(get_camera_calib=lambda name: calib),
                   get_stream_id_from_label=lambda label: 7, get_num_data=lambda sid: len(images),
                   get_image_data_by_index=lambda sid, i: images[i])
    traj = [obj(tracking_timestamp=datetime.timedelta(seconds=0.5 * k),
                transform_world_device=mat(np.r_[np.c_[_rotation(gen), gen.normal(size=3)], [[0, 0, 0, 1]]]))
            for k in range(2 * len(frames) + 1)]
    points = [obj(position_world=gen.normal(size=3)) for _ in range(5)]
    mps = types.ModuleType("projectaria_tools.core.mps")
    mps.read_closed_loop_trajectory = lambda path: traj
    mps.read_global_point_cloud = lambda path: points
    utils = types.ModuleType("projectaria_tools.core.mps.utils")
    utils.filter_points_from_confidence = lambda pts: pts[:4]
    data_provider = types.ModuleType("projectaria_tools.core.data_provider")
    data_provider.create_vrs_data_provider = lambda path: provider
    core = types.ModuleType("projectaria_tools.core")
    core.mps, core.data_provider = mps, data_provider
    root = types.ModuleType("projectaria_tools")
    root.core = core
    return {"projectaria_tools": root, "projectaria_tools.core": core, "projectaria_tools.core.mps": mps,
            "projectaria_tools.core.mps.utils": utils, "projectaria_tools.core.data_provider": data_provider}


def test_project_aria_conversion_matches_jax(tmp_path, monkeypatch):
    """The port writes the frames with its own JPEG encoder at quality 75:
    the same bytes as the JAX script's Pillow `.save`."""
    gen = np.random.default_rng(10)
    frames = gen.integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    mps = tmp_path / "mps"
    mps.mkdir()
    (mps / "closed_loop_trajectory.csv").write_text("")
    (mps / "global_points.csv.gz").write_bytes(b"")
    for name, module in (("port", process_project_aria), ("jax", jax_aria)):
        for key, mod in _fake_projectaria(np.random.default_rng(11), frames).items():
            monkeypatch.setitem(sys.modules, key, mod)
        assert module.main(["--vrs-file", str(tmp_path / "rec.vrs"), "--mps-data-dir", str(mps),
                            "--output-dir", str(tmp_path / name)]) == 0
    assert_same_outputs(tmp_path / "port", tmp_path / "jax")
    first = tmp_path / "port" / f"camera-rgb_{int(1e9 * 0.4)}.jpg"
    reference = io.BytesIO()
    Image.fromarray(frames[0]).save(reference, format="JPEG", quality=75)
    assert first.read_bytes() == reference.getvalue()


def test_import_gated_tools_report_absence(tmp_path, monkeypatch):
    """hloc, projectaria_tools and the nuScenes devkit are optional: absent
    here, the port reports so as the JAX package does."""
    from nerfstudio_thermal_tpu.process_data import hloc_utils as jax_hloc

    assert hloc_utils.hloc_available() == jax_hloc.hloc_available() is False
    for key in ("projectaria_tools", "nuscenes"):
        monkeypatch.setitem(sys.modules, key, None)
    assert process_project_aria.main(["--output-dir", str(tmp_path / "a")]) == jax_aria.main(
        ["--output-dir", str(tmp_path / "b")]) == 1
    assert process_nuscenes_masks.main(["--output-dir", str(tmp_path / "c")]) == jax_nuscenes.main(
        ["--output-dir", str(tmp_path / "d")]) == 1
    for module in (hloc_utils, jax_hloc):
        with pytest.raises(ImportError, match="hloc is not installed"):
            module.run_hloc(tmp_path, tmp_path)
