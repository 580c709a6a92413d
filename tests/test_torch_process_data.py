"""The port's ns-process-data `images` / `rgbt` pieces against the JAX
package's, on the CPU: each function of both packages on the same inputs
(the port's modules are copies, so the outputs must be equal, not close).

- `raw2temp`, `fix_endian`, the circle grid's 3-D centres, `circle_detect`;
- `calibrate_rgb_thermal` on circle grids projected with known
  intrinsics and a known RGB -> thermal transform (both packages' results
  equal; the intrinsics within 2% and the baseline within 0.5 cm of the
  truth);
- `colmap_to_json` on a COLMAP binary model written here;
- `append_thermal_frames` with a non-identity calibration and the scale
  pair;
- the `images` mode of both scripts on three photos;
- the whole `rgbt` pipeline, each package's `scripts.process_data.main`
  on one synthetic FLIR capture (5 frames and 6 calibration views),
  through stub `exiftool` and `colmap` executables written here and put
  first on PATH (exiftool answers from PNG / JSON sidecars of each
  capture; colmap's mapper writes a one-camera model whose intrinsics are
  those the feature extractor was given): transforms.json equal and every
  image byte-equal.

Test names and directories avoid the letters "rgb": the calibration pairs
files by replacing "rgb" with "thermal" in the whole path, as the
reference does. OpenCV 5 (this environment's) returns findCirclesGrid's
centres as [N, 2], on which the JAX package's `estimate_intrinsics` fails
in cv2.norm; the port's `circle_detect` returns OpenCV 4's [N, 1, 2], and
the JAX side runs with its `circle_detect` reshaped alike
(`opencv4_layout`).
"""

import inspect
import json
import os
import stat
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_tpu.process_data import calibration_utils as jax_cal
from nerfstudio_thermal_tpu.process_data import colmap_utils as jax_colmap
from nerfstudio_thermal_tpu.process_data import flir_utils as jax_flir
from nerfstudio_thermal_tpu.process_data.rgbt_to_nerfstudio_dataset import RGBTToNerfstudioDataset as JaxRGBT
from nerfstudio_thermal_tpu.scripts import process_data as jax_script

from nerfstudio_thermal_torch.process_data import calibration_utils, colmap_utils, flir_utils
from nerfstudio_thermal_torch.process_data.rgbt_to_nerfstudio_dataset import RGBTToNerfstudioDataset
from nerfstudio_thermal_torch.scripts import process_data as port_script

torch.set_num_threads(1)
cv2.setNumThreads(1)  # OpenCV's threaded solvers vary in the last bits from call to call

K_VIS = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])  # 640 x 480
K_IR = np.array([[500.0, 0, 200], [0, 500.0, 160], [0, 0, 1]])  # 400 x 320
R_IR = cv2.Rodrigues(np.array([0.0, 0.03, 0.01]))[0]
T_IR = np.array([5.0, 0.0, 0.0])  # cm: the thermal camera 5 cm beside the visible one
META = {
    "Emissivity": 0.95, "SubjectDistance": "1.00 m", "AtmosphericTemperature": "20.0 C",
    "ReflectedApparentTemperature": "20.0 C", "IRWindowTemperature": "20.0 C", "IRWindowTransmission": 1,
    "RelativeHumidity": "50.0 %", "PlanckR1": 21106.77, "PlanckB": 1501, "PlanckF": 1, "PlanckO": -7340,
    "PlanckR2": 0.012545258, "RawThermalImageType": "PNG",
}


def test_raw2temp_and_fix_endian():
    raw = np.random.default_rng(0).uniform(9000, 20000, (7, 9))
    kw = dict(E=0.95, OD=1.0, RTemp=21.0, ATemp=19.0, IRWTemp=20.0, IRT=0.98, RH=40.0)
    np.testing.assert_array_equal(flir_utils.raw2temp(raw, **kw), jax_flir.raw2temp(raw, **kw))
    np.testing.assert_array_equal(flir_utils.raw2temp(raw), jax_flir.raw2temp(raw))
    t = np.random.default_rng(1).integers(0, 2**16, (5, 6)).astype(np.uint16)
    np.testing.assert_array_equal(flir_utils.fix_endian(t), jax_flir.fix_endian(t))
    np.testing.assert_array_equal(flir_utils.fix_endian(flir_utils.fix_endian(t)), t)
    assert flir_utils.extract_float("1.50 m") == jax_flir.extract_float("1.50 m") == 1.5


def test_circle_grid_and_detection():
    for kw in ({}, {"center_center_cm": 2.5, "cols": 7, "rows": 3}):
        np.testing.assert_array_equal(calibration_utils.get_calibration_target_circle_centers(**kw),
                                      jax_cal.get_calibration_target_circle_centers(**kw))
    img = grid_image(K_VIS, np.eye(3), np.array([-6.0, -9.0, 40.0]), (480, 640))
    for is_thermal in (False, True):
        got, found = calibration_utils.circle_detect(img, is_thermal=is_thermal)
        want, jfound = jax_cal.circle_detect(img, is_thermal=is_thermal)
        assert found and jfound and got.shape == (44, 1, 2)
        np.testing.assert_array_equal(got, want.reshape(-1, 1, 2))


@pytest.fixture
def opencv4_layout(monkeypatch):
    """The JAX package's circle_detect with OpenCV 4's [N, 1, 2] centres."""
    detect = jax_cal.circle_detect

    def reshaped(*args, **kwargs):
        centers, found = detect(*args, **kwargs)
        return (centers.reshape(-1, 1, 2) if centers is not None else None), found

    monkeypatch.setattr(jax_cal, "circle_detect", reshaped)


def view_pose(i: int):
    """The grid's pose in the visible camera of calibration view i."""
    rvec = np.array([0.12 * np.sin(i), 0.15 * np.cos(1.3 * i), 0.05 * i - 0.1])
    tvec = np.array([-12.0 + 0.4 * i, -6.5 + 0.3 * np.sin(i), 42.0 + 2.0 * (i % 3)])
    return cv2.Rodrigues(rvec)[0], tvec


def grid_image(k, rot, tvec, hw, radius_cm: float = 0.75, dark: bool = True) -> np.ndarray:
    """The circle grid seen by camera k at pose (rot, tvec): dark discs of
    the circles' projected radius on white, 3 channels."""
    pts = calibration_utils.get_calibration_target_circle_centers()
    cam = pts @ rot.T + tvec
    uv = cam[:, :2] / cam[:, 2:] * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]
    img = np.full(hw, 255 if dark else 0, np.uint8)
    for (u, v), z in zip(uv, cam[:, 2]):
        cv2.circle(img, (int(round(u * 16)), int(round(v * 16))), int(round(k[0, 0] * radius_cm / z * 16)),
                   0 if dark else 255, -1, lineType=cv2.LINE_AA, shift=4)
    return np.repeat(img[..., None], 3, axis=-1)


def ir_pose(rot, tvec):
    """The grid's pose in the thermal camera: x_ir = R_IR x_vis + T_IR."""
    return R_IR @ rot, R_IR @ tvec + T_IR


def write_calibration_folders(root: Path, views: int = 6):
    vis, ir = root / "cal_raw" / "rgb", root / "cal_raw" / "thermal"
    vis.mkdir(parents=True)
    ir.mkdir(parents=True)
    for i in range(views):
        rot, tvec = view_pose(i)
        Image.fromarray(grid_image(K_VIS, rot, tvec, (480, 640))).save(vis / f"view{i}_rgb.png")
        Image.fromarray(grid_image(K_IR, *ir_pose(rot, tvec), (320, 400))).save(ir / f"view{i}_thermal.png")
    return [str(vis)], [str(ir)]


def test_calibration_recovers_the_rig(tmp_path, opencv4_layout):
    vis, ir = write_calibration_folders(tmp_path)
    kw = dict(intrinsic_calibration_mode=4, force_radial_distortion_coeff_K3_to_zero=True)
    got = calibration_utils.calibrate_rgb_thermal(vis, ir, **kw)
    want = jax_cal.calibrate_rgb_thermal(vis, ir, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for name, truth in (("camera_matrix_rgb", K_VIS), ("camera_matrix_thermal", K_IR)):
        est = got[name]
        np.testing.assert_allclose(est[[0, 1, 0, 1], [0, 1, 2, 2]], truth[[0, 1, 0, 1], [0, 1, 2, 2]], rtol=0.02,
                                   err_msg=name)
    np.testing.assert_allclose(got["rgb_thermal_transform"][:3, 3], T_IR, atol=0.5)
    np.testing.assert_allclose(got["rgb_thermal_transform"][:3, :3], R_IR, atol=0.01)


def write_colmap_model(sparse: Path, names, params=(60.0, 61.0, 32.0, 24.0, 0.01, -0.02, 0.001, 0.002), hw=(48, 64)):
    """A one-camera OPENCV COLMAP binary model of the named images on a ring."""
    sparse.mkdir(parents=True, exist_ok=True)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 4, hw[1], hw[0]))  # model 4: OPENCV
        f.write(struct.pack("<8d", *params))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, name in enumerate(names):
            a = 0.4 * i
            q = np.array([np.cos(a / 2), 0.05, np.sin(a / 2), 0.02])
            q /= np.linalg.norm(q)
            f.write(struct.pack("<idddddddi", i + 1, *q, 0.3 * np.cos(a), 0.1 * i, 3.0 + 0.2 * np.sin(a), 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    (sparse / "points3D.bin").write_bytes(struct.pack("<Q", 0))


def test_colmap_to_json(tmp_path):
    names = [f"frame_{i:05d}.png" for i in range(5)]
    write_colmap_model(tmp_path / "sparse", names)
    for package, out in ((colmap_utils, tmp_path / "port"), (jax_colmap, tmp_path / "jax")):
        out.mkdir()
        assert package.colmap_to_json(tmp_path / "sparse", out, image_rename_map={names[1]: "renamed.png"}) == 5
    got = json.loads((tmp_path / "port" / "transforms.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "transforms.json").read_text())
    assert got["camera_model"] == "OPENCV" and got["frames"][1]["file_path"] == "images/renamed.png"


def test_append_thermal_frames_with_calibration(tmp_path):
    """A non-identity calibration and the scale pair present: both packages
    write the same frames (thermal poses M_rgb M_world_colmap M_thermal_rgb
    M_colmap_world)."""
    transforms = {
        "w": 64, "h": 48, "fl_x": 60.0, "fl_y": 60.0, "cx": 32.0, "cy": 24.0, "k1": 0.0, "k2": 0.0, "p1": 0.0,
        "p2": 0.0, "frames": [
            {"file_path": f"images/frame_{i:05d}.png", "colmap_im_id": i + 1,
             "transform_matrix": np.concatenate([np.eye(4)[:3] + [[0, 0, 0, 0.1 * i], [0, 0, 0, 0.05 * i * i],
                                                                   [0, 0, 0, -0.2 * i]], [[0, 0, 0, 1]]]).tolist()}
            for i in range(5)
        ],
    }
    rig = np.eye(4)
    rig[:3, :3], rig[:3, 3] = R_IR, T_IR
    cal = {"camera_matrix_rgb": K_VIS, "camera_matrix_thermal": K_IR,
           "distortion_coeffs_rgb": np.array([[0.01, -0.02, 0.001, 0.002, 0.0]]),
           "distortion_coeffs_thermal": np.array([[-0.03, 0.01, 0.0, 0.001, 0.0]]),
           "rgb_thermal_transform": rig, "thermal_rgb_transform": np.linalg.inv(rig)}
    outs = []
    for cls, name in ((RGBTToNerfstudioDataset, "port"), (JaxRGBT, "jax")):
        out = tmp_path / name
        (out / "images_thermal").mkdir(parents=True)
        for i in range(5):
            Image.fromarray(np.zeros((40, 50, 3), np.uint8)).save(out / "images_thermal" / f"frame_{i:05d}.png")
        (out / "transforms.json").write_text(json.dumps(transforms))
        conv = cls.__new__(cls)
        conv.output_dir = out
        conv.scale_pair = ("images/frame_00003.png", "images/frame_00004.png")
        conv.scale_pair_distance_cm = 30.48
        conv.append_thermal_frames(cal)
        outs.append((out / "transforms.json").read_text())
    assert outs[0] == outs[1]
    frames = json.loads(outs[0])["frames"]
    assert [f["is_thermal"] for f in frames] == [0] * 5 + [1] * 5
    assert frames[5]["fl_x"] == 500.0 and frames[5]["w"] == 50
    assert not np.allclose(frames[5]["transform_matrix"], frames[0]["transform_matrix"])


# ---- the whole rgbt pipeline through stub executables ---------------------

EXIFTOOL = '''#!{python}
import json, sys
from pathlib import Path
args = sys.argv[1:]
path = Path(next(a for a in args if not a.startswith("-")))
if "-j" in args:
    sys.stdout.write(Path(str(path) + ".json").read_text())
elif "-EmbeddedImage" in args:
    sys.stdout.buffer.write(Path(str(path) + ".vis").read_bytes())
elif "-RawThermalImage" in args:
    sys.stdout.buffer.write(Path(str(path) + ".raw").read_bytes())
else:
    sys.exit(2)
'''

COLMAP = '''#!{python}
import json, struct, sys
from pathlib import Path
cmd, args = sys.argv[1], sys.argv[2:]
opt = {{}}
i = 0
while i < len(args):
    key = args[i].lstrip("-")
    if "=" in key:
        key, val = key.split("=", 1)
        i += 1
    else:
        val = args[i + 1]
        i += 2
    opt[key] = val.strip('"')
import numpy as np
{writer}
if cmd == "feature_extractor":
    given = opt.get("ImageReader.camera_params", "60,61,32,24,0.01,-0.02,0.001,0.002")
    Path(opt["database_path"]).write_text(json.dumps([float(x) for x in given.split(",")]))
elif cmd == "mapper":
    params = json.loads(Path(opt["database_path"]).read_text())
    names = sorted(p.name for p in Path(opt["image_path"]).iterdir())
    w, h = struct.unpack(">II", (Path(opt["image_path"]) / names[0]).read_bytes()[16:24])
    write_colmap_model(Path(opt["output_path"]) / "0", names, params, (h, w))
'''


def write_stubs(bin_dir: Path) -> None:
    bin_dir.mkdir()
    for name, text in (("exiftool", EXIFTOOL), ("colmap", COLMAP)):
        path = bin_dir / name
        path.write_text(text.format(python=sys.executable, writer=inspect.getsource(write_colmap_model)))
        path.chmod(path.stat().st_mode | stat.S_IEXEC)


def write_flir(path: Path, visible: np.ndarray, raw: np.ndarray) -> None:
    """A FLIR capture as the stub exiftool reads it: the embedded visible
    PNG, the raw thermal PNG (byte-swapped, as FLIR stores it) and the
    metadata."""
    path.write_bytes(b"")
    Image.fromarray(visible).save(str(path) + ".vis", format="PNG")
    Image.fromarray(flir_utils.fix_endian(raw.astype(np.uint16))).save(str(path) + ".raw", format="PNG")
    Path(str(path) + ".json").write_text(json.dumps([META]))


def write_capture(root: Path) -> tuple:
    """5 scene frames (64 x 48 visible, 32 x 24 raw thermal) and 6
    calibration views of the circle grid."""
    gen = np.random.default_rng(4)
    scene, cal = root / "capture", root / "cal"
    scene.mkdir(parents=True)
    cal.mkdir()
    for i in range(5):
        write_flir(scene / f"IMG_{i:04d}.jpg", gen.integers(0, 256, (48, 64, 3), dtype=np.uint8),
                   gen.uniform(12000, 18000, (24, 32)))
    for i in range(6):
        rot, tvec = view_pose(i)
        ir = grid_image(K_IR, *ir_pose(rot, tvec), (320, 400))[..., 0]
        write_flir(cal / f"CAL_{i:04d}.jpg", grid_image(K_VIS, rot, tvec, (480, 640)),
                   np.where(ir > 127, 16000.0, 13000.0))
    return scene, cal


def test_process_data_pipeline_both_packages(tmp_path, monkeypatch, opencv4_layout):
    write_stubs(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    outs = {}
    for name, script in (("port", port_script), ("jax", jax_script)):
        scene, cal = write_capture(tmp_path / name)
        out = tmp_path / name / "out"
        assert script.main(["rgbt", "--data", str(scene), "--output-dir", str(out),
                            "--calibration-data", str(cal)]) == 0
        outs[name] = out
    got = json.loads((outs["port"] / "transforms.json").read_text())
    assert got == json.loads((outs["jax"] / "transforms.json").read_text())
    assert len(got["frames"]) == 10 and sum(f["is_thermal"] for f in got["frames"]) == 5
    assert abs(got["frames"][0]["fl_x"] - K_VIS[0, 0]) < 0.02 * K_VIS[0, 0]
    files = sorted(p.relative_to(outs["jax"]) for p in outs["jax"].rglob("*.png"))
    assert len(files) == 5 * 5  # images, images_2, images_4, images_8, images_thermal
    assert files == sorted(p.relative_to(outs["port"]) for p in outs["port"].rglob("*.png"))
    for rel in files:
        assert (outs["port"] / rel).read_bytes() == (outs["jax"] / rel).read_bytes(), rel


def test_images_mode_both_packages(tmp_path, monkeypatch):
    """`images`: copies, downscales and COLMAP (stubbed) of both packages
    give equal transforms.json and byte-equal images."""
    write_stubs(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    photos = tmp_path / "photos"
    photos.mkdir()
    gen = np.random.default_rng(7)
    for i in range(3):
        Image.fromarray(gen.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(photos / f"p{i}.png")
    outs = {}
    for name, script in (("port", port_script), ("jax", jax_script)):
        outs[name] = tmp_path / name
        assert script.main(["images", "--data", str(photos), "--output-dir", str(outs[name]),
                            "--num-downscales", "2"]) == 0
    assert (json.loads((outs["port"] / "transforms.json").read_text())
            == json.loads((outs["jax"] / "transforms.json").read_text()))
    files = sorted(p.relative_to(outs["jax"]) for p in outs["jax"].rglob("*.png"))
    assert len(files) == 3 * 3 and files == sorted(p.relative_to(outs["port"]) for p in outs["port"].rglob("*.png"))
    for rel in files:
        assert (outs["port"] / rel).read_bytes() == (outs["jax"] / rel).read_bytes(), rel


def test_script_usage_and_modes(capsys):
    """The JAX script's usage text and return codes; the modes not ported
    raise with their ROADMAP item."""
    assert port_script.main([]) == jax_script.main([]) == 0
    usage = capsys.readouterr().out.split("usage:")
    assert usage[1] == usage[2]
    assert port_script.main(["nope"]) == jax_script.main(["nope"]) == 2
    for mode in ("video", "skydio", "polycam", "record3d", "metashape", "realitycapture", "odm"):
        with pytest.raises(NotImplementedError, match="A9"):
            port_script.main([mode, "--data", "x", "--output-dir", "y"])
