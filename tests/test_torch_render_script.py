"""ns-render end to end, the port's `scripts/render.py` against the JAX
package's, on the CPU.

The same tiny thermal-nerfacto-tpu and thermal-nerfacto runs as
tests/test_torch_eval.py (f32; the scene of make_synthetic_rgbt_dataset
at 32 x 40 / 32 x 36 pixels, half the pairs held out for eval) are
written as run directories (config.yml and a checkpoint) by each package,
the port's model carrying the JAX trainer's parameters through
`load_jax_params`. Each package's ns-render `main` then renders the same
mode into PNG frames:
- camera-path: 3 cameras of a JSON path at 20 x 24, with rgb, rgb_thermal,
  depth, removal and removal_thermal (several outputs, so one directory
  each, <stem>_<name>), and the removal threshold set by flag;
- interpolated --rgb-poses-only true (through the RGB eval cameras);
- spiral (30 frames around the first eval camera);
- dataset (every eval camera, <output-path>/<name>/).
File names and frame counts must be equal; frames within one 8-bit level
(a float difference of ~1e-6 can cross a level boundary), depth
colormaps within one step of the turbo table (as tests/test_torch_eval.py
allows: random fields' depths span ~3e-4, which the colormap stretches to
[0, 1]). An output name the model does not produce raises KeyError in
both packages.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.method_configs import setup_trainer as jax_setup_trainer
from nerfstudio_thermal_tpu.configs.serialization import save_config as jax_save_config
from nerfstudio_thermal_tpu.scripts import render as jax_render

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config, save_config
from nerfstudio_thermal_torch.data.datasets import decode_png
from nerfstudio_thermal_torch.scripts import render
from nerfstudio_thermal_torch.utils.jax_params import load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_eval import RGB_HW, T_HW, TURBO_STEP, _method

torch.set_num_threads(1)

LEVEL = 1  # 8-bit levels
DEPTH_LEVELS = int(np.ceil(TURBO_STEP * 255)) + 1
PATH_HW = (20, 24)


def _look_at(eye):
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up, -forward], -1)
    c2w[:3, 3] = eye
    return c2w


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4, rgb_hw=RGB_HW, t_hw=T_HW)


@pytest.fixture(scope="module")
def camera_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("path") / "camera_path.json"
    eyes = [np.array([2.0 * np.cos(a), 2.0 * np.sin(a), 0.5]) for a in (0.0, 0.4, 0.8)]
    path.write_text(json.dumps({
        "render_height": PATH_HW[0], "render_width": PATH_HW[1],
        "camera_path": [{"camera_to_world": _look_at(e).ravel().tolist(), "fov": 50.0 + 5 * i}
                        for i, e in enumerate(eyes)],
    }))
    return path


@pytest.fixture(scope="module", params=["thermal-nerfacto-tpu", "thermal-nerfacto"])
def runs(request, scene, tmp_path_factory):
    """(JAX run's config.yml, the port's config.yml) holding the same
    parameters."""
    name = request.param
    root = tmp_path_factory.mktemp(name)
    jax_method = _method(jax_method_config, name, scene)
    jax_trainer = jax_setup_trainer(jax_method, base_dir=root / "jax")
    jax_trainer.setup()
    jax_save_config(jax_method, root / "jax" / "config.yml")
    jax_trainer.save_checkpoint(0)
    method = _method(get_method_config, name, scene)
    trainer = setup_trainer(method, base_dir=root / "port", device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, jax_trainer.host_params()))
    trainer.setup()
    save_config(method, root / "port" / "config.yml")
    trainer.save_checkpoint(0)
    return root / "jax" / "config.yml", root / "port" / "config.yml"


MODES = {
    "camera-path": ["--rendered-output-names", "rgb", "rgb_thermal", "depth", "removal", "removal_thermal",
                    "--removal-min-density-diff", "0.1"],
    "interpolated": ["--rgb-poses-only", "true", "--interpolation-steps", "2", "--rendered-output-names", "rgb",
                     "depth_thermal"],
    "spiral": [],
    "dataset": ["--rendered-output-names", "rgb_thermal", "accumulation"],
}


def _frames(root):
    return {str(p.relative_to(root)): decode_png(p) for p in sorted(root.rglob("*.png"))}


@pytest.mark.parametrize("mode", list(MODES))
def test_render_script_matches_jax(runs, camera_path, tmp_path, mode):
    jax_config, port_config = runs
    args = list(MODES[mode])
    if mode == "camera-path":
        args += ["--camera-path-filename", str(camera_path)]
    out_name = "renders" if mode == "dataset" else "renders/frames"
    assert jax_render.main([mode, "--load-config", str(jax_config), "--output-path",
                            str(tmp_path / "jax" / out_name), *args]) == 0
    assert render.main([mode, "--load-config", str(port_config), "--output-path",
                        str(tmp_path / "port" / out_name), *args], device="cpu") == 0
    want, got = _frames(tmp_path / "jax"), _frames(tmp_path / "port")
    assert sorted(got) == sorted(want) and got
    # interpolated: --interpolation-steps x (4 eval cameras - 1) frames, on the one segment between the 2 RGB ones
    expected = {"camera-path": 5 * 3, "interpolated": 2 * 6, "spiral": 30, "dataset": 2 * 4}[mode]
    assert len(got) == expected
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == np.uint8, path
        if mode == "camera-path":
            assert g.shape == (*PATH_HW, 3), path
        limit = DEPTH_LEVELS if "depth" in path else LEVEL
        assert np.abs(g.astype(int) - w.astype(int)).max() <= limit, path


def test_unknown_output_raises_in_both(runs, tmp_path):
    jax_config, port_config = runs
    args = ["--rendered-output-names", "rgb", "no_such_output"]
    with pytest.raises(KeyError, match="no_such_output"):
        jax_render.main(["dataset", "--load-config", str(jax_config), "--output-path", str(tmp_path / "j"), *args])
    with pytest.raises(KeyError, match="no_such_output"):
        render.main(["dataset", "--load-config", str(port_config), "--output-path", str(tmp_path / "p"), *args],
                    device="cpu")


def test_render_script_defaults_to_cuda(runs, monkeypatch, tmp_path):
    """Without device= the command renders on the card; with CUDA absent it
    raises instead of running on the CPU. Usage errors return 2."""
    _, port_config = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render.main(["dataset", "--load-config", str(port_config), "--output-path", str(tmp_path)])
    assert render.main(["camera-path", "--load-config", str(port_config)]) == 2
    assert render.main(["no-such-mode"]) == 2
    assert render.main(["spiral", "--no-such-flag", "1"]) == 2
    assert render.main(["--help"]) == 0


def test_a_card_checkpoint_renders_on_the_cpu(runs, tmp_path):
    """A run trained on the card keeps its CUDA generator's state (16
    bytes) in the checkpoint; reloading it on the CPU, whose generator
    state differs in size, starts a fresh jitter stream instead of
    failing, and the run renders."""
    _, port_config = runs
    run = tmp_path / "run"
    shutil.copytree(port_config.parent, run)
    (ckpt_path,) = (run / "nerfstudio_models").glob("*.ckpt")
    ckpt = torch.load(ckpt_path, weights_only=True)
    ckpt["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(ckpt, ckpt_path)
    assert render.main(["dataset", "--load-config", str(run / "config.yml"), "--output-path",
                        str(tmp_path / "out")], device="cpu") == 0
    assert len(list((tmp_path / "out" / "rgb").glob("*.png"))) == 4


def test_a_card_checkpoint_does_not_resume_training_on_the_cpu(runs, tmp_path):
    """Resuming training from that checkpoint on the CPU raises: a fresh
    jitter stream would no longer follow the run it resumes."""
    _, port_config = runs
    run = tmp_path / "run"
    shutil.copytree(port_config.parent, run)
    (ckpt_path,) = (run / "nerfstudio_models").glob("*.ckpt")
    ckpt = torch.load(ckpt_path, weights_only=True)
    ckpt["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(ckpt, ckpt_path)
    config = load_config(run / "config.yml")
    config.trainer.load_dir = run / "nerfstudio_models"
    trainer = setup_trainer(config, base_dir=tmp_path / "resumed", device="cpu")
    with pytest.raises(ValueError, match="another device"):
        trainer.setup()
