"""The port's eval surface against the JAX package's, on the CPU: the data
manager's eval half, the trainer's eval batch, the pipeline's eval image
with its metrics and images, the eval-set averages, and ns-train / ns-eval
end to end.

Both packages set up the same tiny run (`tiny()` of test_torch_render for
thermal-nerfacto-tpu, `tiny_hash()` of test_torch_hash_slice for
thermal-nerfacto, f32 compute) on tests/fixtures.make_synthetic_rgbt_dataset
at 32 x 40 (RGB) and 32 x 36 (thermal) pixels, large enough for LPIPS's
fifth VGG stage, with half the pairs held out for eval. The port's model
gets the JAX trainer's parameters through `load_jax_params`.

Tolerances (f32, as tests/test_torch_render.py holds the renders):
- eval-batch losses and metrics: relative 1e-4;
- eval images: the GT | pred grid, the accumulation and the depths
  behind the depth colormaps 1e-4 absolute and relative; the colormaps
  themselves within one step of the 256-entry turbo table (a depth within
  the tolerance can fall into the neighbouring entry, and the randomly
  initialized fields render depths that span ~3e-4, which the colormap
  stretches to [0, 1]);
- PSNR and SSIM of an eval image: 1e-4 relative; LPIPS 1e-3 relative (a
  perceptual distance of two renders that agree to ~1e-6, summed over
  five VGG stages);
- batches, eval image indices and the key sets: exact.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.method_configs import setup_trainer as jax_setup_trainer
from nerfstudio_thermal_tpu.data.datamanagers import VanillaDataManager as JaxDataManager
from nerfstudio_thermal_tpu.data.dataparsers.nerfstudio_dataparser import ThermalNerf as JaxParser

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.data.datamanagers import VanillaDataManager
from nerfstudio_thermal_torch.data.dataparsers.nerfstudio_dataparser import ThermalNerf
from nerfstudio_thermal_torch.data.datasets import decode_png
from nerfstudio_thermal_torch.scripts import eval as ns_eval
from nerfstudio_thermal_torch.scripts import train as ns_train
from nerfstudio_thermal_torch.utils.colormaps import apply_float_colormap
from nerfstudio_thermal_torch.utils.eval_utils import eval_setup
from nerfstudio_thermal_torch.utils.jax_params import load_jax_params
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_hash_slice import tiny_hash
from tests.test_torch_render import tiny

torch.set_num_threads(1)

RGB_HW, T_HW = (32, 40), (32, 36)
METRIC_TOL = {"psnr": 1e-4, "ssim": 1e-4, "lpips": 1e-3}
CUTS = {"thermal-nerfacto-tpu": tiny, "thermal-nerfacto": tiny_hash}
TURBO_STEP = float(np.abs(np.diff(apply_float_colormap(np.linspace(0, 1, 256)[:, None], "turbo"), axis=0)).max())


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4, rgb_hw=RGB_HW, t_hw=T_HW)


def _method(get, name, scene, eval_mode="fraction"):
    method = get(name)
    CUTS[name](method.model, "float32")
    method.model.eval_num_rays_per_chunk = 256
    method.data = method.dataparser.data = scene
    method.dataparser.eval_mode = eval_mode
    method.dataparser.train_split_fraction = 0.5
    method.datamanager.train_num_rays_per_batch = 64
    method.datamanager.eval_num_rays_per_batch = 64
    method.datamanager.use_native_sampler = False
    return method


def _records(run_dir, group):
    prefix = f"{group}/"
    out = []
    for line in (run_dir / "events.jsonl").read_text().splitlines():
        rec = json.loads(line)
        values = {k[len(prefix):]: v for k, v in rec.items() if k.startswith(prefix)}
        if values:
            out.append((rec["step"], values))
    return out


def _both_trainers(name, scene, tmp_path):
    jax_trainer = jax_setup_trainer(_method(jax_method_config, name, scene), base_dir=tmp_path / "jax")
    jax_trainer.setup()
    trainer = setup_trainer(_method(get_method_config, name, scene), base_dir=tmp_path / "port", device="cpu")
    load_jax_params(trainer.model, jax.tree.map(np.asarray, jax_trainer.host_params()))
    trainer.setup()
    return jax_trainer, trainer


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        tol = next((t for prefix, t in METRIC_TOL.items() if k.startswith(prefix)), 1e-4)
        np.testing.assert_allclose(got[k], w, rtol=tol, err_msg=k)


@pytest.mark.parametrize("eval_mode", ["all", "fraction"])
def test_eval_batches_and_images_match_jax(scene, eval_mode):
    """next_eval (the eval sampler seeded with seed + 1) and next_eval_image
    over two cycles of the eval set equal the JAX data manager's."""
    method = _method(get_method_config, "thermal-nerfacto", scene, eval_mode)
    jax_method = _method(jax_method_config, "thermal-nerfacto", scene, eval_mode)
    dm = VanillaDataManager(method.datamanager, ThermalNerf(method.dataparser))
    jax_dm = JaxDataManager(jax_method.datamanager, JaxParser(jax_method.dataparser))
    n = len(jax_dm.eval_dataset)
    assert len(dm.eval_dataset) == n == (8 if eval_mode == "all" else 4)
    for step in (0, 1, 20, 40):
        got, want = dm.next_eval(step), jax_dm.next_eval(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for _ in range(2 * n):
        (idx, got), (jax_idx, want) = dm.next_eval_image(0), jax_dm.next_eval_image(0)
        assert idx == jax_idx and got["is_thermal"] == want["is_thermal"]
        np.testing.assert_array_equal(got["image"], want["image"])
    assert dm._eval_image_index == jax_dm._eval_image_index == 0
    for name in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_allclose(getattr(dm.eval_cameras, name).numpy(),
                                   np.asarray(getattr(jax_dm.eval_cameras, name)), rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", ["thermal-nerfacto-tpu", "thermal-nerfacto"])
def test_eval_batch_iteration_matches_jax(scene, tmp_path, name):
    """The eval_* scalars the two trainers write for the same eval step."""
    jax_trainer, trainer = _both_trainers(name, scene, tmp_path)
    for step in (20, 40):
        jax_trainer.eval_batch_iteration(step)
        trainer.eval_batch_iteration(step)
    (want, got) = (_records(t.base_dir, "eval") for t in (jax_trainer, trainer))
    assert [s for s, _ in got] == [s for s, _ in want] == [20, 40]
    for (_, g), (_, w) in zip(got, want):
        assert set(g) == set(w) and "eval_rgb_loss" in g and "eval_psnr_thermal" in g
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["thermal-nerfacto-tpu", "thermal-nerfacto"])
def test_eval_image_metrics_and_images_match_jax(scene, tmp_path, name):
    """One RGB and one thermal eval image: the same metrics and images."""
    jax_trainer, trainer = _both_trainers(name, scene, tmp_path)
    params = jax_trainer.host_params()
    n = len(trainer.datamanager.eval_dataset)
    seen = set()
    for start in (0, n // 2):
        jax_trainer.datamanager._eval_image_index = trainer.datamanager._eval_image_index = start
        want, want_images = jax_trainer.pipeline.get_eval_image_metrics_and_images(params, 7)
        got, got_images = trainer.pipeline.get_eval_image_metrics_and_images(7)
        _assert_metrics_close(got, want)
        seen |= set(got)
        assert set(got_images) == set(want_images)
        for k, w in want_images.items():
            w = np.asarray(w)
            assert got_images[k].shape == w.shape, k
            if k in ("img", "accumulation"):
                np.testing.assert_allclose(got_images[k], w, atol=1e-4, rtol=1e-4, err_msg=k)
                continue
            # a depth within 1e-4 can fall into the neighbouring entry of the 256-entry table
            assert np.abs(got_images[k] - w).max() <= TURBO_STEP, k
        # the depths themselves
        idx = start
        want = jax_trainer.model.get_outputs_for_camera(params, jax_trainer.datamanager.eval_cameras, idx)
        got = trainer.pipeline.render_eval_camera(idx)
        for k in ("depth", "depth_thermal", "prop_depth_0", "prop_depth_1", "accumulation_thermal"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4, err_msg=k)
    assert {"psnr_rgb", "ssim_rgb", "lpips_untrained_rgb", "psnr_thermal", "ssim_thermal",
            "lpips_untrained_thermal"} <= seen


def test_average_eval_image_metrics_match_jax(scene, tmp_path):
    """The eval-set mean and std: JAX's key set, and its values."""
    jax_trainer, trainer = _both_trainers("thermal-nerfacto-tpu", scene, tmp_path)
    want = jax_trainer.pipeline.get_average_eval_image_metrics(jax_trainer.host_params(), 0)
    got = trainer.pipeline.get_average_eval_image_metrics(0)
    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())
    timing = {"num_rays_per_sec", "num_rays_per_sec_std", "fps", "fps_std"}
    _assert_metrics_close({k: v for k, v in got.items() if k not in timing and not k.endswith("_std")},
                          {k: v for k, v in want.items() if k not in timing and not k.endswith("_std")})
    assert trainer.datamanager._eval_image_index == 0


TINY_FLAGS = [
    "--model.freq-num-layers", "4", "--model.freq-hidden-dim", "128", "--model.freq-num-frequencies", "4",
    "--model.num-proposal-samples-per-ray", "8,6", "--model.num-nerf-samples-per-ray", "4",
    "--pipeline.model.eval-num-rays-per-chunk", "512", "--model.appearance-embed-dim", "4",
    "--model.hidden-dim-color", "16", "--model.compute-dtype", "float32",
    "--datamanager.train-num-rays-per-batch", "64", "--pipeline.datamanager.eval-num-rays-per-batch", "64",
    "--pipeline.datamanager.dataparser.train-split-fraction", "0.5",
]


def test_train_and_eval_scripts_end_to_end(scene, tmp_path):
    """ns-train with every eval cadence at 2 passes each cadence and writes
    config.yml, dataparser_transforms.json, the eval records and PNGs, and a
    checkpoint with eval_image_index, which a resumed trainer restores;
    ns-eval on that config.yml writes the JAX package's JSON keys, with the
    results of a direct get_average_eval_image_metrics on the checkpoint
    (and of the run's last eval_all)."""
    out = tmp_path / "outputs"
    argv = ["thermal-nerfacto-tpu", "--data", str(scene), "--max-num-iterations", "5", "--output-dir", str(out),
            "--experiment-name", "tiny", "--trainer.steps-per-eval-batch", "2", "--steps-per-eval-image", "2",
            "--steps-per-eval-all-images", "2", *TINY_FLAGS]
    assert ns_train.main(argv, device="cpu") == 0
    (run,) = out.glob("tiny/thermal-nerfacto-tpu/*")
    assert (run / "config.yml").exists()
    transforms = json.loads((run / "dataparser_transforms.json").read_text())
    assert set(transforms) == {"dataparser_transform", "dataparser_scale"}
    assert np.asarray(transforms["dataparser_transform"]).shape == (3, 4)

    batches = _records(run, "eval")
    assert [s for s, r in batches if "eval_rgb_loss" in r] == [2, 4]
    assert [s for s, r in batches if "psnr_rgb" in r or "psnr_thermal" in r] == [2, 4]
    evals_all = _records(run, "eval_all")
    assert [s for s, _ in evals_all] == [2, 4]
    last = evals_all[-1][1]
    for key in ("psnr_rgb", "ssim_rgb", "lpips_untrained_rgb", "psnr_thermal", "ssim_thermal",
                "lpips_untrained_thermal", "num_rays_per_sec", "fps"):
        assert np.isfinite(last[key]) and np.isfinite(last[f"{key}_std"]), key
    for name, width in (("img", 3 * RGB_HW[1]), ("depth", 2 * RGB_HW[1]), ("accumulation", RGB_HW[1]),
                        ("prop_depth_0", RGB_HW[1]), ("prop_depth_1_thermal", RGB_HW[1])):
        for step in (2, 4):
            assert decode_png(run / "images" / f"eval_{name}" / f"step-{step:09d}.png").shape == (*RGB_HW[:1],
                                                                                                 width, 3), name

    ckpt = torch.load(run / "nerfstudio_models" / "step-000000005.ckpt", weights_only=True)
    # two eval images (steps 2 and 4) on 4 eval images; each eval-all pass cycles once
    assert ckpt["eval_image_index"] == 2
    config, trainer = eval_setup(run / "config.yml", device="cpu")
    assert trainer.datamanager._eval_image_index == 2 and trainer.state.step == 5
    direct = trainer.pipeline.get_average_eval_image_metrics()

    result_path = tmp_path / "eval.json"
    assert ns_eval.main(["--load-config", str(run / "config.yml"), "--output-path", str(result_path)],
                        device="cpu") == 0
    result = json.loads(result_path.read_text())
    assert set(result) == {"experiment_name", "method_name", "checkpoint", "lpips_provenance", "results"}
    assert (result["experiment_name"], result["method_name"]) == ("tiny", "thermal-nerfacto-tpu")
    assert result["checkpoint"] == str(run / "nerfstudio_models")
    assert set(result["results"]) == set(direct) == set(last)
    for k, v in direct.items():
        if "psnr" in k or "ssim" in k or "lpips" in k:
            assert result["results"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
            assert last[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k


def test_train_script_rejects_what_the_port_does_not_carry(scene, tmp_path, capsys):
    base = ["--output-dir", str(tmp_path), *TINY_FLAGS]
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ns_train.main(["thermal-nerfacto-tpu", "--data", f"{scene},{scene}", *base], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        ns_train.main(["thermal-nerfacto-tpu", "--data", str(scene), "--vis", "viewer", *base], device="cpu")
    assert ns_train.main(["thermal-nerfacto-tpu", "--data", str(scene), "--model.no-such-flag", "1"]) == 2
    assert ns_train.main(["no-such-method"]) == 2
    assert ns_train.main(["--help"]) == 0
    assert "thermal-nerfacto-tpu" in capsys.readouterr().out
    assert ns_eval.main([]) == 2
