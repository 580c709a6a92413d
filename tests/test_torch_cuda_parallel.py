"""The data-parallel trainer (parallel/mesh.py) and multi-scene training
on the card.

These tests need a CUDA device; without one every test skips with a
reason. The module imports no JAX, so it runs on a machine with a card
and no JAX installation:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py

At a tiny thermal-nerfacto (separate mode, f32, the cross-density prefix
256 of 1,024 rays) on a scene written with the port's PNG writer, each
rank a process of its own with a timeout (tests/torch_parallel_worker.py):
- one rank in an NCCL group against the plain trainer: step 0's loss
  bitwise, later steps rel 1e-3 (the hash table gradient's atomics add in
  any order on the card);
- two gloo ranks sharing the card against the plain trainer: every step's
  losses rel 1e-3, parameters within the flip rule of
  tests/test_torch_parallel.py;
- a two-scene run whose scene 0 equals the one-scene run's losses (rel
  1e-3) and whose scenes reload through eval_setup on the card.
"""

import json

import numpy as np
import pytest
import torch

from tests.torch_parallel_worker import run_ranks, write_scene

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

LOSS_TOL = 1e-3
FIELDS = {
    "model.density_mode": "separate", "model.num_levels": 4, "model.log2_hashmap_size": 12,
    "model.hidden_dim": 16, "model.hidden_dim_color": 16, "model.num_proposal_samples_per_ray": [16, 8],
    "model.num_nerf_samples_per_ray": 8, "model.density_loss_rays_fraction": 0.25,
    "model.compute_dtype": "float32", "datamanager.train_num_rays_per_batch": 1024,
    "datamanager.use_native_sampler": False,
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nerfstudio_thermal_torch.ops.cuda import hash_encoding

    hash_encoding.load_library()  # built once, before the ranks load it
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("scene"))


def losses(path):
    return json.loads((path / "losses.json").read_text())


def spec(scene, **extra):
    return {"method": "thermal-nerfacto", "fields": FIELDS, "data": str(scene), "steps": 4, "device": "cuda",
            **extra}


def assert_losses_close(got, want, first_bitwise: bool):
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            assert np.isfinite(g[k]), (step, k)
            if step == 0 and first_bitwise and k == "loss":
                assert g[k] == w[k], (k, g[k], w[k])
            assert abs(g[k] - w[k]) <= LOSS_TOL * max(abs(w[k]), 1e-3), (step, k, g[k], w[k])


def test_one_rank_nccl_group_is_the_plain_step(cuda, scene, tmp_path):
    run_ranks(spec(scene, group=False), tmp_path / "plain", world=1)
    run_ranks(spec(scene, group=True), tmp_path / "nccl", world=1)
    assert_losses_close(losses(tmp_path / "nccl"), losses(tmp_path / "plain"), first_bitwise=True)


def test_two_gloo_ranks_on_one_card(cuda, scene, tmp_path):
    run_ranks(spec(scene, group=False), tmp_path / "plain", world=1)
    run_ranks(spec(scene, backend="gloo"), tmp_path / "gloo", world=2)
    assert_losses_close(losses(tmp_path / "gloo"), losses(tmp_path / "plain"), first_bitwise=False)
    got, want = np.load(tmp_path / "gloo" / "params.npz"), np.load(tmp_path / "plain" / "params.npz")
    for k in want.files:
        flipped = np.abs(got[k] - want[k]) > 1e-3 * max(np.abs(want[k]).max(), 1e-12)
        assert flipped.mean() < 0.25, k


def test_two_scenes_on_the_card(cuda, tmp_path):
    """Scene 0 of a two-scene run trains as the one-scene run; each scene
    reloads through eval_setup."""
    from nerfstudio_thermal_torch.engine.multi_scene import train_multi_scene
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    a, b = write_scene(tmp_path / "a"), write_scene(tmp_path / "b", num_pairs=4)
    overrides = {k.split(".", 1)[1] if k.startswith("model.") else k: v for k, v in FIELDS.items()}
    overrides["num_proposal_samples_per_ray"] = tuple(overrides["num_proposal_samples_per_ray"])
    multi = train_multi_scene("thermal-nerfacto", [a, b], steps=4, out_dir=tmp_path / "multi",
                              config_overrides=overrides, log_every=1)
    solo = train_multi_scene("thermal-nerfacto", [a], steps=4, out_dir=tmp_path / "solo",
                             config_overrides=overrides, log_every=1)
    want = [json.loads(line)["train/loss"] for line in
            (solo.checkpoint_dir / "scene_0_a" / "events.jsonl").read_text().splitlines()]
    got = [json.loads(line)["train/loss"] for line in
           (multi.checkpoint_dir / "scene_0_a" / "events.jsonl").read_text().splitlines()]
    assert got[0] == want[0]
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    for run in sorted(multi.checkpoint_dir.glob("scene_*")):
        _, trainer = eval_setup(run / "config.yml")
        assert trainer.state.step == 4 and trainer.device.type == "cuda"
