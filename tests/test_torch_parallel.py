"""The port's data-parallel trainer (parallel/mesh.py) against the JAX
package's one-device trainer, on the CPU.

Two gloo ranks (tests/torch_parallel_worker.py, spawned as processes with
a timeout each, so a hung rendezvous fails the test) train
thermal-nerfacto at the tiny config of
tests/parallel/test_multidevice_train.py:_tiny_cfg for 3 steps from the
JAX trainer's parameters, with the JAX steps' jitter draws (rebuilt from
each step's key, as tests/test_torch_train.py does) carried in as the
global batch's. Two cases:
- `shared` at the file's 32 rays;
- `separate` with density_loss_rays_fraction 0.25 at 1,024 rays: the
  cross-density prefix is k = 256 of the global batch, all of it inside
  rank 0's 512 rows, so rank 1 evaluates no cross density and the mean
  must still divide by the global k.
Losses: rel 1e-4 at the first step (test_torch_train.py's f32
tolerance; the ranks' sums run in another order), 1e-3 at the later ones,
whose parameters carry the entries Adam moved the other way (below). Parameters after 3 steps, every group,
in the JAX layout: the update p3 - p0 rel L2 1e-3, leaving out the
entries whose update differs from JAX's by more than 1e-3 of the group's
largest, which must be fewer than a quarter. With Adam's eps of 1e-15
every entry with any gradient moves by ~lr a step whatever the
gradient's size, so an entry whose gradient is rounding noise on the two
sides moves either way: 1.9% of the proposal nets' entries here at 32
rays, 9.8% in tests/test_torch_multi_scene.py's 2 steps, none of the
fields' or cameras' (measured; the port's one-rank trainer differs from
JAX's there alike, and from its two-rank run by 6e-8 at most;
tests/test_torch_density_modes.py allows such entries up to half).

Then the pieces: the host seed offset (host 1's batches are the JAX
package's process 1's, and differ from host 0's), the shard rows of one
and of two hosts, the step under a one-rank group against the plain step
(bitwise), the errors, and ns-train's default of every visible card for
a method other than thermal-nerfacto. The other methods' data-parallel
steps are tests/test_torch_parallel_methods.py's.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs import method_configs as jax_method_configs
from nerfstudio_thermal_tpu.parallel import mesh as jax_mesh
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.parallel.test_multidevice_train import _tiny_cfg
from tests.test_torch_eval import TINY_FLAGS
from tests.test_torch_render import tiny
from tests.test_torch_train import _method
from tests.torch_parallel_worker import apply_fields, flatten, run_ns_train, run_ranks

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.parallel import mesh
from nerfstudio_thermal_torch.scripts import train as train_script

torch.set_num_threads(1)

STEPS = 3
LOSS_TOL = 1e-4
LATER_LOSS_TOL = 1e-3  # steps after the first: the parameters carry Adam's flipped entries
PARAM_TOL = 1e-3
FLIP = 1e-3  # an update this far (relative to the group's largest) from JAX's took another sign
MAX_FLIPPED = 0.25
# the fields _tiny_cfg sets (besides data, steps and cadences)
FIELDS = (
    "model.density_mode", "model.num_levels", "model.base_res", "model.max_res", "model.log2_hashmap_size",
    "model.hidden_dim", "model.hidden_dim_color", "model.appearance_embed_dim",
    "model.num_proposal_samples_per_ray", "model.num_proposal_iterations", "model.num_nerf_samples_per_ray",
    "model.proposal_net_args_list", "model.eval_num_rays_per_chunk", "model.compute_dtype",
    "model.density_loss_rays_fraction", "dataparser.train_split_fraction",
    "datamanager.train_num_rays_per_batch", "datamanager.eval_num_rays_per_batch",
    "datamanager.use_native_sampler",
)
CASES = {"shared": ("shared", 1.0, 32), "separate": ("separate", 0.25, 1024)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"))


def jax_cfg(data, mode, frac, rays):
    cfg = _tiny_cfg(data, 1, batch=rays)
    cfg.model.density_mode = mode
    cfg.model.density_loss_rays_fraction = frac
    cfg.datamanager.use_native_sampler = False  # the port's Python sampler draws JAX's batches
    return cfg


def fields_of(cfg) -> dict:
    out = {}
    for key in FIELDS:
        node = cfg
        for p in key.split("."):
            node = getattr(node, p)
        out[key] = list(node) if isinstance(node, tuple) else node
    return out


def jitter_draws(rng, levels: int, rays: int) -> dict:
    """The jitter of the JAX step that starts from key `rng`
    (tests/test_torch_train.py JaxSide.uniforms)."""
    _, key_model, _, _ = jax.random.split(rng, 4)
    out = {}
    for name, key in zip(("rgb", "thermal"), jax.random.split(key_model)):
        for i, k in enumerate(jax.random.split(key, levels)):
            out[f"{name}/{i}"] = np.asarray(jax.random.uniform(k, (rays, 1)))
    return out


def jax_run(cfg, tmp):
    """JAX's one-device trainer: initial params, per-step draws, losses
    and the params after STEPS steps."""
    trainer = jax_method_configs.setup_trainer(cfg, base_dir=tmp / "jax")
    trainer.setup()
    levels = cfg.model.num_proposal_iterations + 1
    rays = cfg.datamanager.train_num_rays_per_batch
    carry = {f"params/{k}": v for k, v in flatten(trainer.host_params()).items()}
    losses = []
    for step in range(STEPS):
        carry.update({f"uniforms/{step}/{k}": v for k, v in jitter_draws(trainer.state.rng, levels, rays).items()})
        scalars = trainer.train_iteration(step)
        losses.append({k: float(v) for k, v in scalars.items()})
    return carry, losses, flatten(trainer.host_params()), levels


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_jax_one_device(scene, tmp_path, case):
    mode, frac, rays = CASES[case]
    cfg = jax_cfg(scene, mode, frac, rays)
    carry, want_losses, want_params, levels = jax_run(cfg, tmp_path)
    np.savez(tmp_path / "carry.npz", **carry)
    spec = {"method": "thermal-nerfacto", "fields": fields_of(cfg), "data": str(scene), "steps": STEPS,
            "carry": str(tmp_path / "carry.npz"), "levels": levels}
    run_ranks(spec, tmp_path / "port", world=2)

    got_losses = json.loads((tmp_path / "port" / "losses.json").read_text())
    for step, (got, want) in enumerate(zip(got_losses, want_losses)):
        assert set(got) == set(want), step
        for k, w in want.items():
            assert np.isfinite(got[k]), (step, k)
            tol = LOSS_TOL if step == 0 else LATER_LOSS_TOL
            assert abs(got[k] - w) <= tol * max(abs(w), 1e-3), (step, k, got[k], w)
    if case == "separate":
        # the prefix lies in rank 0's rows: the loss is there, and rank 1 had none of it
        assert all(step["density_loss"] > 0 for step in got_losses)
        rows = [np.load(tmp_path / "port" / f"rows{r}.npz") for r in (0, 1)]
        assert all(len(r["ray_indices/0"]) == rays // 2 for r in rows)
        assert 256 <= rays // 2

    got = dict(np.load(tmp_path / "port" / "params.npz"))
    assert set(got) == set(want_params)
    for group in sorted({k.split("/")[0] for k in want_params}):
        keys = sorted(k for k in want_params if k.split("/")[0] == group)
        p0 = np.concatenate([carry[f"params/{k}"].ravel() for k in keys]).astype(np.float64)
        want_d = np.concatenate([want_params[k].ravel() for k in keys]) - p0
        got_d = np.concatenate([got[k].ravel() for k in keys]) - p0
        flipped = np.abs(got_d - want_d) > FLIP * np.abs(want_d).max()
        assert flipped.mean() < MAX_FLIPPED, (group, flipped.mean())
        err = np.linalg.norm(got_d[~flipped] - want_d[~flipped]) / np.linalg.norm(want_d[~flipped])
        assert err <= PARAM_TOL, (group, err)


def test_one_rank_group_step_is_the_plain_step(scene, tmp_path):
    """Under a process group of one rank (the data-parallel path: shard,
    contributions, all-reduces) every loss of 3 steps is bitwise the plain
    trainer's, and so are the parameters after them."""
    cfg = jax_cfg(scene, "separate", 0.25, 1024)
    spec = {"method": "thermal-nerfacto", "fields": fields_of(cfg), "data": str(scene), "steps": STEPS}
    run_ranks({**spec, "group": True}, tmp_path / "group", world=1)
    run_ranks({**spec, "group": False}, tmp_path / "plain", world=1)
    group = json.loads((tmp_path / "group" / "losses.json").read_text())
    plain = json.loads((tmp_path / "plain" / "losses.json").read_text())
    assert group == plain
    pg, pp = np.load(tmp_path / "group" / "params.npz"), np.load(tmp_path / "plain" / "params.npz")
    for k in pp.files:
        np.testing.assert_array_equal(pg[k], pp[k], err_msg=k)


def test_ns_train_spawns_two_ranks(scene, tmp_path):
    """ns-train --trainer.num-devices 2 spawns two gloo ranks that write
    one run directory (the main rank's config.yml, dataparser transforms,
    events and checkpoint), whose parameters are the one-process run's
    (tests/test_torch_parallel.py's flip rule; the sums run in another
    order) and whose logged losses are the global ones."""
    argv = ["thermal-nerfacto-tpu", "--data", str(scene), "--max-num-iterations", "3", "--experiment-name", "x",
            "--trainer.steps-per-log", "1", *TINY_FLAGS]
    for label, extra in (("one", []), ("two", ["--trainer.num-devices", "2"])):
        run_ns_train([*argv, "--output-dir", str(tmp_path / label), *extra], tmp_path)
    runs = {label: next((tmp_path / label / "x" / "thermal-nerfacto-tpu").iterdir()) for label in ("one", "two")}
    assert sorted(p.name for p in runs["two"].iterdir()) == sorted(p.name for p in runs["one"].iterdir())
    events = {k: [json.loads(line) for line in (r / "events.jsonl").read_text().splitlines()] for k, r in runs.items()}
    assert [e["step"] for e in events["two"]] == [e["step"] for e in events["one"]] == [0, 1, 2]
    for a, b in zip(events["one"], events["two"]):
        assert abs(a["train/loss"] - b["train/loss"]) <= 1e-5 * abs(a["train/loss"]), (a["train/loss"], b["train/loss"])
    ckpt = {k: torch.load(next((r / "nerfstudio_models").glob("*.ckpt")), weights_only=True) for k, r in runs.items()}
    assert ckpt["two"]["step"] == ckpt["one"]["step"] == 3
    for name, want in ckpt["one"]["model"].items():
        diff = (ckpt["two"]["model"][name].double() - want.double()).abs()
        assert (diff > 1e-6).double().mean() < MAX_FLIPPED, (name, diff.max())


def port_cfg(scene, rays=32):
    cfg = get_method_config("thermal-nerfacto")
    apply_fields(cfg, fields_of(jax_cfg(scene, "shared", 1.0, rays)))
    cfg.data = scene
    return cfg


def test_host_seed_offset_matches_jax_process_index(scene, tmp_path, monkeypatch):
    """Host 1 (ranks 1 of a 2-host mesh) samples with seed + 7919, as the
    JAX package's process 1: its batches are JAX's, and not host 0's."""
    host1 = mesh.Mesh(world=2, rank=1, local_rank=0, local_world=1, distributed=True)
    cfg = port_cfg(scene)
    seed = cfg.datamanager.seed
    t1 = setup_trainer(cfg, base_dir=tmp_path / "p1", device="cpu", mesh=host1)
    # the offset goes to the data manager's copy of the config, so a second
    # setup of the same config offsets from the same seed
    again = setup_trainer(cfg, base_dir=tmp_path / "p1b", device="cpu", mesh=host1)
    assert cfg.datamanager.seed == seed
    assert t1.datamanager.config.seed == again.datamanager.config.seed == seed + 7919
    t0 = setup_trainer(port_cfg(scene), base_dir=tmp_path / "p0", device="cpu", mesh=mesh.SINGLE)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    jt = jax_method_configs.setup_trainer(jax_cfg(scene, "shared", 1.0, 32), base_dir=tmp_path / "j1")
    monkeypatch.undo()
    for step in (0, 1):
        b1, b0, jb = t1.datamanager.next_train(step), t0.datamanager.next_train(step), jt.datamanager.next_train(step)
        for k in jb:
            np.testing.assert_array_equal(b1[k], jb[k], err_msg=k)
        assert not np.array_equal(b1["ray_indices"], b0["ray_indices"])
    # host 1's rows of the global batch follow host 0's 32
    assert host1.ray_shard(32, 2) == mesh.RayShard(32, 64, 64, False)


def test_shard_rows():
    """Two ranks of one host take the two contiguous halves; the global
    batch of two hosts is host-major."""
    batch = {"ray_indices": np.arange(16 * 3).reshape(16, 3), "image": np.arange(16 * 4).reshape(16, 4)}
    for r in (0, 1):
        m = mesh.Mesh(world=2, rank=r, local_rank=r, local_world=2, distributed=True)
        got = mesh.shard_batch(batch, m, patch_size=2)
        np.testing.assert_array_equal(got["ray_indices"], batch["ray_indices"][8 * r:8 * r + 8])
        assert m.ray_shard(16, 2) == mesh.RayShard(8 * r, 8 * r + 8, 16, r == 0)
    m = mesh.Mesh(world=4, rank=3, local_rank=1, local_world=2, distributed=True)
    assert m.ray_shard(16) == mesh.RayShard(24, 32, 32, False)
    assert (m.host_index, m.num_hosts) == (1, 2)
    assert mesh.shard_batch(batch, mesh.SINGLE) is batch
    shard = mesh.RayShard(8, 16, 16, False)
    assert (shard.prefix(4), shard.prefix(12), shard.prefix(16), shard.weight) == (0, 4, 8, 0.5)


def test_errors(scene, tmp_path):
    """A batch that does not divide over the ranks raises, as JAX's
    sharding does (instant-ngp's dynamic batch buckets too); so does a
    shard that would split a 2x2 patch, and a mesh of several devices
    without a process of its own for each. A model other than
    thermal-nerfacto's takes a process group's mesh."""
    two = mesh.Mesh(world=2, rank=0, local_rank=0, local_world=2, distributed=True)
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_batch({"ray_indices": np.zeros((30, 3))}, mesh.Mesh(4, 0, 0, 4, True))
    with pytest.raises(ValueError):
        jax_mesh.shard_batch({"ray_indices": np.zeros((30, 3))}, jax_mesh.create_mesh(8))
    with pytest.raises(ValueError, match="split a 2x2 patch"):
        mesh.shard_batch({"ray_indices": np.zeros((12, 3))}, two, patch_size=2)
    with pytest.raises(ValueError, match="split a 2x2 patch"):
        two.ray_shard(12, 2)
    with pytest.raises(ValueError, match="a process of its own"):
        mesh.create_mesh(2)
    assert mesh.create_mesh(None) == mesh.SINGLE  # a single process drives one card
    cfg = port_cfg(scene)
    cfg.trainer.num_devices = 2
    with pytest.raises(ValueError, match="a process of its own"):
        setup_trainer(cfg, base_dir=tmp_path, device="cpu")
    # every model takes a process group's mesh
    method = _method(get_method_config, "float32", scene, "nerfacto-tpu", tiny)
    assert setup_trainer(method, base_dir=tmp_path / "n", device="cpu", mesh=two).mesh == two
    # a dynamic batch of 48 rays over 32 ranks does not divide
    with pytest.raises(ValueError, match="does not divide"):
        mesh.Mesh(32, 0, 0, 32, True).ray_shard(48)


def test_several_visible_cards_and_a_model_without_a_data_parallel_step(scene, tmp_path, monkeypatch, capsys):
    """With two visible cards and num_devices left at None, setup_trainer
    trains on one, and ns-train spans both for a method other than
    thermal-nerfacto (nerfacto-tpu, whose model once had no data-parallel
    step): it spawns two ranks, whose run holds the main rank's
    checkpoint after the steps."""
    monkeypatch.setattr(mesh, "visible_devices", lambda device="cuda": 2)
    monkeypatch.setattr(train_script, "visible_devices", lambda device="cuda": 2)
    method = _method(get_method_config, "float32", scene, "nerfacto-tpu", tiny)
    trainer = setup_trainer(method, base_dir=tmp_path / "api", device="cpu")
    assert trainer.mesh == mesh.SINGLE
    trainer.setup()
    assert np.isfinite(float(trainer.train_iteration(0)["loss"]))
    argv = ["nerfacto-tpu", "--data", str(scene), "--max-num-iterations", "2", "--experiment-name", "x", *TINY_FLAGS]
    spawned = []
    monkeypatch.setattr(train_script, "spawn_ranks", lambda world, *a: spawned.append(world) or 0)
    assert train_script.main([*argv, "--output-dir", str(tmp_path / "cli")], device="cpu") == 0
    assert spawned == [2] and "no data-parallel step" not in capsys.readouterr().out
    monkeypatch.undo()
    run_ns_train([*argv, "--output-dir", str(tmp_path / "two"), "--trainer.num-devices", "2"], tmp_path)
    (run,) = (tmp_path / "two" / "x" / "nerfacto-tpu").iterdir()
    assert torch.load(next((run / "nerfstudio_models").glob("*.ckpt")), weights_only=True)["step"] == 2
