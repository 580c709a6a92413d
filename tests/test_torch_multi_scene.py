"""The port's multi-scene training (engine/multi_scene.py) against the JAX
package's vmapped step, on the CPU.

Two synthetic RGBT scenes at tests/parallel/test_multi_scene.py's TINY
thermal-nerfacto, with f32 compute (the method's bf16 rounds the two
frameworks' MLPs apart by ~0.5% in a loss). The JAX side builds its stack as `train_multi_scene`
does (per-scene data, `vmap(init_params)` of the scene keys, one jitted
`vmap(make_ray_train_step(...))`) and runs 2 steps; it does not call
`train_multi_scene` (a 75-80 s call on the CPU). The port's scene
trainers take JAX's stacked params (`load_jax_scene_params`) and each
scene's jitter draws, rebuilt from that scene's key as
tests/test_torch_train.py does. Each scene's losses: rel 1e-4 (f32) at
step 0, 1e-3 at step 1 (tests/test_torch_parallel.py's limits). Its
parameters after 2 steps: the update rel L2 1e-3 outside the entries
that Adam moves the other way (tests/test_torch_parallel.py's rule and
limits, for the same reason).

Then: scene 0 of a two-scene run is bitwise the one-scene run of the same
seed; the per-scene artifact sets reload through the port's `eval_setup`
at the trained step with the trained parameters; ns-train's
comma-separated --data trains a multi-scene run in one process and in
two spawned gloo ranks (one scene each, the same result); and JAX's
ValueErrors.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs.dataparser_configs import build_dataparser as jax_build_dataparser
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.method_configs import resolve_model_class as jax_model_class
from nerfstudio_thermal_tpu.data.datamanagers import VanillaDataManager as JaxDataManager
from nerfstudio_thermal_tpu.engine.optimizers import build_optimizer as jax_build_optimizer
from nerfstudio_thermal_tpu.engine.trainer import TrainState as JaxTrainState
from nerfstudio_thermal_tpu.engine.trainer import make_ray_train_step as jax_make_ray_train_step
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.parallel.test_multi_scene import TINY as JAX_TINY
from tests.test_torch_parallel import FLIP, LATER_LOSS_TOL, LOSS_TOL, MAX_FLIPPED, PARAM_TOL, jitter_draws
from tests.test_torch_eval import TINY_FLAGS

from nerfstudio_thermal_torch.engine.multi_scene import MultiSceneTrainer, split_scene_params, train_multi_scene
from nerfstudio_thermal_torch.parallel import mesh
from nerfstudio_thermal_torch.utils.eval_utils import eval_setup
from nerfstudio_thermal_torch.utils.jax_params import export_jax_stacked, export_jax_tree, load_jax_scene_params
from tests.torch_parallel_worker import flatten, run_ns_train

torch.set_num_threads(1)

SEED = 3
STEPS = 2
TINY = {**JAX_TINY, "compute_dtype": "float32"}  # f32 compute: the f32 tolerances hold


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    return make_synthetic_rgbt_dataset(root / "a", seed=0), make_synthetic_rgbt_dataset(root / "b", seed=5)


def jax_stack(dirs):
    """train_multi_scene's stack (engine/multi_scene.py), for STEPS steps
    of jit(vmap(step)): per scene, the draws and losses of each step, and
    the initial and final stacked params."""
    base = jax_method_config("thermal-nerfacto")
    managers, cams, models = [], [], []
    for d in dirs:
        cfg = jax_method_config("thermal-nerfacto")
        for key, v in TINY.items():
            if "." in key:
                sect, attr = key.split(".", 1)
                setattr(getattr(cfg, sect), attr, v)
            else:
                setattr(cfg.model, key, v)
        cfg.data = cfg.dataparser.data = Path(d)
        dm = JaxDataManager(cfg.datamanager, jax_build_dataparser(cfg.dataparser))
        managers.append(dm)
        cams.append(jax.tree.map(jnp.asarray, dm.train_cameras))
        aabb = np.asarray(dm.train_dataparser_outputs.scene_box, np.float32)
        models.append(jax_model_class(cfg.model)(cfg.model, aabb, num_train_data=len(dm.train_dataset),
                                                 metadata={"is_thermal": list(dm.train_dataset.is_thermal)}))
        base = cfg
    k, model = len(dirs), models[0]
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(SEED), i))(jnp.arange(k))
    params = jax.vmap(model.init_params)(jax.vmap(lambda r: jax.random.split(r)[1])(keys))
    tx = jax_build_optimizer(base.optimizers, jax.tree.map(lambda x: x[0], params))
    state = JaxTrainState(
        params=params, opt_state=jax.vmap(tx.init)(params), step=jnp.zeros((k,), jnp.int32),
        steps_since_update=jnp.zeros((k,), jnp.int32), steps_since_update_thermal=jnp.zeros((k,), jnp.int32),
        rng=jax.vmap(lambda r: jax.random.split(r)[0])(keys), extra=None,
    )
    cameras = jax.tree.map(lambda *xs: jnp.stack(xs), *cams)
    vstep = jax.jit(jax.vmap(jax_make_ray_train_step(model, tx)))
    init = jax.tree.map(np.asarray, params)
    levels, rays = base.model.num_proposal_iterations + 1, base.datamanager.train_num_rays_per_batch
    draws, losses = [[] for _ in dirs], [[] for _ in dirs]
    for step in range(STEPS):
        batches = [dm.next_train(step) for dm in managers]
        for i in range(k):
            draws[i].append(jitter_draws(state.rng[i], levels, rays))
        batch = {key: jnp.asarray(np.stack([b[key] for b in batches])) for key in batches[0]}
        state, scalars = vstep(state, batch, cameras)
        for i in range(k):
            losses[i].append({key: float(v[i]) for key, v in scalars.items()})
    return init, draws, losses, jax.tree.map(np.asarray, state.params), levels


def assert_updates_match(got_tree, want_tree, init_tree):
    got, want, init = flatten(got_tree), flatten(want_tree), flatten(init_tree)
    assert set(got) == set(want)
    for group in sorted({k.split("/")[0] for k in want}):
        keys = sorted(k for k in want if k.split("/")[0] == group)
        p0 = np.concatenate([init[k].ravel() for k in keys]).astype(np.float64)
        want_d = np.concatenate([want[k].ravel() for k in keys]) - p0
        got_d = np.concatenate([got[k].ravel() for k in keys]) - p0
        flipped = np.abs(got_d - want_d) > FLIP * np.abs(want_d).max()
        assert flipped.mean() < MAX_FLIPPED, (group, flipped.mean())
        err = np.linalg.norm(got_d[~flipped] - want_d[~flipped]) / np.linalg.norm(want_d[~flipped])
        assert err <= PARAM_TOL, (group, err)


def test_two_scenes_match_jax_vmapped_step(scenes, tmp_path):
    init, draws, want, want_params, levels = jax_stack(scenes)
    mst = MultiSceneTrainer("thermal-nerfacto", scenes, seed=SEED, out_dir=tmp_path, config_overrides=TINY,
                            device="cpu")
    assert mst.scenes == [0, 1] and len(mst.trainers) == 2
    load_jax_scene_params([t.model for t in mst.trainers], init)
    mst.setup()
    for step in range(STEPS):
        for i, t in enumerate(mst.trainers):
            batch = {k: torch.as_tensor(v) for k, v in t.datamanager.next_train(step).items()}
            uniforms = {name: [torch.as_tensor(draws[i][step][f"{name}/{j}"]) for j in range(levels)]
                        for name in ("rgb", "thermal")}
            got = t._train_step(t.state, batch, uniforms=uniforms)
            assert set(got) == set(want[i][step])
            tol = LOSS_TOL if step == 0 else LATER_LOSS_TOL
            for key, w in want[i][step].items():
                assert abs(float(got[key]) - w) <= tol * max(abs(w), 1e-3), (i, step, key, float(got[key]), w)
    got_params = export_jax_stacked([t.model for t in mst.trainers])
    for i in range(2):
        assert_updates_match(split_scene_params(got_params, i), split_scene_params(want_params, i),
                             split_scene_params(init, i))
    assert want[0][-1]["loss"] != want[1][-1]["loss"]


def test_scene0_is_the_one_scene_run_and_artifacts_reload(scenes, tmp_path):
    """Scene 0 of two trains bitwise as the one-scene run of the seed; each
    scene's artifact set reloads through eval_setup at the trained step."""
    multi = train_multi_scene("thermal-nerfacto", scenes, steps=3, seed=SEED, out_dir=tmp_path / "multi",
                              config_overrides=TINY, log_every=1, device="cpu")
    solo = train_multi_scene("thermal-nerfacto", scenes[:1], steps=3, seed=SEED, out_dir=tmp_path / "solo",
                             config_overrides=TINY, log_every=0, device="cpu")
    assert (multi.num_scenes, multi.num_devices, solo.num_scenes) == (2, 1, 1)
    assert all(np.isfinite(multi.final_losses)) and multi.final_losses[0] != multi.final_losses[1]
    assert multi.final_losses[0] == solo.final_losses[0]
    a, b = export_jax_tree(multi.trainers[0].model), export_jax_tree(solo.trainers[0].model)
    for k, v in flatten(b).items():
        np.testing.assert_array_equal(flatten(a)[k], v, err_msg=k)
    runs = sorted(multi.checkpoint_dir.glob("scene_*"))
    assert [r.name for r in runs] == ["scene_0_a", "scene_1_b"]
    for run, trainer in zip(runs, multi.trainers):
        assert (run / "dataparser_transforms.json").exists()
        events = [json.loads(line) for line in (run / "events.jsonl").read_text().splitlines()]
        assert [e["step"] for e in events] == [0, 1, 2]
        _, reloaded = eval_setup(run / "config.yml", device="cpu")
        assert reloaded.state.step == 3
        want = flatten(export_jax_tree(trainer.model))
        for k, v in flatten(export_jax_tree(reloaded.model)).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_ns_train_comma_separated_data(scenes, tmp_path):
    """ns-train --data A,B writes one run per scene under
    multi_2scenes/METHOD/TIMESTAMP; with --trainer.num-devices 2 two gloo
    ranks train one scene each, to the same parameters."""
    flags = ["--data", f"{scenes[0]},{scenes[1]}", "--max-num-iterations", "2", *TINY_FLAGS]
    for label, extra in (("one", []), ("two", ["--trainer.num-devices", "2"])):
        run_ns_train(["thermal-nerfacto-tpu", "--output-dir", str(tmp_path / label), *flags, *extra], tmp_path)
    params = {}
    for label in ("one", "two"):
        (stamp,) = (tmp_path / label / "multi_2scenes" / "thermal-nerfacto-tpu").iterdir()
        runs = sorted(stamp.glob("scene_*"))
        assert [r.name for r in runs] == ["scene_0_a", "scene_1_b"]
        params[label] = [torch.load(next((r / "nerfstudio_models").glob("step-*.ckpt")), weights_only=True)
                         for r in runs]
    for one, two in zip(params["one"], params["two"]):
        assert one["step"] == two["step"] == 2
        for k, v in one["model"].items():
            assert torch.equal(v, two["model"][k]), k


def test_jax_errors(scenes, tmp_path):
    """Each ValueError of JAX's train_multi_scene, with its message."""
    fewer = make_synthetic_rgbt_dataset(tmp_path / "fewer", num_pairs=3)
    with pytest.raises(ValueError, match="training images but scene 0 has"):
        MultiSceneTrainer("thermal-nerfacto", [scenes[0], fewer], config_overrides=TINY, device="cpu",
                          out_dir=tmp_path / "o1")
    swapped = make_synthetic_rgbt_dataset(tmp_path / "swapped")
    meta = json.loads((swapped / "transforms.json").read_text())
    first_rgb = next(f for f in meta["frames"] if not f.get("is_thermal"))
    first_thermal = next(f for f in meta["frames"] if f.get("is_thermal"))
    first_rgb["is_thermal"], first_thermal["is_thermal"] = 1, 0  # as many frames, another layout
    (swapped / "transforms.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="different is_thermal layout"):
        MultiSceneTrainer("thermal-nerfacto", [scenes[0], swapped], config_overrides=TINY, device="cpu",
                          out_dir=tmp_path / "o2")
    with pytest.raises(ValueError, match="ray-batch methods"):
        MultiSceneTrainer("splatfacto", list(scenes), device="cpu", out_dir=tmp_path / "o3")
    two = mesh.Mesh(world=2, rank=0, local_rank=0, local_world=2, distributed=True)
    with pytest.raises(ValueError, match="3 scenes do not divide evenly over 2 devices"):
        MultiSceneTrainer("thermal-nerfacto", [*scenes, scenes[0]], config_overrides=TINY, device="cpu", mesh=two)
    with pytest.raises(ValueError, match="need at least one scene"):
        MultiSceneTrainer("thermal-nerfacto", [], device="cpu")
