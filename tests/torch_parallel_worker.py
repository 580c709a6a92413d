"""A rank of the port's data-parallel trainer on the CPU (gloo), for
tests/test_torch_parallel.py and tests/test_torch_parallel_methods.py.
Imports torch and the port only: the test process spawns it with
`python -m tests.torch_parallel_worker SPEC RANK`.

SPEC (JSON) holds the rendezvous port, the world, the device and
backend (default: the CPU, gloo), whether a one-rank run joins a group,
and where to write. Two modes:
- one method's steps through `Trainer._train_step` (the default): the
  tiny config's fields, the scene, the npz of the JAX parameters and
  draws to carry in (or none: the port's own draws). Rank 0 writes the
  global losses of each step, the parameters after the last step in the
  JAX layout and, with "grads", their gradients of the first step as the
  optimizers took them; every rank writes its rows of each step's batch.
- "methods": ns-train (`scripts.train.main`, in this process) of each
  named tiny configuration of `TINY` in turn, with `--trainer.num-devices`
  the world when it is more than one. Each rank writes, per
  configuration, the scalars of every step (`Trainer.train_iteration`'s,
  the global values) and the state dict and extra state before and after
  the run. A plain run records the coarse weights that the pdf sampler
  of each step of the labels in "record_pdf" resampled; ranks with
  "replay_pdf" (the plain run's directory) resample their rows of them,
  so both runs place the same fine samples (`pdf_weights`). "fault"
  ({"label", "rank", "grad_scale"}) scales that rank's gradients before
  the all-reduce, a negative control.
`write_scene` writes a tiny RGBT scene with the port's PNG writer (the
card's machine has no Pillow).
"""

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.parallel.mesh import free_port, initialize_distributed, shard_batch
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params


REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 240  # seconds for one rank's whole run


def run_ranks(spec: dict, tmp: Path, world: int) -> None:
    """`world` ranks of `run` as processes of their own, each with its own
    timeout (a hung rendezvous fails instead of hanging)."""
    run_groups([(spec, tmp, world)])


def run_groups(groups) -> None:
    """Several (spec, dir, world) runs of `run_ranks` at once: every
    process of every group started together, each with its own timeout."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = []
    for spec, tmp, world in groups:
        spec = {**spec, "world": world, "port": free_port(), "out": str(tmp)}
        tmp.mkdir(parents=True, exist_ok=True)
        path = tmp / "spec.json"
        path.write_text(json.dumps(spec))
        procs += [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", str(path), str(r)],
                                   cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                  for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def run_ns_train(argv, cwd: Path, device: str = "cpu") -> None:
    """ns-train's main(argv, device=device) in a process of its own, with
    a timeout (it may spawn ranks)."""
    code = f"import sys; from nerfstudio_thermal_torch.scripts.train import main; sys.exit(main({argv!r}, device={device!r}))"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=RANK_TIMEOUT)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]


def unflatten(flat: dict) -> dict:
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def apply_fields(config, fields: dict) -> None:
    """{"model.x": v, "datamanager.y": v, ...} onto a method config."""
    for key, value in fields.items():
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = getattr(node, p)
        setattr(node, parts[-1], tuple(value) if isinstance(getattr(node, parts[-1]), tuple) else value)


def write_scene(root: Path, num_pairs: int = 4) -> Path:
    """tests/fixtures.make_synthetic_rgbt_dataset's layout (RGB 16 x 20,
    thermal 12 x 16, on a ring), random pixels, written without Pillow."""
    from nerfstudio_thermal_torch.utils.writer import write_png
    from tests.fixtures import look_at

    gen = np.random.default_rng(0)
    frames = []
    for modality, (h, w), sub in (("rgb", (16, 20), "images"), ("thermal", (12, 16), "images_thermal")):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for i in range(num_pairs):
            ang = 2 * np.pi * i / num_pairs
            c2w = look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.0]))
            img = gen.integers(0, 256, (h, w, 3 if modality == "rgb" else 1), dtype=np.uint8)
            write_png(root / sub / f"{i:03d}.png", img)
            frames.append({"file_path": f"{sub}/{i:03d}.png", "transform_matrix": c2w.tolist(), "fl_x": 0.8 * w,
                           "fl_y": 0.8 * w, "cx": w / 2, "cy": h / 2, "w": w, "h": h,
                           "is_thermal": int(modality == "thermal")})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    return root


# ---- the tiny configuration of every method, for the "methods" mode ---------

HASH = dict(num_levels=3, base_res=4, max_res=32, log2_hashmap_size=9, hidden_dim=16, hidden_dim_color=16,
            appearance_embed_dim=4, num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4,
            num_proposal_iterations=2, proposal_net_args_list=[
                {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 16, "use_linear": False},
                {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 32, "use_linear": True}])
FREQ = dict(HASH, freq_num_layers=4, freq_hidden_dim=128, freq_num_frequencies=4, proposal_net_args_list=None)
NGP = dict(num_levels=4, log2_hashmap_size=10, max_res=64, num_samples_per_ray=16, grid_resolution=16,
           appearance_embed_dim=4, grid_update_every=2)
CLASSIC = dict(num_coarse_samples=6, num_importance_samples=5, num_uniform_samples=10, num_samples=4, resolution=8,
               final_resolution=12, density_components=3, color_components=4, appearance_dim=5,
               upsampling_iters=(0,))
NEUS = dict(sdf_num_layers=5, sdf_hidden_dim=96, sdf_geo_feat_dim=16, sdf_num_layers_color=2, sdf_hidden_dim_color=16,
            num_samples=8, num_samples_importance=8, num_up_sample_steps=2, num_samples_outside=6)
NEUS_FACTO = dict(sdf_hidden_dim=32, sdf_geo_feat_dim=8, sdf_hidden_dim_color=16, num_proposal_samples_per_ray=(12, 8),
                  num_neus_samples_per_ray=6, proposal_net_args_list=[
                      {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 5, "max_res": 64},
                      {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 5, "max_res": 256}])
SPLAT = dict(num_random=96, max_num_gaussians=160, random_scale=1.5, warmup_length=0, refine_every=1,
             densify_grad_thresh=1e-6)
GEN = dict(render_resolution=16, num_levels=4, log2_hashmap_size=10, max_res=64, hidden_dim=16,
           num_proposal_samples_per_ray=(8, 6), num_nerf_samples_per_ray=4, start_normals_training=0,
           start_lambertian_training=0, proposal_net_args_list=[
               {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 4, "max_res": 32},
               {"hidden_dim": 16, "log2_hashmap_size": 10, "num_levels": 4, "max_res": 64}])
# the surface models' SDF grid and background field (no config knob sets them)
SDF_GRID = dict(num_levels=4, log2_hashmap_size=10, max_res=64)
BACKGROUND = dict(base_mlp_num_layers=3, base_mlp_layer_width=32, head_mlp_layer_width=16, skip_connections=())

# label: (method, scene key or None, model fields, rays a step, steps)
TINY = {
    "thermal-nerfacto": ("thermal-nerfacto", "rgbt", HASH, 64, 2),
    "thermal-nerfacto-tpu": ("thermal-nerfacto-tpu", "rgbt", FREQ, 64, 2),
    "nerfacto": ("nerfacto", "rgbt", HASH, 64, 2),
    "nerfacto-tpu": ("nerfacto-tpu", "rgbt", FREQ, 64, 2),
    "nerfacto-big": ("nerfacto-big", "rgbt", HASH, 64, 2),
    "nerfacto-huge": ("nerfacto-huge", "rgbt", HASH, 64, 2),
    "depth-nerfacto": ("depth-nerfacto", "depth", HASH, 64, 2),
    "semantic-nerfw": ("semantic-nerfw", "sitcoms", HASH, 64, 2),
    "instant-ngp": ("instant-ngp", "rgbt", NGP, 64, 3),
    "instant-ngp-bounded": ("instant-ngp-bounded", "ingp", NGP, 64, 3),
    "vanilla-nerf": ("vanilla-nerf", "blender", CLASSIC, 16, 2),
    "mipnerf": ("mipnerf", "blender", CLASSIC, 16, 2),
    "tensorf": ("tensorf", "blender", CLASSIC, 16, 2),
    "neus": ("neus", "rgbt", NEUS, 64, 2),
    "neus-facto": ("neus-facto", "rgbt", NEUS_FACTO, 64, 2),
    "splatfacto": ("splatfacto", "splat", SPLAT, None, 2),
    "generfacto": ("generfacto", None, GEN, None, 2),
}


def tiny_config(label: str, config):
    """A method config cut to TINY[label]'s widths, f32, no evals."""
    _, _, fields, rays, _ = TINY[label]
    m = config.model
    for k, v in fields.items():
        if k == "proposal_net_args_list" and v is None:
            continue
        if hasattr(m, k):
            setattr(m, k, type(getattr(m, k))(v) if isinstance(getattr(m, k), tuple) else v)
    if hasattr(m, "compute_dtype"):
        m.compute_dtype = "float32"
    m.eval_num_rays_per_chunk = 64
    if label == "generfacto":
        config.datamanager.resolution = GEN["render_resolution"]
    if label == "semantic-nerfw":
        from nerfstudio_thermal_torch.data.dataparsers.scene_parsers import Sitcoms3DDataParserConfig

        config.dataparser = Sitcoms3DDataParserConfig()
    if rays is not None:
        config.datamanager.train_num_rays_per_batch = rays
    if hasattr(config.datamanager, "use_native_sampler"):
        config.datamanager.use_native_sampler = False
    if config.dynamic_batch is not None:
        config.dynamic_batch = dataclasses.replace(config.dynamic_batch, update_every=2, target_num_samples=512,
                                                   min_num_rays_per_batch=16, max_num_rays_per_batch=128)
    t = config.trainer
    t.steps_per_eval_batch = t.steps_per_eval_image = t.steps_per_eval_all_images = 0
    t.steps_per_log, t.steps_per_save = 1, 10**6
    return config


def small_surface_fields() -> None:
    """The surface models' small SDF grid and background field, in this
    process."""
    from nerfstudio_thermal_torch.fields import sdf_field, vanilla_nerf_field
    from nerfstudio_thermal_torch.models import base_surface_model

    base_surface_model.SDFField = functools.partial(sdf_field.SDFField, **SDF_GRID)
    base_surface_model.NeRFField = functools.partial(vanilla_nerf_field.NeRFField, **BACKGROUND)


@contextlib.contextmanager
def pdf_weights(label: str, spec: dict, rank: int):
    """While open, vanilla-nerf's and mipnerf's pdf sampler (through
    models/vanilla_nerf.py) records (spec "record_pdf") or replays (spec
    "replay_pdf") the coarse weights of each training step's resample.
    A rank's coarse field, evaluated on its half of the rays, gives
    weights one ulp from the plain run's; the pdf sampler moves the fine
    samples by as much, and the fine field's 10 position frequencies turn
    that into gradients ~0.5% apart, which Adam's second step turns into
    sign flips. The weights carry no gradient (pdf_sample detaches them),
    so replaying the plain run's leaves what the step differentiates as
    it was."""
    from nerfstudio_thermal_torch.models import vanilla_nerf

    out = Path(spec["out"])
    record = label in spec.get("record_pdf", ())
    replay = spec.get("replay_pdf", {}).get(label)
    if not (record or replay):
        yield
        return
    inner, calls = vanilla_nerf.pdf_sample, []
    if replay:
        path = Path(replay) / f"{label}_pdf.npz"
        deadline = time.monotonic() + RANK_TIMEOUT
        while not path.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"no {path}")
            time.sleep(0.2)
        saved = np.load(path)
        calls = [torch.as_tensor(saved[str(i)]) for i in range(len(saved.files))]

    def sampled(ray_bundle, ray_samples, weights, num_samples, *, train=False, shard=None, **kwargs):
        if train and record:
            calls.append(weights.detach().cpu().numpy().copy())
        elif train:
            w = calls.pop(0)
            weights = (shard.local(w) if shard is not None else w).to(weights)
        return inner(ray_bundle, ray_samples, weights, num_samples, train=train, shard=shard, **kwargs)

    vanilla_nerf.pdf_sample = sampled
    try:
        yield
    finally:
        vanilla_nerf.pdf_sample = inner
    if record and rank == 0:
        tmp = out / f"{label}_pdf.tmp.npz"
        np.savez(tmp, **{str(i): w for i, w in enumerate(calls)})
        tmp.rename(out / f"{label}_pdf.npz")


@contextlib.contextmanager
def faulty_rank(label: str, spec: dict, rank: int):
    """While open, this rank's gradients are scaled by spec["fault"]'s
    grad_scale before the all-reduce, when the fault names this label and
    rank."""
    from nerfstudio_thermal_torch.engine import trainer

    fault = spec.get("fault") or {}
    if fault.get("label") != label or fault.get("rank") != rank:
        yield
        return
    inner = trainer.all_reduce_grads

    def scaled(params):
        for p in params:
            if p.grad is not None:
                p.grad.mul_(fault["grad_scale"])
        return inner(params)

    trainer.all_reduce_grads = scaled
    try:
        yield
    finally:
        trainer.all_reduce_grads = inner


def state_arrays(trainer) -> dict:
    """The model's state dict and the extra state's tensors, as numpy."""
    out = {f"model/{k}": v.detach().cpu().numpy().copy() for k, v in trainer.model.state_dict().items()}
    extra = trainer.state.extra
    if dataclasses.is_dataclass(extra):
        out.update({f"extra/{k}": np.array(v.cpu() if isinstance(v, torch.Tensor) else v)
                    for k, v in dataclasses.asdict(extra).items()})
    return out


def run_methods(spec: dict, rank: int) -> None:
    """ns-train of each of spec["methods"] (TINY labels) in this rank."""
    from nerfstudio_thermal_torch.engine.trainer import Trainer
    from nerfstudio_thermal_torch.scripts import train as train_script

    small_surface_fields()
    out = Path(spec["out"])
    get = train_script.get_method_config
    record = {}
    train, train_iteration = Trainer.train, Trainer.train_iteration

    def recorded_train(self):
        record["before"] = state_arrays(self)
        train(self)
        record["after"] = state_arrays(self)

    def recorded_iteration(self, step):
        scalars = train_iteration(self, step)
        record["scalars"].append({k: float(v) for k, v in scalars.items()})
        return scalars

    Trainer.train, Trainer.train_iteration = recorded_train, recorded_iteration
    for label in spec["methods"]:
        method, scene, _, _, steps = TINY[label]
        train_script.get_method_config = lambda name, label=label: tiny_config(label, get(name))
        record.clear()
        record["scalars"] = []
        argv = [method, "--max-num-iterations", str(steps), "--output-dir", str(out / "runs"),
                "--experiment-name", label]
        if scene is not None:
            argv += ["--data", spec["scenes"][scene]]
        if spec["world"] > 1:
            argv += ["--trainer.num-devices", str(spec["world"])]
        with pdf_weights(label, spec, rank), faulty_rank(label, spec, rank):
            if train_script.main(argv, device=spec.get("device", "cpu"), timestamp="run") != 0:
                raise RuntimeError(f"ns-train {label} failed")
        (out / f"{label}_rank{rank}.json").write_text(json.dumps(record["scalars"]))
        np.savez(out / f"{label}_rank{rank}.npz", **{f"before/{k}": v for k, v in record["before"].items()},
                 **{f"after/{k}": v for k, v in record["after"].items()})


def carried_uniforms(carried, step: int) -> dict:
    """The jitter draws `uniforms/{step}/{name}/{i}` of an npz as the
    step's `uniforms` ({name: [level 0, level 1, ...]})."""
    prefix = f"uniforms/{step}/"
    names = {}
    for key in carried.files:
        if key.startswith(prefix):
            name, i = key[len(prefix):].split("/")
            names.setdefault(name, {})[int(i)] = torch.as_tensor(carried[key])
    return {name: [levels[i] for i in sorted(levels)] for name, levels in names.items()}


def run(spec: dict, rank: int) -> None:
    torch.set_num_threads(1)
    device = spec.get("device", "cpu")
    if spec["world"] > 1 or spec.get("group", True):
        initialize_distributed(f"tcp://localhost:{spec['port']}", spec["world"], rank, device=device,
                               backend=spec.get("backend"))
    if "methods" in spec:
        run_methods(spec, rank)
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
            torch.distributed.destroy_process_group()
        return
    if spec.get("small_surface_fields"):
        small_surface_fields()
    config = get_method_config(spec["method"])
    apply_fields(config, spec["fields"])
    if spec.get("sdfstudio_mono_prior"):
        from nerfstudio_thermal_torch.data.dataparsers.sdfstudio_dataparser import SDFStudioDataParserConfig

        config.dataparser = SDFStudioDataParserConfig(include_mono_prior=True)
    config.data = Path(spec["data"])
    out = Path(spec["out"])
    trainer = setup_trainer(config, base_dir=out / f"rank{rank}", device=device)
    carried = np.load(spec["carry"]) if spec.get("carry") else None
    if carried is not None:
        load_jax_params(trainer.model, unflatten({k[len("params/"):]: carried[k] for k in carried.files
                                                  if k.startswith("params/")}))
    trainer.setup()
    mesh, patch = trainer.mesh, config.datamanager.patch_size
    losses, rows, grads = [], {}, None
    for step in range(spec["steps"]):
        batch = trainer.datamanager.next_train(step)
        shard = mesh.ray_shard(len(batch["ray_indices"]), patch)
        local = shard_batch(batch, mesh, patch)
        rows[f"ray_indices/{step}"] = np.asarray(local["ray_indices"])
        kwargs = {"shard": shard} if shard is not None else {}
        if carried is not None:
            kwargs["uniforms"] = carried_uniforms(carried, step)
        batch = {k: torch.as_tensor(v).to(device) for k, v in local.items()}
        scalars = trainer._train_step(trainer.state, batch, **kwargs)
        losses.append({k: float(v) for k, v in scalars.items()})
        if grads is None and spec.get("grads"):
            grads = flatten(export_jax_tree(trainer.model, grads=True))
    np.savez(out / f"rows{rank}.npz", **rows)
    if rank == 0:
        (out / "losses.json").write_text(json.dumps(losses))
        np.savez(out / "params.npz", **flatten(export_jax_tree(trainer.model)))
        if grads is not None:
            np.savez(out / "grads.npz", **grads)
    if mesh.distributed:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    run(json.loads(Path(sys.argv[1]).read_text()), int(sys.argv[2]))
