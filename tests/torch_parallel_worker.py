"""A rank of the port's data-parallel trainer on the CPU (gloo), for
tests/test_torch_parallel.py. Imports torch and the port only: the test
process spawns it with `python -m tests.torch_parallel_worker SPEC RANK`.

SPEC (JSON) holds the rendezvous port, the world, the device and
backend (default: the CPU, gloo), the tiny config's fields, the scene,
the npz of the JAX parameters and draws to carry in (or none: the port's
own draws) and where to write. Rank 0 writes the global losses of each
step and the parameters after the last step in the JAX layout; every rank
writes its rows of each step's batch. `write_scene` writes a tiny RGBT
scene with the port's PNG writer (the card's machine has no Pillow).
"""

import json
import os
import subprocess
import sys
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
    spec = {**spec, "world": world, "port": free_port(), "out": str(tmp)}
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", str(path), str(r)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
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


def run(spec: dict, rank: int) -> None:
    torch.set_num_threads(1)
    device = spec.get("device", "cpu")
    if spec["world"] > 1 or spec.get("group", True):
        initialize_distributed(f"tcp://localhost:{spec['port']}", spec["world"], rank, device=device,
                               backend=spec.get("backend"))
    config = get_method_config(spec["method"])
    apply_fields(config, spec["fields"])
    config.data = Path(spec["data"])
    out = Path(spec["out"])
    trainer = setup_trainer(config, base_dir=out / f"rank{rank}", device=device)
    carried = np.load(spec["carry"]) if spec.get("carry") else None
    if carried is not None:
        load_jax_params(trainer.model, unflatten({k[len("params/"):]: carried[k] for k in carried.files
                                                  if k.startswith("params/")}))
    trainer.setup()
    mesh, patch = trainer.mesh, config.datamanager.patch_size
    losses, rows = [], {}
    for step in range(spec["steps"]):
        batch = trainer.datamanager.next_train(step)
        shard = mesh.ray_shard(len(batch["ray_indices"]), patch)
        local = shard_batch(batch, mesh, patch)
        rows[f"ray_indices/{step}"] = np.asarray(local["ray_indices"])
        kwargs = {"shard": shard} if shard is not None else {}
        if carried is not None:
            kwargs["uniforms"] = {
                name: [torch.as_tensor(carried[f"uniforms/{step}/{name}/{i}"]) for i in range(spec["levels"])]
                for name in ("rgb", "thermal")
            }
        batch = {k: torch.as_tensor(v).to(device) for k, v in local.items()}
        scalars = trainer._train_step(trainer.state, batch, **kwargs)
        losses.append({k: float(v) for k, v in scalars.items()})
    np.savez(out / f"rows{rank}.npz", **rows)
    if rank == 0:
        (out / "losses.json").write_text(json.dumps(losses))
        np.savez(out / "params.npz", **flatten(export_jax_tree(trainer.model)))
    if mesh.distributed:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    run(json.loads(Path(sys.argv[1]).read_text()), int(sys.argv[2]))
