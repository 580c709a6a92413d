"""Multi-scene training: K scenes of one method config
(counterpart of nerfstudio_thermal_tpu/engine/multi_scene.py).

The JAX package stacks every per-scene quantity (params, optimizer state,
RNG, cameras, ray batches) on a leading `scene` axis and vmaps its
single-scene step over it, sharded over a 1-D `scene` mesh. Here each
scene is a `Trainer` of its own (model, optimizers, `TrainState` and
generator) and a rank steps its scenes in turn, with no cross-scene
traffic: K scenes on one card run one after the other, and with D ranks
(`initialize_distributed`; ns-train spawns them for
--trainer.num-devices) each rank trains its K / D consecutive scenes.
Scene i trains from seed + i (model and generator; JAX folds i into its
key), so scene 0 is the run ns-train makes of that scene alone.

JAX's checks stand, with its messages: equal training-image counts
(JAX's shared module sizes the per-camera tables once; the port keeps
the rule, so a run means the same in both packages), an equal
`is_thermal` layout for the thermal methods, ray-batch methods only, and
K a multiple of the ranks (trimmed to K when there are more). The port
stacks no cameras, so none are padded.

Each scene writes the standard artifact set, `scene_{i}_{name}/`
config.yml, dataparser_transforms.json and nerfstudio_models/step-*.ckpt
(the trainer's checkpoint), which ns-eval-torch, ns-render-torch and
ns-viewer-torch load as any run. utils/jax_params.py carries JAX's
stacked params into the scenes' models and back (`load_jax_scene_params`,
`export_jax_stacked`); its `split_scene_params` slices a stacked tree and
is re-exported here under the JAX module's name.

    summary = train_multi_scene("thermal-nerfacto", [dir1, dir2], steps=30000)
"""

import copy
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from nerfstudio_thermal_torch.configs.dataparser_configs import build_dataparser
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, resolve_model_class, setup_trainer
from nerfstudio_thermal_torch.models.generfacto import GenerfactoModelConfig
from nerfstudio_thermal_torch.models.splatfacto import SplatfactoModelConfig
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
from nerfstudio_thermal_torch.parallel.mesh import SINGLE, Mesh, create_mesh
from nerfstudio_thermal_torch.utils.jax_params import split_scene_params  # noqa: F401  (the JAX module's name)


@dataclass
class MultiSceneSummary:
    num_scenes: int
    num_devices: int
    steps: int
    final_losses: List[float]  # per scene
    checkpoint_dir: Optional[Path]
    trainers: List[Any] = field(default_factory=list)
    """This rank's scenes' trainers, in scene order."""
    step_s: float = float("nan")
    """Wall seconds a step of this rank's scenes, over the steps after the
    first (its logging included)."""


def _apply_overrides(cfg, overrides: Dict[str, Any]) -> None:
    """"datamanager.x" / "trainer.x" / "dataparser.x" set that section's
    field; bare keys are model fields (as in the JAX package)."""
    for key, v in overrides.items():
        if "." in key:
            sect, attr = key.split(".", 1)
            setattr(getattr(cfg, sect), attr, v)
        else:
            setattr(cfg.model, key, v)


def scene_name(i: int, data_dir: Path) -> str:
    return f"scene_{i}_{Path(data_dir).name}"


class MultiSceneTrainer:
    """This rank's scenes' trainers, built and checked as the JAX package
    builds and checks its stack."""

    def __init__(
        self,
        method: Any,
        data_dirs: Sequence[Path],
        num_devices: Optional[int] = None,
        seed: int = 42,
        out_dir: Optional[Path] = None,
        config_overrides: Optional[Dict[str, Any]] = None,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[Mesh] = None,
    ):
        """`mesh`: the ranks the scenes spread over (default: `create_mesh`
        of num_devices)."""
        k = len(data_dirs)
        if k < 1:
            raise ValueError("need at least one scene")
        base = get_method_config(method) if isinstance(method, str) else method
        mesh = mesh if mesh is not None else create_mesh(num_devices)
        ranks = min(mesh.world, k)
        if k % ranks:
            raise ValueError(f"{k} scenes do not divide evenly over {ranks} devices")
        self.num_scenes, self.num_devices, self.mesh = k, ranks, mesh
        self.data_dirs = [Path(d) for d in data_dirs]
        per = k // ranks
        self.scenes = list(range(mesh.rank * per, (mesh.rank + 1) * per)) if mesh.rank < ranks else []
        self.out_dir = Path(out_dir).resolve() if out_dir is not None else None
        self.configs = []
        for i, d in enumerate(self.data_dirs):
            cfg = copy.deepcopy(base)
            _apply_overrides(cfg, config_overrides or {})
            cfg.data = d
            cfg.dataparser.data = d
            cfg.trainer.seed = seed + i
            cfg.trainer.num_devices = 1
            self.configs.append(cfg)
        model_cfg = self.configs[0].model
        if isinstance(model_cfg, (SplatfactoModelConfig, GenerfactoModelConfig)):
            raise ValueError(
                "multi-scene batching supports ray-batch methods (nerfacto "
                "family); rasterization/generative methods train per scene"
            )
        counts, layouts = self._scene_layouts()
        for i in range(1, k):
            if counts[i] != counts[0]:
                raise ValueError(
                    f"scene {i} has {counts[i]} training images but "
                    f"scene 0 has {counts[0]}; multi-scene batching shares one module, "
                    "so per-camera tables require equal image counts"
                )
        thermal = issubclass(resolve_model_class(model_cfg), ThermalNerfactoModel)
        for i in range(1, k):
            if layouts[i] != layouts[0] and thermal:
                raise ValueError(
                    f"scene {i} has a different is_thermal layout than scene 0; "
                    "thermal multi-scene batching requires identical rigs"
                )
        self.trainers = [
            setup_trainer(
                copy.deepcopy(self.configs[i]), device=device, mesh=SINGLE,
                base_dir=self.out_dir / scene_name(i, self.data_dirs[i]) if self.out_dir is not None else None,
            )
            for i in self.scenes
        ]

    def _scene_layouts(self):
        """Each scene's training-image count and is_thermal layout, from
        its dataparser (no image is read)."""
        counts, layouts = [], []
        for cfg in self.configs:
            outputs = build_dataparser(copy.deepcopy(cfg.dataparser)).get_dataparser_outputs(split="train")
            n = len(outputs.image_filenames)
            thermal = outputs.metadata.get("is_thermal")
            counts.append(n)
            layouts.append([int(t) for t in thermal] if thermal is not None else [0] * n)
        return counts, layouts

    def setup(self) -> None:
        for t in self.trainers:
            t.setup()

    def train_iteration(self, step: int) -> List[Dict[str, torch.Tensor]]:
        """One step of each of this rank's scenes, in turn."""
        return [t.train_iteration(step) for t in self.trainers]

    def save(self, steps: int) -> None:
        """Each scene's standard artifact set under out_dir."""
        from nerfstudio_thermal_torch.configs.serialization import save_config

        for i, t in zip(self.scenes, self.trainers):
            save_config(self.configs[i], t.base_dir / "config.yml")
            (t.base_dir / "dataparser_transforms.json").write_text(
                json.dumps(t.datamanager.train_dataparser_outputs.as_dict(), indent=2)
            )
            t.save_checkpoint(steps)


def train_multi_scene(
    method: Any,
    data_dirs: Sequence[Path],
    steps: int = 1000,
    num_devices: Optional[int] = None,
    seed: int = 42,
    out_dir: Optional[Path] = None,
    config_overrides: Optional[Dict[str, Any]] = None,
    log_every: int = 100,
    device: Union[str, torch.device] = "cuda",
) -> MultiSceneSummary:
    """`method` is a registered method name or an already overridden
    MethodConfig (ns-train passes its config so user flags survive); each
    scene gets its own deep copy. Every `log_every` steps (and the last)
    each scene's losses are printed and written to its events.jsonl.
    Inside a process group of D ranks each trains its K / D scenes; the
    summary's final losses are every scene's."""
    mst = MultiSceneTrainer(method, data_dirs, num_devices, seed, out_dir, config_overrides, device)
    mst.setup()
    scalars = [None] * len(mst.trainers)
    t_first = None
    for step in range(steps):
        if step == 1:
            _synchronize(mst)
            t_first = time.perf_counter()
        scalars = mst.train_iteration(step)
        if log_every and (step % log_every == 0 or step == steps - 1):
            for t, s in zip(mst.trainers, scalars):
                t.writer.write_scalar_dict({key: float(v) for key, v in s.items()}, step, group="train")
            print(f"step {step}: " + " ".join(
                f"scene{i}={float(s['loss']):.4f}" for i, s in zip(mst.scenes, scalars)), flush=True)
    _synchronize(mst)
    step_s = (time.perf_counter() - t_first) / (steps - 1) if t_first is not None else float("nan")
    local = {i: float(s["loss"]) if s is not None else float("nan") for i, s in zip(mst.scenes, scalars)}
    if mst.mesh.distributed:
        gathered = [None] * mst.mesh.world
        dist.all_gather_object(gathered, local)
        for part in gathered:
            local.update(part)
    if mst.out_dir is not None:
        mst.save(steps)
    return MultiSceneSummary(
        num_scenes=mst.num_scenes,
        num_devices=mst.num_devices,
        steps=steps,
        final_losses=[local.get(i, float("nan")) for i in range(mst.num_scenes)],
        checkpoint_dir=mst.out_dir,
        trainers=mst.trainers,
        step_s=step_s,
    )


def _synchronize(mst: MultiSceneTrainer) -> None:
    for t in mst.trainers:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
