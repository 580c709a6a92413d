"""Trainer: the ray-batch train step and the host loop
(counterpart of nerfstudio_thermal_tpu/engine/trainer.py).

The JAX package jits one pure step over a TrainState pytree. Here the
parameters live in the model, the per-group Adam state in `Optimizers`,
and `TrainState` carries the rest: the step, both proposal-update counters
and the generator of the sampling jitter. `make_ray_train_step` does what
the JAX step does, in the same order: ray generation from
batch["ray_indices"] (the camera optimizers apply inside the model), the
forward with the proposal anneal and update flags of this step, metrics,
losses (their sum in sorted key order), backward, one update of every
group, the counters.

`Trainer.setup` / `train` run the loop with the rays/s and iteration-time
scalars and checkpoints through torch.save (`train` always saves at the
end). The eval cadences, the viewer, the profiler and gradient
accumulation are later work; the eval cadences raise when reached with
eval data present.
"""

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from nerfstudio_thermal_torch.engine.optimizers import (
    OptimizerGroupConfig,
    Optimizers,
    build_optimizer,
)
from nerfstudio_thermal_torch.model_components.ray_generators import RayGenerator
from nerfstudio_thermal_torch.models.nerfacto import proposal_anneal, proposal_updated
from nerfstudio_thermal_torch.pipelines.base_pipeline import VanillaPipeline
from nerfstudio_thermal_torch.utils.precision import pin_precision
from nerfstudio_thermal_torch.utils.writer import EventName, Writer

_EVAL_SLICE = "evaluation during training arrives with the eval-surface slice of the port"


@dataclass
class TrainState:
    """What the JAX TrainState holds besides params and optimizer state."""

    generator: torch.Generator
    step: int = 0
    steps_since_update: int = 0  # proposal update counter (rgb)
    steps_since_update_thermal: int = 0


@dataclass
class TrainerConfig:
    max_num_iterations: int = 30000
    steps_per_save: int = 2000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 500
    steps_per_eval_all_images: int = 25000
    steps_per_log: int = 10
    mixed_precision: bool = True
    save_only_latest_checkpoint: bool = True
    load_dir: Optional[Path] = None
    load_step: Optional[int] = None
    seed: int = 42
    output_dir: Path = Path("outputs")
    experiment_name: str = "experiment"
    method_name: str = "method"
    timestamp: str = "{timestamp}"
    use_tensorboard: bool = False
    use_wandb: bool = False
    use_comet: bool = False
    gradient_accumulation_steps: int = 1
    profiler: str = "none"
    vis: str = "none"
    viewer_port: int = 7007


def _batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch to the device; through pinned memory on CUDA, so the copy
    does not wait for the device to finish the previous step."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


def make_ray_train_step(model, optimizers: Optimizers, cameras) -> Callable:
    """(state, batch, uniforms=None, background_uniforms=None) -> scalars.

    Updates the model's parameters, the optimizers and `state` in place.
    `uniforms` ({"rgb": [...], "thermal": [...]}, one draw per sampling
    level) replaces the jitter the state's generator would draw; a test
    passes the JAX package's draws there."""
    cfg = model.config
    use_anneal = cfg.use_proposal_weight_anneal
    use_anneal_t = getattr(cfg, "use_proposal_thermal_weight_anneal", False)
    anneal_iters = cfg.proposal_weights_anneal_max_num_iters
    anneal_slope = cfg.proposal_weights_anneal_slope
    warmup = cfg.proposal_warmup
    update_every = cfg.proposal_update_every
    thermal = hasattr(model, "field_thermal")
    ray_generator = RayGenerator(cameras)

    def train_step(state: TrainState, batch, uniforms=None, background_uniforms=None):
        step = state.step
        anneal = proposal_anneal(step, anneal_iters, anneal_slope) if use_anneal else 1.0
        updated, new_ssu = proposal_updated(step, state.steps_since_update, warmup, update_every)
        kwargs = {}
        new_ssu_t = state.steps_since_update_thermal
        if thermal:
            if use_anneal_t:
                anneal_t = proposal_anneal(step, anneal_iters, anneal_slope)
                updated_t, new_ssu_t = proposal_updated(
                    step, state.steps_since_update_thermal, warmup, update_every
                )
            else:
                # the thermal sampler's callbacks are not registered in the
                # reference: always updated, anneal 1, counter frozen
                anneal_t, updated_t = 1.0, True
            kwargs = dict(anneal_thermal=anneal_t, updated_thermal=updated_t)

        optimizers.zero_grad()
        bundle = ray_generator(batch["ray_indices"])
        outputs = model(
            bundle, train=True, anneal=anneal, updated=updated,
            uniforms=uniforms, generator=state.generator, **kwargs,
        )
        metrics = model.get_metrics_dict(outputs, batch, train=True)
        loss_dict = model.get_loss_dict(
            outputs, batch, metrics, train=True, background_uniforms=background_uniforms
        )
        loss = sum(loss_dict[k] for k in sorted(loss_dict))
        loss.backward()
        optimizers.step()
        state.step = step + 1
        state.steps_since_update = new_ssu
        state.steps_since_update_thermal = new_ssu_t
        scalars = {"loss": loss, **loss_dict, **metrics}
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in scalars.items()}

    return train_step


class Trainer:
    def __init__(
        self,
        config: TrainerConfig,
        pipeline: VanillaPipeline,
        optimizer_configs: Dict[str, OptimizerGroupConfig],
        base_dir: Optional[Path] = None,
    ):
        for name, unported in (
            ("profiler", config.profiler != "none"),
            ("viewer", config.vis != "none"),
            ("gradient accumulation", config.gradient_accumulation_steps > 1),
        ):
            if unported:
                raise NotImplementedError(f"the trainer's {name} is not ported yet")
        pin_precision()
        self.config = config
        self.pipeline = pipeline
        self.model = pipeline.model
        self.datamanager = pipeline.datamanager
        self.device = self.model.device
        self.optimizer_configs = optimizer_configs
        self.base_dir = Path(base_dir) if base_dir else Path(config.output_dir)
        self.checkpoint_dir = self.base_dir / "nerfstudio_models"
        self.writer = Writer(
            self.base_dir, steps_per_log=config.steps_per_log,
            use_tensorboard=config.use_tensorboard, use_wandb=config.use_wandb,
            use_comet=config.use_comet, experiment_name=config.experiment_name,
        )
        self._start_step = 0

    def setup(self):
        self.optimizers = build_optimizer(self.optimizer_configs, self.model.param_groups())
        generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        self.state = TrainState(generator=generator)
        self.cameras = self.datamanager.train_cameras.to(self.device)
        self._load_checkpoint()
        self._train_step = make_ray_train_step(self.model, self.optimizers, self.cameras)

    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        batch = _batch_to(self.datamanager.next_train(step), self.device)
        return self._train_step(self.state, batch)

    def _has_eval_data(self) -> bool:
        n = len(self.datamanager.eval_dataset)
        if n == 0 and not getattr(self, "_warned_empty_eval", False):
            self._warned_empty_eval = True
            print("eval split is empty (all images assigned to train); skipping evals for this run")
        return n > 0

    def train(self):
        cfg = self.config
        self.writer.console_log(0, {})
        t_last = time.perf_counter()
        for step in range(self._start_step, cfg.max_num_iterations):
            scalars = self.train_iteration(step)
            if step % cfg.steps_per_log == 0:
                scalars = {k: float(v) for k, v in scalars.items()}
                t_now = time.perf_counter()
                iter_time = (t_now - t_last) / max(cfg.steps_per_log, 1)
                t_last = t_now
                num_rays = self.datamanager.config.train_num_rays_per_batch
                scalars[EventName.TRAIN_RAYS_PER_SEC] = num_rays / max(iter_time, 1e-9)
                scalars[EventName.ITER_TRAIN_TIME] = iter_time
                scalars[EventName.ETA] = (cfg.max_num_iterations - step) * iter_time
                if self.device.type == "cuda":
                    scalars["Device Memory (MB)"] = torch.cuda.memory_allocated(self.device) / 1e6
                self.writer.write_scalar_dict(scalars, step, group="train")
                self.writer.console_log(step, scalars)
            for every in (cfg.steps_per_eval_batch, cfg.steps_per_eval_image, cfg.steps_per_eval_all_images):
                if every > 0 and step > 0 and step % every == 0 and self._has_eval_data():
                    raise NotImplementedError(_EVAL_SLICE)
            if step > 0 and step % cfg.steps_per_save == 0:
                self.save_checkpoint(step)
        self.save_checkpoint(cfg.max_num_iterations)

    # checkpoints ------------------------------------------------------

    def save_checkpoint(self, step: int) -> Path:
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        path = self.checkpoint_dir / f"step-{step:09d}.ckpt"
        torch.save(
            {
                "step": self.state.step,
                "steps_since_update": self.state.steps_since_update,
                "steps_since_update_thermal": self.state.steps_since_update_thermal,
                "generator": self.state.generator.get_state(),
                "model": self.model.state_dict(),
                "optimizers": self.optimizers.state_dict(),
            },
            path,
        )
        if self.config.save_only_latest_checkpoint:
            for p in self.checkpoint_dir.glob("step-*.ckpt"):
                if p != path:
                    p.unlink()
        return path

    def _load_checkpoint(self):
        load_dir = self.config.load_dir
        if load_dir is None:
            return
        load_dir = Path(load_dir)
        if self.config.load_step is None:
            candidates = sorted(load_dir.glob("step-*.ckpt"))
            if not candidates:
                raise FileNotFoundError(f"no checkpoints in {load_dir}")
            path = candidates[-1]
        else:
            path = load_dir / f"step-{self.config.load_step:09d}.ckpt"
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self.optimizers.load_state_dict(ckpt["optimizers"])
        self.state.step = int(ckpt["step"])
        self.state.steps_since_update = int(ckpt["steps_since_update"])
        self.state.steps_since_update_thermal = int(ckpt["steps_since_update_thermal"])
        self.state.generator.set_state(ckpt["generator"].cpu())
        self._start_step = self.state.step
        print(f"Loaded checkpoint {path} at step {self._start_step}")
