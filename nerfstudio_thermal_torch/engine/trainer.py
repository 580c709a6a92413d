"""Trainer: the ray-batch train step and the host loop
(counterpart of nerfstudio_thermal_tpu/engine/trainer.py).

The JAX package jits one pure step over a TrainState pytree. Here the
parameters live in the model, the per-group Adam state in `Optimizers`,
and `TrainState` carries the rest: the step, both proposal-update counters
and the generator of the sampling jitter. `make_ray_train_step` does what
the JAX step does, in the same order: ray generation from
batch["ray_indices"] (the camera optimizers apply inside the model), the
forward with the proposal anneal and update flags of this step, metrics,
losses (their sum in sorted key order), backward (of the optimized
parameters only: `trained_params`), one update of every group, the
counters.

`Trainer.setup` / `train` run the loop with the rays/s and iteration-time
scalars, the three eval cadences (an eval ray batch's losses and metrics,
one eval image with its metrics and images, and the whole eval set's mean
metrics, each skipped while the eval split is empty) and checkpoints
through torch.save (`train` always saves at the end). A model's extra
state (`init_extra_state`: instant-ngp's occupancy grid, splatfacto's
alive mask and densification statistics) rides in `TrainState.extra`, is
updated at the start of each step, reaches the forward through
`extra_forward_kwargs`, and is saved and restored with the checkpoint. A
rasterization model (splatfacto) trains through `make_image_train_step`
and a generative one (generfacto) through `make_generative_train_step`;
both skip the eval ray batch. After each step a model with
`wants_host_refinement` (TensoRF, splatfacto) may refine its parameters
(`_maybe_refine`), then
the pipeline's `after_train_iteration` (the dynamic-batch pipeline) sees
the step's scalars, and the logged rays/s
counts the data manager's `num_rays_override` when it is set. As in the JAX
package, a failing eval batch or eval image is printed and training goes
on. With `gradient_accumulation_steps` k > 1 the optimizers are wrapped in
`MultiSteps` (optax.MultiSteps): every step still counts (the step, the
proposal-update counters and the checkpoints' step advance once a step),
but the parameters, the moments and the learning-rate schedules move only
on every k-th step, from the mean of the k gradients. `profiler` "basic"
times the loop's spans on the host and prints them at exit; "xla" writes a
torch.profiler trace of steps 10-15 (utils/profiler.py). With `vis`
"viewer" a training run serves the web viewer (viewer/server.py) against
the live model: each step runs under `train_lock`, which every viewer
render and export also takes, and the viewer's pause / resume / step
controls hold the loop between steps without the lock (the idle time is
left out of the rays/s window); the train scalars reach the viewer at log
cadence. An `eval_only` setup serves no viewer.

Data parallelism (parallel/mesh.py, whose docstring gives the design):
inside a process group the trainer's mesh spans its ranks, one card
each, for every method. A ray-batch rank's step takes its rows of its
host's batch and a `RayShard`; the model returns its contributions to
the global losses, the gradients of the optimized parameters are summed
over the ranks before the optimizers step, and the logged scalars are
the global values. The whole-image and generative steps replicate their
batch and take rank 0's gradients (and splatfacto's refinement
statistics) before the update. The ranks start from rank 0's
parameters. Only the main rank writes events, images and checkpoints,
opens the TensorBoard / W&B / Comet writers, runs the evals and serves
the viewer.
"""

import dataclasses
import math
import threading
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from nerfstudio_thermal_torch.engine.optimizers import (
    MultiSteps,
    OptimizerGroupConfig,
    Optimizers,
    build_optimizer,
)
from nerfstudio_thermal_torch.model_components.ray_generators import RayGenerator
from nerfstudio_thermal_torch.models.nerfacto import proposal_anneal, proposal_updated
from nerfstudio_thermal_torch.parallel.mesh import (
    Mesh,
    RayShard,
    all_reduce_grads,
    broadcast_grads,
    broadcast_params,
    broadcast_tensors,
    create_mesh,
    reduce_scalars,
    shard_batch,
)
from nerfstudio_thermal_torch.pipelines.base_pipeline import VanillaPipeline
from nerfstudio_thermal_torch.utils import profiler
from nerfstudio_thermal_torch.utils.precision import pin_precision
from nerfstudio_thermal_torch.utils.writer import EventName, Writer

@dataclass
class TrainState:
    """What the JAX TrainState holds besides params and optimizer state."""

    generator: torch.Generator
    step: int = 0
    steps_since_update: int = 0  # proposal update counter (rgb)
    steps_since_update_thermal: int = 0
    extra: Any = None  # the model's auxiliary state (instant-ngp's occupancy grid)


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
    num_devices: Optional[int] = None
    """Ranks of the data-parallel mesh, one card each (None: every visible
    card); ns-train spawns them (parallel/mesh.py)."""
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
    """'none' | 'basic' (host timings, printed at exit) | 'xla' (a
    torch.profiler trace of steps 10-15; the name is the JAX package's)."""
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


def _uses_random_background(model) -> bool:
    color = model.config.background_color
    return isinstance(color, str) and color == "random"


def _random_background(
    model, outputs, generator: torch.Generator, shard: Optional[RayShard] = None
) -> torch.Tensor:
    """U[0, 1) of the blended prediction's shape: [R, 3], or [R, 4] for the
    thermal model (RGBT in every density mode; rgb_only pads a zero thermal
    channel); with a `shard`, its rows of the global batch's draw."""
    rgb = outputs["rgb"]
    channels = 4 if hasattr(model, "output_suffixes") else rgb.shape[-1]
    if shard is not None:
        return shard.draw(generator, channels, rgb.device)
    return torch.rand((*rgb.shape[:-1], channels), generator=generator, device=rgb.device)


def trained_params(optimizers: Union[Optimizers, MultiSteps]) -> List[torch.Tensor]:
    """The parameters the optimizer groups update that require a gradient:
    the only leaves a training step's backward differentiates, as JAX's
    step differentiates the parameters alone. A detached leaf that requires
    a gradient (the sample positions an SDF field differentiates for its
    normals) then gets none, and the backward skips what only it reads.
    Read at each step: TensoRF's upsample swaps parameters in the groups."""
    return [p for opt in optimizers.groups.values() for p in opt.params if p.requires_grad]


def make_ray_train_step(model, optimizers: Union[Optimizers, MultiSteps], cameras) -> Callable:
    """(state, batch, uniforms=None, background_uniforms=None, tv_uniforms=None, extra_draws=None, shard=None)
    -> scalars.

    Updates the model's parameters, the optimizers and `state` in place.
    The step first updates the model's extra state (`update_extra_state`,
    from the parameters the step starts from; `extra_draws` replaces its
    draws), then runs the forward with `extra_forward_kwargs`.
    `uniforms` ({"rgb": [...], "thermal": [...]}, one draw per sampling
    level) replaces the jitter the state's generator would draw,
    `background_uniforms` the draw of a random background (U[0, 1) of the
    prediction's shape, [R, 3] or [R, 4] for RGBT) that the loss blends,
    and `tv_uniforms` ({"rgb": [P, 3], "thermal": [P, 3]}) the density TV
    loss's points; a test passes the JAX package's draws there. With a
    `shard` (a data-parallel rank: `batch` holds its rows) the given
    uniforms and background are the global batch's, the draws from the
    generator too, and the rank keeps its rows of them; the model returns
    its contributions, the gradients are summed over the ranks before the
    update and the returned scalars are the global values."""
    cfg = model.config
    # a model without proposal networks (instant-ngp) takes the JAX step's defaults
    use_anneal = getattr(cfg, "use_proposal_weight_anneal", True)
    use_anneal_t = getattr(cfg, "use_proposal_thermal_weight_anneal", False)
    anneal_iters = getattr(cfg, "proposal_weights_anneal_max_num_iters", 1000)
    anneal_slope = getattr(cfg, "proposal_weights_anneal_slope", 10.0)
    warmup = getattr(cfg, "proposal_warmup", 5000)
    update_every = getattr(cfg, "proposal_update_every", 5)
    thermal = hasattr(model, "output_suffixes")
    random_background = _uses_random_background(model)
    ray_generator = RayGenerator(cameras)

    def train_step(state: TrainState, batch, uniforms=None, background_uniforms=None, tv_uniforms=None,
                   extra_draws=None, shard: Optional[RayShard] = None):
        step = state.step
        sharded = {}
        if shard is not None:
            sharded = {"shard": shard}
            if uniforms is not None:
                uniforms = {k: [shard.local(u) for u in v] for k, v in uniforms.items()}
            if background_uniforms is not None:
                background_uniforms = shard.local(background_uniforms)
        state.extra = model.update_extra_state(state.extra, step, generator=state.generator, draws=extra_draws)
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
            **model.extra_forward_kwargs(state.extra), **sharded,
        )
        metrics = model.get_metrics_dict(outputs, batch, train=True, **sharded)
        if random_background and background_uniforms is None:
            # the JAX step draws it from its loss key
            background_uniforms = _random_background(model, outputs, state.generator, shard)
        loss_dict = model.get_loss_dict(
            outputs, batch, metrics, train=True, background_uniforms=background_uniforms,
            tv_uniforms=tv_uniforms, generator=state.generator, **sharded,
        )
        loss = sum(loss_dict[k] for k in sorted(loss_dict))
        params = trained_params(optimizers)
        loss.backward(inputs=params)
        if shard is not None:
            all_reduce_grads(params)
        optimizers.step()
        state.step = step + 1
        state.steps_since_update = new_ssu
        state.steps_since_update_thermal = new_ssu_t
        scalars = {"loss": loss, **loss_dict, **metrics}
        if shard is not None:
            return reduce_scalars(scalars)
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in scalars.items()}

    return train_step


def make_image_train_step(model, optimizers: Union[Optimizers, MultiSteps], cameras,
                          replicated: bool = False) -> Callable:
    """The whole-image step of a rasterization model (splatfacto):
    (state, batch, background_uniforms=None) -> scalars, in the JAX step's
    order: the extra state's step; the whole image of batch["camera_index"]
    rendered at camera 0's height and width (as in the JAX package, every
    frame: a scene whose frames differ in size fails in the loss); metrics
    and losses; the backward of the optimized parameters; the refinement
    statistics from the means' gradient, before the update; one update of
    every group. A random background is the (3,) U[0, 1) draw of the
    state's generator, or `background_uniforms` where a test passes the
    JAX package's. `replicated` (a data-parallel rank): every rank steps
    on the same batch, then takes rank 0's gradients and refinement
    statistics, so every rank applies the same update."""
    height, width = int(cameras.height[0]), int(cameras.width[0])
    random_background = _uses_random_background(model)

    def train_step(state: TrainState, batch, background_uniforms=None):
        step = state.step
        state.extra = model.update_extra_state(state.extra, step, generator=state.generator)
        optimizers.zero_grad()
        if random_background and background_uniforms is None:
            background_uniforms = torch.rand(3, generator=state.generator, device=model.device)
        outputs = model.render_camera(
            cameras, batch["camera_index"], alive=state.extra.alive, train=True,
            background_uniforms=background_uniforms, width=width, height=height,
        )
        metrics = model.get_metrics_dict(outputs, batch, train=True)
        loss_dict = model.get_loss_dict(outputs, batch, metrics, train=True)
        loss = sum(loss_dict[k] for k in sorted(loss_dict))
        params = trained_params(optimizers)
        loss.backward(inputs=params)
        if replicated:
            broadcast_grads(params)
        state.extra = model.track_refinement_stats(state.extra, model.xyz.grad, outputs["radii"].detach())
        if replicated:
            broadcast_tensors((state.extra.grad_accum, state.extra.grad_count, state.extra.max_radii))
        optimizers.step()
        state.step = step + 1
        scalars = {"loss": loss, **loss_dict, **metrics}
        return {k: v.detach() for k, v in scalars.items()}

    return train_step


def make_generative_train_step(model, optimizers: Union[Optimizers, MultiSteps], replicated: bool = False) -> Callable:
    """The text-to-3D step (generfacto): (state, batch, draws=None) ->
    scalars. The batch is one random camera pose; the model renders its
    whole low-resolution image, then the guidance's loss and the rest.
    `draws` replaces the five draws of the state's generator (light,
    shade, background, choice, sampler jitter; `generative_forward`). The
    guidance is built here, as the JAX package builds it with its step.
    `replicated`: as make_image_train_step's (rank 0's gradients)."""
    model.get_guidance()

    def train_step(state: TrainState, batch, draws=None):
        step = state.step
        optimizers.zero_grad()
        outputs = model.generative_forward(batch, step=step, train=True, draws=draws, generator=state.generator)
        loss_dict = model.generative_loss(outputs, batch, step=step)
        loss = sum(loss_dict[k] for k in sorted(loss_dict))
        params = trained_params(optimizers)
        loss.backward(inputs=params)
        if replicated:
            broadcast_grads(params)
        optimizers.step()
        state.step = step + 1
        scalars = {"loss": loss, **loss_dict}
        return {k: v.detach() for k, v in scalars.items()}

    return train_step


class Trainer:
    def __init__(
        self,
        config: TrainerConfig,
        pipeline: VanillaPipeline,
        optimizer_configs: Dict[str, OptimizerGroupConfig],
        base_dir: Optional[Path] = None,
        mesh: Optional[Mesh] = None,
    ):
        """`mesh`: the data-parallel mesh (default: `create_mesh` of
        config.num_devices)."""
        if config.profiler not in ("none", "basic", "xla"):
            raise ValueError(f"profiler={config.profiler!r}: one of none, basic, xla")
        pin_precision()
        self.config = config
        self.pipeline = pipeline
        self.model = pipeline.model
        self.datamanager = pipeline.datamanager
        self.device = self.model.device
        self.mesh = mesh if mesh is not None else create_mesh(config.num_devices)
        self.optimizer_configs = optimizer_configs
        self.base_dir = Path(base_dir) if base_dir else Path(config.output_dir)
        self.checkpoint_dir = self.base_dir / "nerfstudio_models"
        main = self.mesh.is_main  # only the main rank opens any writer
        self.writer = Writer(
            self.base_dir if main else None, steps_per_log=config.steps_per_log,
            use_tensorboard=config.use_tensorboard and main, use_wandb=config.use_wandb and main,
            use_comet=config.use_comet and main, experiment_name=config.experiment_name,
        )
        self._start_step = 0
        self._eval_ray_generator = None
        self._trace_profiler = None
        self._viewer = None
        self.train_lock = threading.Lock()
        # viewer pause control: set -> the loop idles between steps without
        # train_lock, so viewer renders stay live; _step_once grants one
        # iteration while paused
        self._pause_event = threading.Event()
        self._step_once = threading.Event()
        self._last_logged_step = 0

    def setup(self, eval_only: bool = False):
        """Optimizers, state and the checkpoint of `load_dir`. eval_only: the
        run is reloaded to evaluate or render (eval_setup), which draw no
        jitter, so a checkpoint whose jitter generator belongs to another
        device (a run trained on the card, reloaded on the CPU) starts a
        fresh one; a training run refuses it instead, since its jitter
        would no longer follow the run it resumes."""
        self.optimizers = build_optimizer(self.optimizer_configs, self.model.param_groups())
        if self.config.gradient_accumulation_steps > 1:
            self.optimizers = MultiSteps(self.optimizers, self.config.gradient_accumulation_steps)
        generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        self.state = TrainState(generator=generator, extra=self.model.init_extra_state())
        self.cameras = self.datamanager.train_cameras.to(self.device)
        self._load_checkpoint(eval_only)
        if self.mesh.distributed:
            broadcast_params(self.model.parameters())
        replicated = self.mesh.distributed
        if getattr(self.model, "is_rasterization", False):
            self._train_step = make_image_train_step(self.model, self.optimizers, self.cameras, replicated)
        elif getattr(self.model, "is_generative", False):
            self._train_step = make_generative_train_step(self.model, self.optimizers, replicated)
        else:
            self._train_step = make_ray_train_step(self.model, self.optimizers, self.cameras)
        if self.config.profiler == "basic":
            profiler.setup_profiler(True, self.base_dir)
        elif self.config.profiler == "xla":
            self._trace_profiler = profiler.TraceProfiler(self.base_dir)
        if self.config.vis == "viewer" and not eval_only and self.mesh.is_main:
            self._start_viewer()

    def _start_viewer(self) -> None:
        """Serve the web viewer against the live model (renders and
        exports under train_lock)."""
        from nerfstudio_thermal_torch.viewer.server import (
            ViewerServer,
            make_model_export_fn,
            make_model_render_fn,
            probe_output_names,
        )

        self._viewer = ViewerServer(
            make_model_render_fn(self.model),
            output_names=probe_output_names(self.model),
            port=self.config.viewer_port,
            train_lock=self.train_lock,
            save_dir=self.base_dir,
            export_fn=make_model_export_fn(self.model, self.datamanager.eval_cameras, self.base_dir),
            train_control=self._viewer_train_control,
        )
        self._viewer.start()

    def stop_viewer(self) -> None:
        """Stop the viewer of a `vis` "viewer" run (a no-op without one)."""
        if self._viewer is not None:
            self._viewer.stop()
            self._viewer = None

    def _viewer_train_control(self, action: str) -> dict:
        """The viewer's pause / resume / step / status hook; returns the
        state the client displays."""
        if action == "pause":
            self._pause_event.set()
        elif action == "resume":
            self._pause_event.clear()
            self._step_once.set()  # wake the wait loop immediately
        elif action == "step":
            self._step_once.set()
        elif action != "status":
            raise ValueError(f"unknown train_control action '{action}'")
        return {"paused": self._pause_event.is_set(), "step": int(self._last_logged_step)}

    @profiler.time_function
    def train_iteration(self, step: int) -> Dict[str, torch.Tensor]:
        batch = self.datamanager.next_train(step)
        if self.mesh.distributed and not self._whole_batch():
            # this rank's rows of its host's batch
            patch = self.datamanager.config.patch_size
            shard = self.mesh.ray_shard(len(batch["ray_indices"]), patch)
            scalars = self._train_step(
                self.state, _batch_to(shard_batch(batch, self.mesh, patch), self.device), shard=shard
            )
        else:
            scalars = self._train_step(self.state, _batch_to(batch, self.device))
        self._maybe_refine(step)
        after = getattr(self.pipeline, "after_train_iteration", None)
        if after is not None:
            # DynamicBatchPipeline sizes the next ray batch (it reads a
            # device scalar only on its update_every steps)
            after(scalars, step)
        return scalars

    def _whole_batch(self) -> bool:
        """Whether the step takes whole images or poses (splatfacto,
        generfacto), which a data-parallel rank replicates, not shards."""
        return getattr(self.model, "is_rasterization", False) or getattr(self.model, "is_generative", False)

    def _maybe_refine(self, step: int) -> None:
        """A model's refinement after the step. Splatfacto's edits rows of
        its pools, the optimizers' moments and the extra state; the model's
        `_host_alive` snapshot follows the new mask. TensoRF's grid
        upsampling swaps parameters in the model and the optimizers, so the
        fused MLPs' packed weights of the old tensors are dropped."""
        model = self.model
        if not hasattr(model, "wants_host_refinement") or not model.wants_host_refinement(step):
            return
        if getattr(model, "is_rasterization", False):
            self.state.extra = model.refine_host(self.optimizers, step, self.state.extra)
            model._host_alive = self.state.extra.alive.clone()
            return
        model.refine_host(self.optimizers, step)
        for module in model.modules():
            cache = getattr(module, "pack_cache", None)
            if cache is not None:
                cache.entries.clear()

    def _has_eval_data(self) -> bool:
        n = len(self.datamanager.eval_dataset)
        if n == 0 and not getattr(self, "_warned_empty_eval", False):
            self._warned_empty_eval = True
            print("eval split is empty (all images assigned to train); skipping evals for this run")
        return n > 0

    def train(self):
        cfg = self.config
        main = self.mesh.is_main
        if main:
            self.writer.console_log(0, {})
        t_last = time.perf_counter()
        for step in range(self._start_step, cfg.max_num_iterations):
            # viewer pause: idle without train_lock so viewer renders stay
            # live; a "step" grant runs one iteration
            if self._pause_event.is_set() and not self._step_once.is_set():
                while self._pause_event.is_set() and not self._step_once.is_set():
                    time.sleep(0.05)
                t_last = time.perf_counter()  # the idle time is not training time
            self._step_once.clear()
            self._last_logged_step = step
            with self.train_lock:
                scalars = self.train_iteration(step)
            if self._trace_profiler is not None:
                self._trace_profiler.step(step)
            if step % cfg.steps_per_log == 0:
                scalars = {k: float(v) for k, v in scalars.items()}
                t_now = time.perf_counter()
                iter_time = (t_now - t_last) / max(cfg.steps_per_log, 1)
                t_last = t_now
                num_rays = self.mesh.num_hosts * (
                    getattr(self.datamanager, "num_rays_override", None)
                    or self.datamanager.config.train_num_rays_per_batch
                )
                rays_per_sec = num_rays / max(iter_time, 1e-9)
                remaining = cfg.max_num_iterations - step
                scalars[EventName.TRAIN_RAYS_PER_SEC] = rays_per_sec
                scalars[EventName.ITER_TRAIN_TIME] = iter_time
                scalars[EventName.ETA] = remaining * iter_time
                if self.device.type == "cuda":
                    scalars["Device Memory (MB)"] = torch.cuda.memory_allocated(self.device) / 1e6
                self.writer.write_scalar_dict(scalars, step, group="train")
                if main:
                    self.writer.console_log(step, scalars)
                if self._viewer is not None:
                    stats = {
                        "step": step,
                        "rays_per_sec": round(rays_per_sec, 1),
                        "iter_ms": round(iter_time * 1e3, 2),
                        "eta_s": round(remaining * iter_time, 1),
                    }
                    loss = scalars.get("loss")
                    if loss is not None and math.isfinite(loss):
                        stats["loss"] = round(loss, 5)
                    self._viewer.update_train_stats(stats)
            if self._due(step, cfg.steps_per_eval_batch):
                self.eval_batch_iteration(step)
            if self._due(step, cfg.steps_per_eval_image):
                self.eval_iteration(step)
            if self._due(step, cfg.steps_per_eval_all_images):
                with torch.no_grad(), profiler.time_function("Trainer.eval_all_images"):
                    metrics = self.pipeline.get_average_eval_image_metrics(step)
                self.writer.write_scalar_dict(metrics, step, group="eval_all")
            if step > 0 and step % cfg.steps_per_save == 0 and main:
                self.save_checkpoint(step)
        if self._trace_profiler is not None:
            self._trace_profiler.close()
        if main:
            self.save_checkpoint(cfg.max_num_iterations)

    def _due(self, step: int, every: int) -> bool:
        """An eval cadence's step (the main rank's only)."""
        return every > 0 and step > 0 and step % every == 0 and self.mesh.is_main and self._has_eval_data()

    # evals ------------------------------------------------------------

    @profiler.time_function
    def eval_batch_iteration(self, step: int) -> None:
        """Losses and metrics of one eval ray batch (train=False), written
        as eval_* under the group "eval". Whole-image models (splatfacto,
        generfacto) skip it: they evaluate whole images only."""
        if self._whole_batch():
            return
        try:
            if self._eval_ray_generator is None:
                self._eval_ray_generator = RayGenerator(self.datamanager.eval_cameras.to(self.device))
            batch = _batch_to(self.datamanager.next_eval(step), self.device)
            model = self.model
            with torch.no_grad():
                outputs = model(self._eval_ray_generator(batch["ray_indices"]), train=False)
                metrics = model.get_metrics_dict(outputs, batch, train=False)
                background_uniforms = None
                if _uses_random_background(model):
                    # drawn from the step, as the JAX package draws it from PRNGKey(step)
                    generator = torch.Generator(device=self.device).manual_seed(step)
                    background_uniforms = _random_background(model, outputs, generator)
                losses = model.get_loss_dict(
                    outputs, batch, metrics, train=False, background_uniforms=background_uniforms
                )
            scalars = {f"eval_{k}": float(v) for k, v in {**losses, **metrics}.items()}
            self.writer.write_scalar_dict(scalars, step, group="eval")
        except Exception:  # an eval must not stop training (the reference's rule)
            print(f"eval batch failed at step {step}:")
            traceback.print_exc()

    @profiler.time_function
    def eval_iteration(self, step: int) -> None:
        """The next eval image: its metrics (group "eval") and its images
        (images/eval_<name>/step-<N>.png)."""
        try:
            with torch.no_grad():
                metrics, images = self.pipeline.get_eval_image_metrics_and_images(step)
            metrics.pop("_num_rays", None)
            self.writer.write_scalar_dict(metrics, step, group="eval")
            self.writer.console_log(step, metrics)
            for name, img in images.items():
                self.writer.write_image(f"eval/{name}", img, step)
        except Exception:  # an eval must not stop training (the reference's rule)
            print(f"eval failed at step {step}:")
            traceback.print_exc()

    # checkpoints ------------------------------------------------------

    @profiler.time_function
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
                "eval_image_index": self.datamanager._eval_image_index,
                **({"extra": dataclasses.asdict(self.state.extra)} if self.state.extra is not None else {}),
            },
            path,
        )
        if self.config.save_only_latest_checkpoint:
            for p in self.checkpoint_dir.glob("step-*.ckpt"):
                if p != path:
                    p.unlink()
        return path

    def _load_checkpoint(self, eval_only: bool = False):
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
        before = [p for ps in self.model.param_groups().values() for p in ps]
        self.model.load_state_dict(ckpt["model"])
        # a model may take a parameter at the checkpoint's shape (TensoRF's
        # grids after an upsample): the optimizers follow it
        after = [p for ps in self.model.param_groups().values() for p in ps]
        swapped = {old: new for old, new in zip(before, after) if old is not new}
        if swapped:
            self.optimizers.replace_params(swapped)
        self.optimizers.load_state_dict(ckpt["optimizers"])
        self.state.step = int(ckpt["step"])
        self.state.steps_since_update = int(ckpt["steps_since_update"])
        self.state.steps_since_update_thermal = int(ckpt["steps_since_update_thermal"])
        generator_state = ckpt["generator"].cpu()
        if generator_state.numel() == self.state.generator.get_state().numel():
            self.state.generator.set_state(generator_state)
        elif eval_only:
            # a CUDA generator's state does not fit the CPU's (or the reverse)
            print(f"checkpoint {path.name}: its jitter generator is another device's; starting a fresh one")
        else:
            raise ValueError(
                f"checkpoint {path.name}: its jitter generator belongs to another device than "
                f"{self.device}; resume the run on the device it was trained on"
            )
        self.datamanager._eval_image_index = int(ckpt.get("eval_image_index", 0))
        if "extra" in ckpt and self.state.extra is not None:
            restored = {k: v.to(self.device) if isinstance(v, torch.Tensor) else v for k, v in ckpt["extra"].items()}
            self.state.extra = dataclasses.replace(self.state.extra, **restored)
        self._start_step = self.state.step
        set_start = getattr(self.datamanager, "set_start_step", None)
        if set_start is not None:
            set_start(self._start_step)
        print(f"Loaded checkpoint {path} at step {self._start_step}")
