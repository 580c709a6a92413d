"""Method registry (counterpart of nerfstudio_thermal_tpu/configs/method_configs.py).

`thermal-nerfacto` and `thermal-nerfacto-tpu` under the JAX package's
names, with their trainer, ThermalNerf dataparser, data manager, model and
eight optimizer groups, and `setup_trainer`, which wires dataparser ->
data manager -> model -> pipeline -> trainer as the JAX package's does.
The CLI (`configs/cli.py`, `scripts/train.py`) is later work.
"""

import copy
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import torch

from nerfstudio_thermal_torch.cameras.camera_optimizers import CameraOptimizerConfig
from nerfstudio_thermal_torch.data.datamanagers import VanillaDataManager, VanillaDataManagerConfig
from nerfstudio_thermal_torch.data.dataparsers.nerfstudio_dataparser import (
    Nerfstudio,
    NerfstudioDataParserConfig,
    ThermalNerf,
    ThermalNerfDataParserConfig,
)
from nerfstudio_thermal_torch.engine.optimizers import AdamOptimizerConfig, OptimizerGroupConfig
from nerfstudio_thermal_torch.engine.schedulers import ExponentialDecaySchedulerConfig
from nerfstudio_thermal_torch.engine.trainer import Trainer, TrainerConfig
from nerfstudio_thermal_torch.models.thermal_nerfacto import (
    ThermalNerfactoModel,
    ThermalNerfactoModelConfig,
)
from nerfstudio_thermal_torch.pipelines.base_pipeline import VanillaPipeline


@dataclass
class MethodConfig:
    """A full experiment: trainer + data + model + optimizers."""

    method_name: str
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    dataparser: NerfstudioDataParserConfig = field(default_factory=NerfstudioDataParserConfig)
    datamanager: VanillaDataManagerConfig = field(default_factory=VanillaDataManagerConfig)
    model: ThermalNerfactoModelConfig = field(default_factory=ThermalNerfactoModelConfig)
    optimizers: Dict[str, OptimizerGroupConfig] = field(default_factory=dict)
    data: Optional[Path] = None
    description: str = ""


def _field_opt():
    return OptimizerGroupConfig(
        optimizer=AdamOptimizerConfig(lr=1e-2, eps=1e-15),
        scheduler=ExponentialDecaySchedulerConfig(lr_final=1e-4, max_steps=200000),
    )


def _camera_opt():
    return OptimizerGroupConfig(
        optimizer=AdamOptimizerConfig(lr=1e-3, eps=1e-15),
        scheduler=ExponentialDecaySchedulerConfig(lr_final=1e-4, max_steps=5000),
    )


def make_thermal_nerfacto() -> MethodConfig:
    return MethodConfig(
        method_name="thermal-nerfacto",
        description="Multispectral RGB+thermal nerfacto (ThermalNeRF).",
        trainer=TrainerConfig(
            max_num_iterations=30000,
            steps_per_eval_batch=500,
            steps_per_save=2000,
            mixed_precision=True,
            method_name="thermal-nerfacto",
        ),
        dataparser=ThermalNerfDataParserConfig(),
        datamanager=VanillaDataManagerConfig(
            train_num_rays_per_batch=4096 * 2,
            eval_num_rays_per_batch=4096 * 2,
            patch_size=2,  # the TV and cross-channel losses need 2x2 patches
        ),
        model=ThermalNerfactoModelConfig(
            eval_num_rays_per_chunk=1 << 15,
            camera_optimizer=CameraOptimizerConfig(mode="SO3xR3"),
            compute_dtype="bfloat16",
        ),
        optimizers={
            "proposal_networks": _field_opt(),
            "fields": _field_opt(),
            "proposal_networks_thermal": _field_opt(),
            "fields_thermal": _field_opt(),
            "camera_opt": _camera_opt(),
            "camera_opt_thermal": _camera_opt(),
            "shared_camera_opt": _camera_opt(),
            "shared_camera_opt_thermal": _camera_opt(),
        },
    )


_FREQ_PROPOSAL_ARGS = [
    {"encoding": "freq", "hidden_dim": 64, "num_layers": 3, "num_frequencies": 5},
    {"encoding": "freq", "hidden_dim": 64, "num_layers": 3, "num_frequencies": 7},
]


def _tpu_variant(base: MethodConfig, name: str) -> MethodConfig:
    """The compute-dense variant: frequency-MLP proposal fields and a deep
    frequency-MLP base field (8 x 256, skip at 4) through the fused MLP,
    the cross-spectral density loss on a quarter of the rays, no camera
    gradients through the proposal fields, (128, 48) + 32 samples."""
    cfg = copy.deepcopy(base)
    cfg.method_name = name
    cfg.trainer.method_name = name
    cfg.description = base.description + " (TPU compute-dense variant)"
    m = cfg.model
    m.field_encoding = "freq"
    m.proposal_net_args_list = copy.deepcopy(_FREQ_PROPOSAL_ARGS)
    m.compute_dtype = "bfloat16"
    m.freq_final_init_scale = 0.1
    m.use_pallas = True
    m.density_loss_rays_fraction = 0.25
    m.proposal_camera_gradients = False
    m.num_proposal_samples_per_ray = (128, 48)
    m.num_nerf_samples_per_ray = 32
    m.fused_raymarch = False
    return cfg


_METHODS: Dict[str, Callable[[], MethodConfig]] = {
    "thermal-nerfacto": make_thermal_nerfacto,
    "thermal-nerfacto-tpu": lambda: _tpu_variant(make_thermal_nerfacto(), "thermal-nerfacto-tpu"),
}


def get_method_config(name: str) -> MethodConfig:
    if name not in _METHODS:
        raise KeyError(f"unknown method '{name}'; available: {sorted(_METHODS)}")
    return _METHODS[name]()


def setup_trainer(
    config: MethodConfig,
    base_dir: Optional[Path] = None,
    device: Union[str, torch.device] = "cuda",
) -> Trainer:
    """Dataparser -> data manager -> model -> pipeline -> trainer. The model
    is built on `device` (CUDA unless the caller asks for the CPU) from the
    trainer's seed."""
    if config.data is not None:
        config.dataparser.data = Path(config.data)
    parser_cls = ThermalNerf if isinstance(config.dataparser, ThermalNerfDataParserConfig) else Nerfstudio
    datamanager = VanillaDataManager(config.datamanager, parser_cls(config.dataparser))
    metadata = dict(datamanager.train_dataparser_outputs.metadata)
    if "is_thermal" not in metadata:
        metadata["is_thermal"] = list(datamanager.train_dataset.is_thermal)
    model = ThermalNerfactoModel(
        config.model,
        scene_aabb=datamanager.train_dataparser_outputs.scene_box,
        num_train_data=len(datamanager.train_dataset),
        metadata=metadata,
        device=device,
        seed=config.trainer.seed,
    )
    pipeline = VanillaPipeline(datamanager, model)
    return Trainer(config.trainer, pipeline, config.optimizers, base_dir=base_dir)
