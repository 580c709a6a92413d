"""Method registry (counterpart of nerfstudio_thermal_tpu/configs/method_configs.py).

`thermal-nerfacto` and `thermal-nerfacto-tpu` (the ThermalNerf
dataparser, eight optimizer groups) and the nerfacto family `nerfacto`,
`nerfacto-tpu`, `nerfacto-big` and `nerfacto-huge` (the Nerfstudio
dataparser, three groups), under the JAX package's names and with its
fields; `descriptions` for ns-train's method list; `resolve_model_class`;
and `setup_trainer`, which wires dataparser -> data manager -> model ->
pipeline -> trainer as the JAX package's does. The JAX package's other
methods and its plugin registry are not registered here (ROADMAP A8 and
A9).
"""

import copy
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

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
from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
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
    model: NerfactoModelConfig = field(default_factory=NerfactoModelConfig)
    optimizers: Dict[str, OptimizerGroupConfig] = field(default_factory=dict)
    data: Optional[Path] = None
    description: str = ""
    dynamic_batch: Optional[Any] = None
    """The JAX package's DynamicBatchPipelineConfig (instant-ngp); the
    dynamic-batch pipeline is not ported yet, and setup_trainer raises when
    this is set."""


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


def make_nerfacto() -> MethodConfig:
    return MethodConfig(
        method_name="nerfacto",
        description="Recommended real-time model for unbounded scenes.",
        trainer=TrainerConfig(
            max_num_iterations=30000,
            steps_per_eval_batch=500,
            steps_per_save=2000,
            mixed_precision=True,
            method_name="nerfacto",
        ),
        dataparser=NerfstudioDataParserConfig(),
        datamanager=VanillaDataManagerConfig(train_num_rays_per_batch=4096, eval_num_rays_per_batch=4096),
        model=NerfactoModelConfig(
            eval_num_rays_per_chunk=1 << 15,
            camera_optimizer=CameraOptimizerConfig(mode="SO3xR3"),
            compute_dtype="bfloat16",
        ),
        optimizers={
            "proposal_networks": _field_opt(),
            "fields": _field_opt(),
            "camera_opt": _camera_opt(),
        },
    )


def make_nerfacto_big() -> MethodConfig:
    """nerfacto with wider MLPs, a 2^21-row grid to 4096 and (512, 256) +
    128 samples."""
    cfg = make_nerfacto()
    cfg.method_name = "nerfacto-big"
    cfg.trainer.method_name = "nerfacto-big"
    cfg.trainer.max_num_iterations = 100000
    cfg.description = "Larger nerfacto for bigger scenes."
    cfg.datamanager.train_num_rays_per_batch = 8192
    m = cfg.model
    m.num_nerf_samples_per_ray = 128
    m.num_proposal_samples_per_ray = (512, 256)
    m.hidden_dim = 128
    m.hidden_dim_color = 128
    m.appearance_embed_dim = 128
    m.max_res = 4096
    m.log2_hashmap_size = 21
    return cfg


def make_nerfacto_huge() -> MethodConfig:
    """nerfacto with 256-wide MLPs, a 2^21-row grid to 8192, a 7-level
    second proposal grid to 2048 and (512, 512) + 64 samples."""
    cfg = make_nerfacto()
    cfg.method_name = "nerfacto-huge"
    cfg.trainer.method_name = "nerfacto-huge"
    cfg.trainer.max_num_iterations = 100000
    cfg.description = "Even larger nerfacto; long training."
    cfg.datamanager.train_num_rays_per_batch = 16384
    m = cfg.model
    m.num_nerf_samples_per_ray = 64
    m.num_proposal_samples_per_ray = (512, 512)
    m.proposal_net_args_list = [
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 5, "max_res": 512, "use_linear": False},
        {"hidden_dim": 16, "log2_hashmap_size": 17, "num_levels": 7, "max_res": 2048, "use_linear": False},
    ]
    m.hidden_dim = 256
    m.hidden_dim_color = 256
    m.appearance_embed_dim = 32
    m.max_res = 8192
    m.log2_hashmap_size = 21
    return cfg


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
    if hasattr(m, "density_loss_rays_fraction"):
        m.density_loss_rays_fraction = 0.25
    m.proposal_camera_gradients = False
    m.num_proposal_samples_per_ray = (128, 48)
    m.num_nerf_samples_per_ray = 32
    m.fused_raymarch = False
    return cfg


_METHODS: Dict[str, Callable[[], MethodConfig]] = {
    "nerfacto": make_nerfacto,
    "thermal-nerfacto": make_thermal_nerfacto,
    "nerfacto-tpu": lambda: _tpu_variant(make_nerfacto(), "nerfacto-tpu"),
    "thermal-nerfacto-tpu": lambda: _tpu_variant(make_thermal_nerfacto(), "thermal-nerfacto-tpu"),
    "nerfacto-big": make_nerfacto_big,
    "nerfacto-huge": make_nerfacto_huge,
}


descriptions: Dict[str, str] = {name: make().description for name, make in _METHODS.items()}


def get_method_config(name: str) -> MethodConfig:
    if name not in _METHODS:
        raise KeyError(
            f"unknown method '{name}'; available: {sorted(_METHODS)} (the JAX package's other methods are "
            "ROADMAP A8, plugin methods A9)"
        )
    return _METHODS[name]()


def resolve_model_class(model_config) -> type:
    """Model config -> model class, the most derived config first."""
    if isinstance(model_config, ThermalNerfactoModelConfig):
        return ThermalNerfactoModel
    return NerfactoModel


def setup_trainer(
    config: MethodConfig,
    base_dir: Optional[Path] = None,
    device: Union[str, torch.device] = "cuda",
) -> Trainer:
    """Dataparser -> data manager -> model -> pipeline -> trainer. The model
    is built on `device` (CUDA unless the caller asks for the CPU) from the
    trainer's seed, of the class `resolve_model_class` gives."""
    if config.dynamic_batch is not None:
        raise NotImplementedError("the dynamic-batch pipeline (MethodConfig.dynamic_batch) is not ported yet")
    if config.data is not None:
        config.dataparser.data = Path(config.data)
    parser_cls = ThermalNerf if isinstance(config.dataparser, ThermalNerfDataParserConfig) else Nerfstudio
    datamanager = VanillaDataManager(config.datamanager, parser_cls(config.dataparser))
    metadata = dict(datamanager.train_dataparser_outputs.metadata)
    if "is_thermal" not in metadata:
        metadata["is_thermal"] = list(datamanager.train_dataset.is_thermal)
    model = resolve_model_class(config.model)(
        config.model,
        scene_aabb=datamanager.train_dataparser_outputs.scene_box,
        num_train_data=len(datamanager.train_dataset),
        metadata=metadata,
        device=device,
        seed=config.trainer.seed,
    )
    pipeline = VanillaPipeline(datamanager, model)
    return Trainer(config.trainer, pipeline, config.optimizers, base_dir=base_dir)
