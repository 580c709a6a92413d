"""Method registry (counterpart of nerfstudio_thermal_tpu/configs/method_configs.py).

`thermal-nerfacto` and `thermal-nerfacto-tpu` (the ThermalNerf
dataparser, eight optimizer groups), the nerfacto family `nerfacto`,
`nerfacto-tpu`, `nerfacto-big` and `nerfacto-huge` (the Nerfstudio
dataparser, three groups) with `depth-nerfacto`, `instant-ngp` (Nerfstudio
dataparser) and `instant-ngp-bounded` (instant_ngp dataparser), one group
each, with the dynamic-batch pipeline, and `vanilla-nerf`, `mipnerf` and
`tensorf` (the blender dataparser, one group), the surface methods `neus`
(`fields` and `field_background`, cosine schedules) and `neus-facto`
(`fields` with a cosine schedule, `proposal_networks` with a multi-step
one), `semantic-nerfw` (nerfacto's groups, 4096 rays), `splatfacto`
(whole images, six Adam groups over the gaussian attributes) and
`generfacto` (random cameras, no data); under the JAX package's names and
with its fields; `descriptions` for ns-train's method list;
`resolve_model_class`; and `setup_trainer`, which wires dataparser
(through `build_dataparser`) -> data manager -> model -> pipeline ->
trainer as the JAX package's does (generfacto: no dataparser;
splatfacto: seed points from a parser's `points3D_xyz`, which none
writes). Plugin methods (`plugins/registry.py`: the entry-point group
`nerfstudio.method_configs` and $NERFSTUDIO_METHOD_CONFIGS) are discovered
at the first `get_method_config` or `method_names` call.
"""

import copy
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import torch

from nerfstudio_thermal_torch.cameras.camera_optimizers import CameraOptimizerConfig
from nerfstudio_thermal_torch.configs.dataparser_configs import build_dataparser
from nerfstudio_thermal_torch.data.datamanagers import (
    FullImageDatamanager,
    FullImageDatamanagerConfig,
    RandomCamerasDataManager,
    RandomCamerasDataManagerConfig,
    VanillaDataManager,
    VanillaDataManagerConfig,
)
from nerfstudio_thermal_torch.data.dataparsers.blender_dataparser import BlenderDataParserConfig
from nerfstudio_thermal_torch.data.dataparsers.instant_ngp_dataparser import InstantNGPDataParserConfig
from nerfstudio_thermal_torch.data.dataparsers.nerfstudio_dataparser import (
    NerfstudioDataParserConfig,
    ThermalNerfDataParserConfig,
)
from nerfstudio_thermal_torch.engine.optimizers import AdamOptimizerConfig, OptimizerGroupConfig
from nerfstudio_thermal_torch.engine.schedulers import (
    CosineDecaySchedulerConfig,
    ExponentialDecaySchedulerConfig,
    MultiStepSchedulerConfig,
)
from nerfstudio_thermal_torch.engine.trainer import Trainer, TrainerConfig
from nerfstudio_thermal_torch.models.depth_nerfacto import DepthNerfactoModel, DepthNerfactoModelConfig
from nerfstudio_thermal_torch.models.generfacto import GenerfactoModel, GenerfactoModelConfig
from nerfstudio_thermal_torch.models.instant_ngp import InstantNGPModel, InstantNGPModelConfig
from nerfstudio_thermal_torch.models.mipnerf import MipNerfModel, MipNerfModelConfig
from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from nerfstudio_thermal_torch.models.neus import NeuSModel, NeuSModelConfig
from nerfstudio_thermal_torch.models.neus_facto import NeuSFactoModel, NeuSFactoModelConfig
from nerfstudio_thermal_torch.models.semantic_nerfw import SemanticNerfWModel, SemanticNerfWModelConfig
from nerfstudio_thermal_torch.models.splatfacto import SplatfactoModel, SplatfactoModelConfig
from nerfstudio_thermal_torch.models.tensorf import TensoRFModel, TensoRFModelConfig
from nerfstudio_thermal_torch.models.thermal_nerfacto import (
    ThermalNerfactoModel,
    ThermalNerfactoModelConfig,
)
from nerfstudio_thermal_torch.models.vanilla_nerf import NeRFModel, VanillaModelConfig
from nerfstudio_thermal_torch.parallel.mesh import Mesh, create_mesh, host_seed
from nerfstudio_thermal_torch.pipelines.base_pipeline import VanillaPipeline
from nerfstudio_thermal_torch.pipelines.dynamic_batch import DynamicBatchPipeline, DynamicBatchPipelineConfig
from nerfstudio_thermal_torch.plugins.registry import discover_methods


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
    dynamic_batch: Optional[DynamicBatchPipelineConfig] = None
    """When set, the pipeline is a DynamicBatchPipeline (instant-ngp)."""


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


def make_instant_ngp() -> MethodConfig:
    return MethodConfig(
        method_name="instant-ngp",
        description="Instant-NGP: hash field with occupancy-grid skipping.",
        trainer=TrainerConfig(
            max_num_iterations=30000, steps_per_eval_batch=500,
            steps_per_save=2000, mixed_precision=True, method_name="instant-ngp",
        ),
        dataparser=NerfstudioDataParserConfig(),
        datamanager=VanillaDataManagerConfig(train_num_rays_per_batch=4096, eval_num_rays_per_batch=4096),
        model=InstantNGPModelConfig(eval_num_rays_per_chunk=8192, compute_dtype="bfloat16"),
        dynamic_batch=DynamicBatchPipelineConfig(),
        optimizers={"fields": _field_opt()},
    )


def make_instant_ngp_bounded() -> MethodConfig:
    """instant-ngp on the instant_ngp parser's scenes: 8192 rays, no scene
    contraction, near plane 0.01, black background."""
    cfg = make_instant_ngp()
    cfg.method_name = "instant-ngp-bounded"
    cfg.trainer.method_name = "instant-ngp-bounded"
    cfg.description = "Instant-NGP for bounded real/synthetic scenes."
    cfg.dataparser = InstantNGPDataParserConfig()
    cfg.datamanager.train_num_rays_per_batch = 8192
    m = cfg.model
    m.disable_scene_contraction = True
    m.near_plane = 0.01
    m.background_color = "black"
    return cfg


def _one_group(lr: float, lr_final: float, max_steps: int) -> Dict[str, OptimizerGroupConfig]:
    return {
        "fields": OptimizerGroupConfig(
            optimizer=AdamOptimizerConfig(lr=lr, eps=1e-8),
            scheduler=ExponentialDecaySchedulerConfig(lr_final=lr_final, max_steps=max_steps),
        )
    }


def make_vanilla_nerf() -> MethodConfig:
    return MethodConfig(
        method_name="vanilla-nerf",
        description="Original NeRF (coarse/fine frequency-encoded fields).",
        trainer=TrainerConfig(max_num_iterations=300000, method_name="vanilla-nerf"),
        dataparser=BlenderDataParserConfig(),
        datamanager=VanillaDataManagerConfig(train_num_rays_per_batch=4096, eval_num_rays_per_batch=4096),
        model=VanillaModelConfig(eval_num_rays_per_chunk=1 << 14, compute_dtype="bfloat16"),
        optimizers=_one_group(5e-4, 5e-5, 300000),
    )


def make_mipnerf() -> MethodConfig:
    return MethodConfig(
        method_name="mipnerf",
        description="MipNeRF: integrated positional encodings over cone frustums.",
        trainer=TrainerConfig(max_num_iterations=1000000, method_name="mipnerf"),
        dataparser=BlenderDataParserConfig(),
        datamanager=VanillaDataManagerConfig(train_num_rays_per_batch=1024, eval_num_rays_per_batch=1024),
        model=MipNerfModelConfig(eval_num_rays_per_chunk=1 << 14, compute_dtype="bfloat16"),
        optimizers=_one_group(5e-4, 5e-6, 1000000),
    )


def make_tensorf() -> MethodConfig:
    return MethodConfig(
        method_name="tensorf",
        description="TensoRF: vector-matrix tensor-decomposed radiance field.",
        trainer=TrainerConfig(max_num_iterations=30000, method_name="tensorf"),
        dataparser=BlenderDataParserConfig(),
        datamanager=VanillaDataManagerConfig(train_num_rays_per_batch=4096, eval_num_rays_per_batch=4096),
        model=TensoRFModelConfig(eval_num_rays_per_chunk=1 << 14),
        optimizers=_one_group(1e-2, 1e-3, 30000),
    )


def make_depth_nerfacto() -> MethodConfig:
    """nerfacto with DepthNerfactoModelConfig carrying nerfacto's model
    settings."""
    cfg = make_nerfacto()
    cfg.method_name = "depth-nerfacto"
    cfg.trainer.method_name = "depth-nerfacto"
    cfg.description = "Nerfacto with depth supervision (DS-NeRF/URF losses)."
    base = cfg.model
    cfg.model = DepthNerfactoModelConfig(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})
    return cfg


def _cosine_group(lr: float, warm_up_end: int, max_steps: int) -> OptimizerGroupConfig:
    return OptimizerGroupConfig(
        optimizer=AdamOptimizerConfig(lr=lr, eps=1e-15),
        scheduler=CosineDecaySchedulerConfig(warm_up_end=warm_up_end, learning_rate_alpha=0.05, max_steps=max_steps),
    )


def make_neus() -> MethodConfig:
    return MethodConfig(
        method_name="neus",
        description="NeuS: neural implicit surfaces by volume rendering. (slow)",
        trainer=TrainerConfig(
            max_num_iterations=100000, steps_per_eval_batch=5000, steps_per_save=20000, steps_per_eval_image=500,
            steps_per_eval_all_images=0, mixed_precision=False, method_name="neus",
        ),
        dataparser=NerfstudioDataParserConfig(),
        datamanager=VanillaDataManagerConfig(train_num_rays_per_batch=1024, eval_num_rays_per_batch=1024),
        model=NeuSModelConfig(eval_num_rays_per_chunk=1024),
        optimizers={"fields": _cosine_group(5e-4, 5000, 300000), "field_background": _cosine_group(5e-4, 5000, 300000)},
    )


def make_neus_facto() -> MethodConfig:
    """NeuS on nerfacto's proposal sampling: a 2 x 256 SDF net on the hash
    grid, a 2 x 256 colour net, no background model."""
    return MethodConfig(
        method_name="neus-facto",
        description="NeuS-Facto: NeuS with proposal-network sampling. (slow)",
        trainer=TrainerConfig(
            max_num_iterations=20001, steps_per_eval_batch=5000, steps_per_save=2000, steps_per_eval_image=5000,
            steps_per_eval_all_images=0, mixed_precision=False, method_name="neus-facto",
        ),
        dataparser=NerfstudioDataParserConfig(),
        datamanager=VanillaDataManagerConfig(train_num_rays_per_batch=2048, eval_num_rays_per_batch=2048),
        model=NeuSFactoModelConfig(
            sdf_num_layers=2, sdf_num_layers_color=2, sdf_hidden_dim=256, sdf_bias=0.5, sdf_beta_init=0.8,
            sdf_use_grid_feature=True, background_model="none", eval_num_rays_per_chunk=2048,
        ),
        optimizers={
            "proposal_networks": OptimizerGroupConfig(
                optimizer=AdamOptimizerConfig(lr=1e-2, eps=1e-15),
                scheduler=MultiStepSchedulerConfig(max_steps=20001, milestones=(10000, 1500, 18000)),
            ),
            "fields": _cosine_group(5e-4, 500, 20001),
        },
    )


def make_semantic_nerfw() -> MethodConfig:
    """nerfacto with SemanticNerfWModelConfig carrying nerfacto's model
    settings, at 4096 rays."""
    cfg = make_nerfacto()
    cfg.method_name = "semantic-nerfw"
    cfg.trainer.method_name = "semantic-nerfw"
    cfg.description = "Semantic NeRF-W: semantics head + transient filtering."
    base = cfg.model
    cfg.model = SemanticNerfWModelConfig(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})
    cfg.datamanager.train_num_rays_per_batch = 4096
    return cfg


def make_splatfacto() -> MethodConfig:
    """Whole-image batches; one Adam group (eps 1e-15) per gaussian
    attribute, the means' learning rate decaying 1.6e-4 -> 1.6e-6 over
    30,000 steps."""

    def _adam(lr, lr_final=None, max_steps=30000):
        return OptimizerGroupConfig(
            optimizer=AdamOptimizerConfig(lr=lr, eps=1e-15),
            scheduler=(
                ExponentialDecaySchedulerConfig(lr_final=lr_final, max_steps=max_steps)
                if lr_final is not None else None
            ),
        )

    return MethodConfig(
        method_name="splatfacto",
        description="Gaussian Splatting model (TPU scan rasterizer).",
        trainer=TrainerConfig(
            max_num_iterations=30000, steps_per_eval_image=100, steps_per_eval_batch=0, steps_per_save=2000,
            steps_per_eval_all_images=1000, mixed_precision=False, method_name="splatfacto",
        ),
        dataparser=NerfstudioDataParserConfig(),
        datamanager=FullImageDatamanagerConfig(),
        model=SplatfactoModelConfig(),
        optimizers={
            "xyz": _adam(1.6e-4, lr_final=1.6e-6, max_steps=30000),
            "features_dc": _adam(0.0025),
            "features_rest": _adam(0.0025 / 20),
            "opacities": _adam(0.05),
            "scales": _adam(0.005),
            "quats": _adam(0.001),
        },
    )


def make_generfacto() -> MethodConfig:
    """Random cameras and the guidance's loss; no data (the dataparser
    config is unused)."""
    return MethodConfig(
        method_name="generfacto",
        description="Generative Text to NeRF model (SDS guidance).",
        trainer=TrainerConfig(
            max_num_iterations=30000, steps_per_eval_batch=0, steps_per_eval_image=0, steps_per_eval_all_images=0,
            steps_per_save=2000, mixed_precision=False, method_name="generfacto",
        ),
        dataparser=NerfstudioDataParserConfig(),
        datamanager=RandomCamerasDataManagerConfig(),
        model=GenerfactoModelConfig(),
        optimizers={
            "fields": OptimizerGroupConfig(optimizer=AdamOptimizerConfig(lr=5e-3, eps=1e-15)),
            "field_background": OptimizerGroupConfig(optimizer=AdamOptimizerConfig(lr=5e-3, eps=1e-15)),
            "proposal_networks": OptimizerGroupConfig(optimizer=AdamOptimizerConfig(lr=1e-2, eps=1e-15)),
        },
    )


_METHODS: Dict[str, Callable[[], MethodConfig]] = {
    "nerfacto": make_nerfacto,
    "thermal-nerfacto": make_thermal_nerfacto,
    "nerfacto-tpu": lambda: _tpu_variant(make_nerfacto(), "nerfacto-tpu"),
    "thermal-nerfacto-tpu": lambda: _tpu_variant(make_thermal_nerfacto(), "thermal-nerfacto-tpu"),
    "nerfacto-big": make_nerfacto_big,
    "nerfacto-huge": make_nerfacto_huge,
    "instant-ngp": make_instant_ngp,
    "instant-ngp-bounded": make_instant_ngp_bounded,
    "vanilla-nerf": make_vanilla_nerf,
    "mipnerf": make_mipnerf,
    "depth-nerfacto": make_depth_nerfacto,
    "tensorf": make_tensorf,
    "neus": make_neus,
    "neus-facto": make_neus_facto,
    "semantic-nerfw": make_semantic_nerfw,
    "splatfacto": make_splatfacto,
    "generfacto": make_generfacto,
}


descriptions: Dict[str, str] = {name: make().description for name, make in _METHODS.items()}


# methods found by plugins/registry.py: name -> MethodConfig
_PLUGINS: Dict[str, MethodConfig] = {}


def register_method(config: MethodConfig) -> None:
    """Make `config` a method of this process under config.method_name:
    `get_method_config` and ns-train find it (after the built-in methods
    of that name, as a plugin's)."""
    _PLUGINS[config.method_name] = config


def method_names() -> Dict[str, str]:
    """Every method's description by name, the plugins' included."""
    discover_methods(_PLUGINS)
    return {**descriptions, **{k: getattr(v, "description", "") for k, v in _PLUGINS.items()}}


def get_method_config(name: str) -> MethodConfig:
    discover_methods(_PLUGINS)
    if name in _METHODS:
        return _METHODS[name]()
    if name in _PLUGINS:
        config = _PLUGINS[name]
        if not isinstance(config, MethodConfig):
            raise TypeError(f"plugin method '{name}' is a {type(config).__name__}, not a MethodConfig of this package")
        return copy.deepcopy(config)
    raise KeyError(f"unknown method '{name}'; available: {sorted({**_METHODS, **_PLUGINS})}")


def resolve_model_class(model_config) -> type:
    """Model config -> model class, the most derived config first. As in
    the JAX package, generfacto's config resolves to NerfactoModel here:
    `setup_trainer` builds its model itself."""
    for config_cls, model_cls in (
        (SplatfactoModelConfig, SplatfactoModel),
        (NeuSFactoModelConfig, NeuSFactoModel),
        (NeuSModelConfig, NeuSModel),
        (SemanticNerfWModelConfig, SemanticNerfWModel),
        (TensoRFModelConfig, TensoRFModel),
        (InstantNGPModelConfig, InstantNGPModel),
        (DepthNerfactoModelConfig, DepthNerfactoModel),
        (ThermalNerfactoModelConfig, ThermalNerfactoModel),
        (MipNerfModelConfig, MipNerfModel),
        (VanillaModelConfig, NeRFModel),
    ):
        if isinstance(model_config, config_cls):
            return model_cls
    return NerfactoModel


def setup_trainer(
    config: MethodConfig,
    base_dir: Optional[Path] = None,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[Mesh] = None,
    datamanager_cls: Optional[type] = None,
) -> Trainer:
    """Dataparser -> data manager -> model -> pipeline -> trainer. The model
    is built on `device` (CUDA unless the caller asks for the CPU) from the
    trainer's seed, of the class `resolve_model_class` gives. A generative
    config (generfacto) trains from random cameras: no dataparser, no
    images. Splatfacto starts from a parser's `points3D_xyz` /
    `points3D_rgb` where they exist (no parser writes them). `mesh`
    (default: `create_mesh` of trainer.num_devices) places the run's rank;
    each host samples with the data manager's seed + 7919 x its index, as
    the JAX package's processes do (on a copy of the data manager's config).
    `datamanager_cls` replaces `VanillaDataManager` for a ray-batch config
    (`PrefetchingDataManager`: no method config or flag selects it)."""
    mesh = mesh if mesh is not None else create_mesh(config.trainer.num_devices)
    dm_config = dataclasses.replace(config.datamanager, seed=host_seed(config.datamanager.seed, mesh))
    seed = config.trainer.seed
    if isinstance(config.model, GenerfactoModelConfig):
        datamanager = RandomCamerasDataManager(dm_config)
        model = GenerfactoModel(
            config.model, scene_aabb=datamanager.train_dataparser_outputs.scene_box, num_train_data=1,
            metadata={}, device=device, seed=seed,
        )
        return Trainer(config.trainer, VanillaPipeline(datamanager, model), config.optimizers, base_dir=base_dir, mesh=mesh)
    if config.data is not None:
        config.dataparser.data = Path(config.data)
    if isinstance(config.datamanager, FullImageDatamanagerConfig):
        dm_cls = FullImageDatamanager
    else:
        dm_cls = datamanager_cls or VanillaDataManager
    datamanager = dm_cls(dm_config, build_dataparser(config.dataparser))
    metadata = dict(datamanager.train_dataparser_outputs.metadata)
    if "is_thermal" not in metadata:
        metadata["is_thermal"] = list(datamanager.train_dataset.is_thermal)
    common = dict(
        scene_aabb=datamanager.train_dataparser_outputs.scene_box, num_train_data=len(datamanager.train_dataset),
        metadata=metadata, device=device, seed=seed,
    )
    if isinstance(config.model, SplatfactoModelConfig):
        md = datamanager.train_dataparser_outputs.metadata
        seed_points = (md["points3D_xyz"], md.get("points3D_rgb")) if md.get("points3D_xyz") is not None else None
        model = SplatfactoModel(config.model, seed_points=seed_points, **common)
        return Trainer(config.trainer, VanillaPipeline(datamanager, model), config.optimizers, base_dir=base_dir, mesh=mesh)
    model = resolve_model_class(config.model)(config.model, **common)
    if config.dynamic_batch is not None:
        pipeline = DynamicBatchPipeline(datamanager, model, config.dynamic_batch)
    else:
        pipeline = VanillaPipeline(datamanager, model)
    return Trainer(config.trainer, pipeline, config.optimizers, base_dir=base_dir, mesh=mesh)
