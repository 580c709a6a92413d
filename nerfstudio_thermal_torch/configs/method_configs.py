"""Method registry, model configs only
(counterpart of nerfstudio_thermal_tpu/configs/method_configs.py).

This slice carries the model configs of `thermal-nerfacto` and
`thermal-nerfacto-tpu` under the JAX package's names. The trainer, data
manager and optimizer groups arrive with the training slice.
"""

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict

from nerfstudio_thermal_torch.cameras.camera_optimizers import CameraOptimizerConfig
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModelConfig


@dataclass
class MethodConfig:
    method_name: str
    model: ThermalNerfactoModelConfig = field(default_factory=ThermalNerfactoModelConfig)
    description: str = ""


def make_thermal_nerfacto() -> MethodConfig:
    return MethodConfig(
        method_name="thermal-nerfacto",
        description="Multispectral RGB+thermal nerfacto (ThermalNeRF).",
        model=ThermalNerfactoModelConfig(
            eval_num_rays_per_chunk=1 << 15,
            camera_optimizer=CameraOptimizerConfig(mode="SO3xR3"),
            compute_dtype="bfloat16",
        ),
    )


_FREQ_PROPOSAL_ARGS = [
    {"encoding": "freq", "hidden_dim": 64, "num_layers": 3, "num_frequencies": 5},
    {"encoding": "freq", "hidden_dim": 64, "num_layers": 3, "num_frequencies": 7},
]


def _tpu_variant(base: MethodConfig, name: str) -> MethodConfig:
    """The compute-dense variant: frequency-MLP proposal fields and a deep
    frequency-MLP base field (8 x 256, skip at 4) through the fused MLP."""
    cfg = copy.deepcopy(base)
    cfg.method_name = name
    cfg.description = base.description + " (TPU compute-dense variant)"
    m = cfg.model
    m.field_encoding = "freq"
    m.proposal_net_args_list = copy.deepcopy(_FREQ_PROPOSAL_ARGS)
    m.compute_dtype = "bfloat16"
    m.freq_final_init_scale = 0.1
    m.use_pallas = True
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
