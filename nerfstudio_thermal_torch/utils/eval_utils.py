"""eval_setup: reload a trained run from its config.yml and latest checkpoint
(counterpart of nerfstudio_thermal_tpu/utils/eval_utils.py).
"""

from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from nerfstudio_thermal_torch.configs.method_configs import MethodConfig, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import load_config
from nerfstudio_thermal_torch.engine.trainer import Trainer


def eval_setup(
    config_path: Path,
    load_step: Optional[int] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[MethodConfig, Trainer]:
    """The run's config (its trainer's load_dir pointed at
    <run>/nerfstudio_models) and a trainer set up from it, the checkpoint
    loaded into its model. The JAX package also returns host params; here
    the parameters live in `trainer.model`."""
    config_path = Path(config_path)
    config = load_config(config_path)
    base_dir = config_path.parent
    config.trainer.load_dir = base_dir / "nerfstudio_models"
    config.trainer.load_step = load_step
    trainer = setup_trainer(config, base_dir=base_dir, device=device)
    trainer.setup(eval_only=True)
    return config, trainer
