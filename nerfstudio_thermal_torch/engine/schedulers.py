"""Learning-rate schedules (counterpart of nerfstudio_thermal_tpu/engine/schedulers.py).

A schedule maps the step (counted from 0, before the update) to a learning
rate. It is evaluated on the host with f32 scalar tensors, the arithmetic
the JAX package does inside its step; exp and log of the two math
libraries may differ in the last bit. This slice carries the exponential decay of the nerfacto
family; the multi-step and cosine schedules wait for the models that use
them.
"""

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass
class SchedulerConfig:
    def make(self, lr_init: float) -> Callable[[int], float]:
        raise NotImplementedError


@dataclass
class ExponentialDecaySchedulerConfig(SchedulerConfig):
    lr_pre_warmup: float = 1e-8
    lr_final: Optional[float] = None
    warmup_steps: int = 0
    max_steps: int = 100000
    ramp: str = "cosine"

    def make(self, lr_init: float) -> Callable[[int], float]:
        lr_final = self.lr_final if self.lr_final is not None else lr_init

        def f32(v) -> torch.Tensor:
            return torch.tensor(v, dtype=torch.float32)

        def schedule(step: int) -> float:
            s = f32(float(step))
            if step < self.warmup_steps:
                if self.ramp == "cosine":
                    frac = torch.clamp(s / self.warmup_steps, 0.0, 1.0)
                    warm = f32(self.lr_pre_warmup) + (f32(lr_init) - f32(self.lr_pre_warmup)) * torch.sin(
                        0.5 * math.pi * frac
                    )
                else:
                    warm = f32(self.lr_pre_warmup) + (f32(lr_init) - f32(self.lr_pre_warmup)) * s / self.warmup_steps
                return float(warm)
            t = torch.clamp((s - self.warmup_steps) / max(self.max_steps - self.warmup_steps, 1), 0.0, 1.0)
            return float(torch.exp(torch.log(f32(lr_init)) * (1 - t) + torch.log(f32(lr_final)) * t))

        return schedule
