"""Learning-rate schedules (counterpart of nerfstudio_thermal_tpu/engine/schedulers.py).

A schedule maps the step (counted from 0, before the update) to a learning
rate. It is evaluated on the host with f32 scalar tensors, the arithmetic
the JAX package does inside its step; exp, log, cos and pow of the two
math libraries may differ in the last bit. The exponential decay of the
nerfacto family, the multi-step decay and the cosine decay with a linear
warm-up.
"""

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch


@dataclass
class SchedulerConfig:
    def make(self, lr_init: float) -> Callable[[int], float]:
        raise NotImplementedError


def f32(v) -> torch.Tensor:
    """An f32 scalar tensor: the schedules' (and RAdam's) host arithmetic."""
    return torch.tensor(v, dtype=torch.float32)


@dataclass
class ExponentialDecaySchedulerConfig(SchedulerConfig):
    lr_pre_warmup: float = 1e-8
    lr_final: Optional[float] = None
    warmup_steps: int = 0
    max_steps: int = 100000
    ramp: str = "cosine"

    def make(self, lr_init: float) -> Callable[[int], float]:
        lr_final = self.lr_final if self.lr_final is not None else lr_init

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


@dataclass
class MultiStepSchedulerConfig(SchedulerConfig):
    """lr_init * gamma ** (the number of milestones the step has reached)."""

    max_steps: int = 1000000
    gamma: float = 0.33
    milestones: Tuple[int, ...] = (500000, 750000, 900000)

    def make(self, lr_init: float) -> Callable[[int], float]:
        def schedule(step: int) -> float:
            n = sum(step >= m for m in self.milestones)
            return float(f32(lr_init) * torch.pow(f32(self.gamma), f32(float(n))))

        return schedule


@dataclass
class CosineDecaySchedulerConfig(SchedulerConfig):
    """A linear warm-up to lr_init over warm_up_end steps, then a cosine
    decay to learning_rate_alpha * lr_init at max_steps."""

    warm_up_end: int = 5000
    learning_rate_alpha: float = 0.05
    max_steps: int = 300000

    def make(self, lr_init: float) -> Callable[[int], float]:
        def schedule(step: int) -> float:
            s = f32(float(step))
            if step < self.warm_up_end:
                factor = s / max(self.warm_up_end, 1)
            else:
                alpha = self.learning_rate_alpha
                progress = (s - self.warm_up_end) / max(self.max_steps - self.warm_up_end, 1)
                factor = (torch.cos(math.pi * torch.clamp(progress, 0.0, 1.0)) + 1.0) * 0.5 * (1 - alpha) + alpha
            return float(lr_init * factor)

        return schedule
