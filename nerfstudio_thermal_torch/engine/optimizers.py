"""Per-param-group optimizers (counterpart of nerfstudio_thermal_tpu/engine/optimizers.py).

One Adam per param group, with optax's semantics rather than
torch.optim.Adam's:
- every group steps every step, and a parameter without a gradient (a
  proposal net on a step without proposal update, say) counts as a zero
  gradient: its moments still decay and the momentum still moves it, and
  the group's step count advances (torch.optim.Adam would skip it);
- the learning rate of step t is schedule(t), t counted from 0 before the
  update; the bias corrections use the group's own count after it;
- update = -lr * m_hat / (sqrt(v_hat) + eps).
RAdam, weight decay and gradient clipping wait for the configs that use
them and raise.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from nerfstudio_thermal_torch.engine.schedulers import SchedulerConfig


@dataclass
class OptimizerConfig:
    lr: float = 1e-3
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_norm: Optional[float] = None
    optimizer_type: str = "adam"  # adam | radam


@dataclass
class AdamOptimizerConfig(OptimizerConfig):
    optimizer_type: str = "adam"


@dataclass
class OptimizerGroupConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: Optional[SchedulerConfig] = None


class Adam:
    """optax.adam over one param group."""

    def __init__(
        self,
        params: Sequence[nn.Parameter],
        schedule: Callable[[int], float],
        eps: float,
        b1: float = 0.9,
        b2: float = 0.999,
    ):
        self.params = list(params)
        self.schedule = schedule
        self.eps, self.b1, self.b2 = eps, b1, b2
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(self.params, upd, alpha=-lr)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": [t.clone() for t in self.mu], "nu": [t.clone() for t in self.nu]}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


class Optimizers:
    """{group name: Adam}, stepped together."""

    def __init__(self, groups: Dict[str, Adam]):
        self.groups = groups

    def zero_grad(self) -> None:
        for opt in self.groups.values():
            for p in opt.params:
                p.grad = None

    def step(self) -> None:
        for opt in self.groups.values():
            opt.step()

    def state_dict(self) -> Dict:
        return {name: opt.state_dict() for name, opt in self.groups.items()}

    def load_state_dict(self, state: Dict) -> None:
        if set(state) != set(self.groups):
            raise KeyError(f"optimizer groups {sorted(state)} != {sorted(self.groups)}")
        for name, opt in self.groups.items():
            opt.load_state_dict(state[name])


def build_optimizer(
    group_configs: Dict[str, OptimizerGroupConfig],
    param_groups: Dict[str, List[nn.Parameter]],
) -> Optimizers:
    """One Adam per param group present; every group needs a config."""
    groups = {}
    for name, params in param_groups.items():
        gc = group_configs.get(name)
        if gc is None:
            raise KeyError(f"no optimizer config for param group '{name}'")
        opt = gc.optimizer
        if opt.optimizer_type != "adam" or opt.weight_decay > 0 or opt.max_norm is not None:
            raise NotImplementedError(
                f"group '{name}': RAdam, weight decay and gradient clipping are not ported yet"
            )
        schedule = gc.scheduler.make(opt.lr) if gc.scheduler is not None else (lambda step, lr=opt.lr: lr)
        groups[name] = Adam(params, schedule, eps=opt.eps)
    return Optimizers(groups)
