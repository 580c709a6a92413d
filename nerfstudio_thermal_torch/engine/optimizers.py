"""Per-param-group optimizers (counterpart of nerfstudio_thermal_tpu/engine/optimizers.py).

One optimizer per param group, the optax chain the JAX package builds for
it: clip_by_global_norm(max_norm) when max_norm is set (the norm over that
group's parameters only: the chain sits inside optax.multi_transform),
then radam(eps), adamw(eps, weight_decay) when weight_decay > 0, or
adam(eps). The semantics are optax's rather than torch.optim's:
- every group steps every step, and a parameter without a gradient (a
  proposal net on a step without proposal update, say) counts as a zero
  gradient: its moments still decay and the momentum still moves it, and
  the group's step count advances (torch.optim.Adam would skip it);
- the learning rate of an update is schedule(t), t the group's count of
  updates before this one; the bias corrections use the count after it;
- adam: update = -lr * m_hat / (sqrt(v_hat) + eps); adamw adds
  weight_decay * param to the Adam direction before the learning rate
  scales it (every parameter decays: optax's mask None); radam uses the
  rectified direction r m_hat / (sqrt(v_hat) + eps) where the variance
  estimate is tractable (rho >= 5, optax's threshold) and m_hat elsewhere.
`MultiSteps` is optax.MultiSteps over all groups: gradient accumulation.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from nerfstudio_thermal_torch.engine.schedulers import SchedulerConfig, f32

RADAM_THRESHOLD = 5.0  # optax.radam's: rectify once rho reaches it


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
class RAdamOptimizerConfig(OptimizerConfig):
    optimizer_type: str = "radam"


@dataclass
class OptimizerGroupConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: Optional[SchedulerConfig] = None


class Adam:
    """optax's adam, adamw or radam over one param group, after an optional
    clip_by_global_norm."""

    def __init__(
        self,
        params: Sequence[nn.Parameter],
        schedule: Callable[[int], float],
        eps: float,
        b1: float = 0.9,
        b2: float = 0.999,
        kind: str = "adam",
        weight_decay: float = 0.0,
        max_norm: Optional[float] = None,
    ):
        if kind not in ("adam", "adamw", "radam"):
            raise ValueError(f"optimizer kind {kind!r}")
        self.params = list(params)
        self.schedule = schedule
        self.eps, self.b1, self.b2 = eps, b1, b2
        self.kind, self.weight_decay, self.max_norm = kind, weight_decay, max_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def gradients(self) -> List[torch.Tensor]:
        """Each parameter's .grad, zeros where it has none."""
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: g / norm * max_norm unless norm <
        max_norm, decided on the device (no host sync)."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_norm
        return [torch.where(keep, g, g / norm * self.max_norm) for g in grads]

    def _radam_factor(self) -> Optional[float]:
        """The rectification r of this update in f32, or None where the
        variance is not tractable (rho < RADAM_THRESHOLD: the update is
        m_hat)."""
        b2 = self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = torch.pow(f32(b2), f32(float(self.count)))
        ro = ro_inf - 2 * self.count * b2t / (1 - b2t)
        if not bool(ro >= RADAM_THRESHOLD):
            return None
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return float(r)

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from `grads` (by default the parameters' .grad)."""
        lr = self.schedule(self.count)
        self.count += 1
        grads = self.gradients() if grads is None else grads
        if self.max_norm is not None:
            grads = self._clip(grads)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        upd = torch._foreach_div(self.mu, bc1)
        r = self._radam_factor() if self.kind == "radam" else 1.0
        if r is not None:
            denom = torch._foreach_div(self.nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            if self.kind == "radam":
                torch._foreach_mul_(upd, r)
            torch._foreach_div_(upd, denom)
        if self.kind == "adamw":
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
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


class MultiSteps:
    """optax.MultiSteps(every_k_schedule=k) over every group: each step
    folds the gradients (zeros where a parameter has none) into their
    running mean acc += (g - acc) / (n + 1), n the mini-step; the k-th
    mini-step updates every group from that mean and resets it. Between
    updates the parameters, the moments, the counts and with them the
    learning rates stay as they are."""

    def __init__(self, inner: Optimizers, every_k: int):
        if every_k < 1:
            raise ValueError(f"gradient accumulation over {every_k} steps")
        self.inner = inner
        self.every_k = every_k
        self.groups = inner.groups
        self.mini_step = 0
        self.acc = {name: [torch.zeros_like(p) for p in opt.params] for name, opt in self.groups.items()}

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    @torch.no_grad()
    def step(self) -> bool:
        """Accumulate this step's gradients; returns whether the groups were
        updated (on the k-th mini-step)."""
        for name, opt in self.groups.items():
            delta = torch._foreach_sub(opt.gradients(), self.acc[name])
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc[name], delta)
        emit = self.mini_step == self.every_k - 1
        self.mini_step = (self.mini_step + 1) % self.every_k
        if emit:
            for name, opt in self.groups.items():
                opt.step(self.acc[name])
                self.acc[name] = [torch.zeros_like(p) for p in opt.params]
        return emit

    def state_dict(self) -> Dict:
        return {
            "inner": self.inner.state_dict(),
            "mini_step": self.mini_step,
            "acc": {name: [t.clone() for t in acc] for name, acc in self.acc.items()},
        }

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for name, acc in self.acc.items():
            for dst, src in zip(acc, state["acc"][name]):
                dst.copy_(src)


def build_optimizer(
    group_configs: Dict[str, OptimizerGroupConfig],
    param_groups: Dict[str, List[nn.Parameter]],
) -> Optimizers:
    """One optimizer per param group present; every group needs a config."""
    groups = {}
    for name, params in param_groups.items():
        gc = group_configs.get(name)
        if gc is None:
            raise KeyError(f"no optimizer config for param group '{name}'")
        opt = gc.optimizer
        if opt.optimizer_type == "radam":
            kind = "radam"
        else:
            kind = "adamw" if opt.weight_decay > 0 else "adam"
        schedule = gc.scheduler.make(opt.lr) if gc.scheduler is not None else (lambda step, lr=opt.lr: lr)
        groups[name] = Adam(params, schedule, eps=opt.eps, kind=kind, weight_decay=opt.weight_decay,
                            max_norm=opt.max_norm)
    return Optimizers(groups)
