"""Special activations (counterpart of nerfstudio_thermal_tpu/ops/activations.py).

`trunc_exp` keeps the reference's hazard on purpose: the forward is a bare
exp with no clamp (it overflows f32 above ~88); only the gradient is
computed with the input clamped to [-15, 15].
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) forward; d/dx = exp(clamp(x, -15, 15)) backward."""
    return _TruncExp.apply(x)
