"""Math helpers (counterpart of nerfstudio_thermal_tpu/utils/math.py).

`cumsum` carries the semantics of the JAX package's `cumsum_mxu`, which
writes the prefix sum as a triangular matmul for the TPU's matrix unit.
Here it is `torch.cumsum`: the same sums in another order, so the two
agree to f32 rounding, not bitwise. `safe_norm` and the masked `psnr` serve
the training losses and metrics.
"""

from typing import Optional

import torch


def cumsum(x: torch.Tensor, dim: int = -1, exclusive: bool = False) -> torch.Tensor:
    """Inclusive or exclusive prefix sum along `dim`."""
    out = torch.cumsum(x, dim=dim)
    if exclusive:
        out = torch.cat(
            [torch.zeros_like(out.narrow(dim, 0, 1)), out.narrow(dim, 0, out.shape[dim] - 1)],
            dim=dim,
        )
    return out


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize; vectors with norm below eps are returned unchanged."""
    s = torch.sum(v * v, dim=-1, keepdim=True)
    safe = s > eps * eps
    nrm = torch.sqrt(torch.where(safe, s, torch.ones_like(s)))
    return torch.where(safe, v / nrm, v)


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero (not NaN) gradient at x == 0 (double-where)."""
    s = torch.sum(x * x, dim=dim)
    nonzero = s > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, s, torch.ones_like(s))), torch.zeros_like(s))


def psnr(pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Peak signal-to-noise ratio, data range 1.0. The mask broadcasts over
    elements (masked PSNR = PSNR of the masked subset)."""
    se = (pred - target) ** 2
    if mask is None:
        mse = torch.mean(se)
    else:
        mask = torch.broadcast_to(mask, se.shape)
        mse = torch.sum(se * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
