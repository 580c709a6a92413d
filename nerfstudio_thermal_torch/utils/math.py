"""Math helpers (counterpart of nerfstudio_thermal_tpu/utils/math.py).

`cumsum` carries the semantics of the JAX package's `cumsum_mxu`, which
writes the prefix sum as a triangular matmul for the TPU's matrix unit.
Here it is `torch.cumsum`: the same sums in another order, so the two
agree to f32 rounding, not bitwise.
"""

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
