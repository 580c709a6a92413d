"""Math helpers (counterpart of nerfstudio_thermal_tpu/utils/math.py).

`cumsum` carries the semantics of the JAX package's `cumsum_mxu`, which
writes the prefix sum as a triangular matmul for the TPU's matrix unit.
Here it is `torch.cumsum`: the same sums in another order, so the two
agree to f32 rounding, not bitwise. `safe_norm` and the masked `psnr` serve
the training losses and metrics; `psnr` and `ssim` also score whole eval
images, on whatever device the image lives on.
"""

from typing import Optional

import torch
import torch.nn.functional as F


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


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def ssim(
    pred: torch.Tensor,  # [H, W, C] in [0, 1]
    target: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity over a full image (Wang et al. 2004): the mean
    of the SSIM map, a separable Gaussian window with valid padding along H
    and then W, per channel."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    g = _gaussian_kernel(kernel_size, sigma, pred.device)
    channels = pred.shape[-1]
    kh = g.view(1, 1, -1, 1).expand(channels, 1, -1, 1)
    kw = g.view(1, 1, 1, -1).expand(channels, 1, 1, -1)

    def blur(img):  # [H, W, C] -> [C, H - k + 1, W - k + 1], channels apart
        x = img.permute(2, 0, 1).unsqueeze(0)
        return F.conv2d(F.conv2d(x, kh, groups=channels), kw, groups=channels)[0]

    pred = pred.float()
    target = target.float()
    mu_x = blur(pred)
    mu_y = blur(target)
    mu_xx = blur(pred * pred)
    mu_yy = blur(target * target)
    mu_xy = blur(pred * target)

    sigma_x = mu_xx - mu_x**2
    sigma_y = mu_yy - mu_y**2
    sigma_xy = mu_xy - mu_x * mu_y

    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)
