"""Input encodings (counterpart of nerfstudio_thermal_tpu/ops/encodings.py).

This slice carries the sinusoidal `NeRFEncoding` and the spherical-harmonic
`SHEncoding`. The hash-grid encodings come with the training slice of
`thermal-nerfacto`.

`NeRFEncoding` keeps the JAX module's arithmetic, which differs from the
in-kernel encoding of the fused MLP (ops/cuda/fused_mlp.py): here the input
is scaled by 2*pi, then by 2^e, and the cosine is sin(x + pi/2).
"""

import math

import torch


class NeRFEncoding:
    """Multi-scale sinusoidal encoding.

    Output [..., in_dim * num_frequencies * 2 (+ in_dim if include_input)],
    laid out [sin(d*F + k) ..., cos(d*F + k) ..., x].
    """

    def __init__(
        self,
        in_dim: int = 3,
        num_frequencies: int = 2,
        min_freq_exp: float = 0.0,
        max_freq_exp: float = 1.0,
        include_input: bool = False,
    ) -> None:
        self.in_dim = in_dim
        self.num_frequencies = num_frequencies
        self.min_freq_exp = min_freq_exp
        self.max_freq_exp = max_freq_exp
        self.include_input = include_input

    @property
    def out_dim(self) -> int:
        d = self.in_dim * self.num_frequencies * 2
        return d + self.in_dim if self.include_input else d

    def __call__(self, in_tensor: torch.Tensor) -> torch.Tensor:
        scaled = (2.0 * math.pi) * in_tensor
        exps = torch.linspace(
            self.min_freq_exp, self.max_freq_exp, self.num_frequencies,
            dtype=torch.float32, device=in_tensor.device,
        )
        freqs = torch.pow(2.0, exps)
        scaled = (scaled[..., None] * freqs).reshape(*scaled.shape[:-1], -1)
        encoded = torch.sin(torch.cat([scaled, scaled + math.pi / 2.0], dim=-1))
        if self.include_input:
            encoded = torch.cat([encoded, in_tensor], dim=-1)
        return encoded


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real spherical-harmonic components of unit directions, levels in [1, 5].

    Returns [..., levels**2]."""
    if not 1 <= levels <= 5:
        raise ValueError(f"SH levels must be in [1, 5], got {levels}")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.9461746957575601 * zz - 0.31539156525251999,
            1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if levels > 4:
        comps += [
            2.5033429417967046 * x * y * (xx - yy),
            1.7701307697799304 * y * z * (3 * xx - yy),
            0.9461746957575601 * x * y * (7 * zz - 1),
            0.6690465435572892 * y * z * (7 * zz - 3),
            0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
            0.6690465435572892 * x * z * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1),
            1.7701307697799304 * x * z * (xx - 3 * yy),
            0.6258357354491761 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


class SHEncoding:
    """Spherical-harmonic direction encoding."""

    def __init__(self, levels: int = 4) -> None:
        self.levels = levels

    @property
    def out_dim(self) -> int:
        return self.levels**2

    def __call__(self, directions: torch.Tensor) -> torch.Tensor:
        return sh_encoding(directions, self.levels)
