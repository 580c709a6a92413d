"""MLPs (counterpart of nerfstudio_thermal_tpu/ops/mlp.py).

Params are f32; compute runs in `compute_dtype`. A stack that passes the
`_fusable` gate (relu hidden layers, none/sigmoid output, width >= 128 and
>= 4 layers, `fused=True`) runs as one fused-MLP call
(ops/cuda/fused_mlp.py): the hand-written kernel on CUDA, its plain version
on the CPU. Any other stack runs eagerly, layer by layer, with the
arithmetic of flax's `nn.Dense` at the compute dtype: operands rounded to
the compute dtype, the product rounded to it, then the bias added and the
sum rounded again.

Layer-count semantics: num_layers == 1 is a single in -> out layer;
otherwise (num_layers - 1) hidden layers and an output layer.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.ops.cuda.fused_mlp import encoding_dim, fused_mlp
from nerfstudio_thermal_torch.ops.encodings import NeRFEncoding

# flax variance_scaling("truncated_normal"): stddev of a unit normal
# truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(weight: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal") on a
    torch [dout, din] weight."""
    std = math.sqrt(scale / weight.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype): x @ W then + b, each rounded to dtype."""
    if dtype == torch.float32:
        return x.float() @ weight.t().float() + bias.float()
    y = (x.to(dtype).float() @ weight.t().to(dtype).float()).to(dtype)
    return (y.float() + bias.to(dtype).float()).to(dtype)


class MLP(nn.Module):
    """`num_layers` linear layers of `layer_width`, then the output layer.

    in_dim is the raw input width: 3 coordinates when `freq_encoding` is
    set (the encoding is then part of the MLP), else the feature width."""

    def __init__(
        self,
        in_dim: int,
        num_layers: int,
        layer_width: int,
        out_dim: int,
        skip_connections: Sequence[int] = (),
        activation: Optional[str] = "relu",
        out_activation: Optional[str] = None,
        compute_dtype: torch.dtype = torch.float32,
        fused: bool = False,
        freq_encoding: Optional[Tuple[int, float, float, bool]] = None,
        final_init_scale: float = 1.0,
    ) -> None:
        super().__init__()
        self.in_dim = in_dim
        self.num_layers = num_layers
        self.layer_width = layer_width
        self.out_dim = out_dim
        self.skip_connections = tuple(sorted(set(skip_connections)))
        self.activation = activation
        self.out_activation = out_activation
        self.compute_dtype = compute_dtype
        self.fused = fused
        self.freq_encoding = freq_encoding
        self.final_init_scale = final_init_scale
        enc_dim = encoding_dim(in_dim, freq_encoding)
        num_linears = 1 if num_layers == 1 else num_layers
        layers = []
        prev = enc_dim
        for i in range(num_linears):
            width = out_dim if i == num_linears - 1 else layer_width
            din = prev + (enc_dim if (i in self.skip_connections and i != 0) else 0)
            layers.append(nn.Linear(din, width))
            prev = width
        self.layers = nn.ModuleList(layers)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal kernels (the last scaled by final_init_scale^2 in
        variance), zero biases."""
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                last = i == len(self.layers) - 1
                scale = self.final_init_scale**2 if last and self.final_init_scale != 1.0 else 1.0
                variance_scaling_(layer.weight, scale, generator)
                layer.bias.zero_()

    def _fusable(self) -> bool:
        act_ok = self.activation == "relu" and self.out_activation in (None, "sigmoid")
        big_enough = self.layer_width >= 128 and self.num_layers >= 4
        return self.fused and act_ok and big_enough

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fusable():
            if self.freq_encoding is not None:
                x = x.float()  # raw coordinates stay f32; encoded in the kernel
            else:
                x = x.to(self.compute_dtype)
            out = fused_mlp(
                x.reshape(-1, x.shape[-1]),
                [layer.weight.t() for layer in self.layers],
                [layer.bias for layer in self.layers],
                "relu",
                self.out_activation,
                self.skip_connections,
                self.freq_encoding,
                self.compute_dtype,
            )
            return out.reshape(*x.shape[:-1], self.out_dim)

        if self.freq_encoding is not None:
            nf, mn, mx, inc = self.freq_encoding
            x = NeRFEncoding(
                in_dim=self.in_dim, num_frequencies=nf, min_freq_exp=mn,
                max_freq_exp=mx, include_input=inc,
            )(x.float())
        x = x.to(self.compute_dtype)
        in_tensor = x
        for i, layer in enumerate(self.layers):
            last = i == len(self.layers) - 1
            if i in self.skip_connections and i != 0:
                x = torch.cat([in_tensor, x], dim=-1)
            x = dense(x, layer.weight, layer.bias, self.compute_dtype)
            if not last and self.activation == "relu":
                x = torch.relu(x)
            elif not last and self.activation is not None:
                raise ValueError(f"unsupported activation {self.activation}")
        if self.out_activation == "sigmoid":
            x = torch.sigmoid(x.float()).to(x.dtype)
        elif self.out_activation is not None:
            raise ValueError(f"unsupported output activation {self.out_activation}")
        return x
