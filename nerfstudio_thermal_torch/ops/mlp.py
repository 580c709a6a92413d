"""MLPs (counterpart of nerfstudio_thermal_tpu/ops/mlp.py): `MLP` and the
hash-grid base network `MLPWithHashEncoding`.

Params are f32; compute runs in `compute_dtype`. A stack that passes the
`_fusable` gate (relu hidden layers, none/sigmoid output, width >= 128 and
>= 4 layers, `fused=True`) runs as one fused-MLP call
(ops/cuda/fused_mlp.py): the hand-written kernel on CUDA, its plain version
on the CPU. Any other stack runs eagerly, layer by layer, with the
arithmetic of flax's `nn.Dense` at the compute dtype: operands rounded to
the compute dtype, the product rounded to it, then the bias added and the
sum rounded again. A stack with an in-kernel frequency encoding that passes
`will_fuse_rays` (no width gate) also runs from rays: `forward_rays` is the
fused ray-march (ops/cuda/fused_ray.py), and `export_params` hands the
weights to the whole-field kernel.

Layer-count semantics: num_layers == 1 is a single in -> out layer;
otherwise (num_layers - 1) hidden layers and an output layer.
"""

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from nerfstudio_thermal_torch.ops.cuda.fused_mlp import PackCache, encoding_dim, fused_mlp
from nerfstudio_thermal_torch.ops.cuda.fused_ray import fused_ray_mlp
from nerfstudio_thermal_torch.ops.encodings import HashEncoding, NeRFEncoding

# flax variance_scaling("truncated_normal"): stddev of a unit normal
# truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(weight: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal") on a
    torch [dout, din] weight."""
    std = math.sqrt(scale / weight.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype): x @ W then + b, each rounded to dtype.
    On the card that is one GEMM in the compute dtype (exact products, f32
    accumulation, one rounding; pin_precision forbids reduced-precision
    reductions) and an add in it; the CPU spells the same roundings out."""
    if dtype == torch.float32:
        return x.float() @ weight.t().float() + bias.float()
    if x.is_cuda:
        return x.to(dtype) @ weight.t().to(dtype) + bias.to(dtype)
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
        ray_input_grads: bool = True,
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
        # forward_rays: d(origins, dirs, ts) in the backward; False when the
        # caller detaches the ray geometry
        self.ray_input_grads = ray_input_grads
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
        self.pack_cache = PackCache()  # the fused path's packed weights

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun-normal kernels (the last scaled by final_init_scale^2 in
        variance), zero biases."""
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                last = i == len(self.layers) - 1
                scale = self.final_init_scale**2 if last and self.final_init_scale != 1.0 else 1.0
                variance_scaling_(layer.weight, scale, generator)
                layer.bias.zero_()

    def _act_ok(self) -> bool:
        return self.activation == "relu" and self.out_activation in (None, "sigmoid")

    def _fusable(self) -> bool:
        big_enough = self.layer_width >= 128 and self.num_layers >= 4
        return self.fused and self._act_ok() and big_enough

    def will_fuse_rays(self) -> bool:
        """Whether `forward_rays` runs: no width gate, so the narrow
        proposal stacks fuse too once the ray march folds in."""
        return self.fused and self._act_ok() and self.freq_encoding is not None

    def export_params(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """This stack's (weights [din, dout], biases), for a kernel that runs
        it inside a larger one (the whole-field kernel)."""
        return [layer.weight.t() for layer in self.layers], [layer.bias for layer in self.layers]

    def forward_rays(self, origins: torch.Tensor, dirs: torch.Tensor, ts: torch.Tensor,
                     num_samples: int) -> torch.Tensor:
        """The fused ray march: origins, dirs [R, 3], ts [R * S, 1] ->
        [R * S, out_dim + 1] in the compute dtype, the in-scene selector
        last. Callers gate on `will_fuse_rays`."""
        if not self.will_fuse_rays():
            raise ValueError("forward_rays needs fused=True, relu layers, a none/sigmoid output and freq_encoding")
        weights, biases = self.export_params()
        return fused_ray_mlp(
            origins, dirs, ts, weights, biases, num_samples, self.out_activation, self.skip_connections,
            self.freq_encoding, self.compute_dtype, self.ray_input_grads, self.pack_cache,
        )

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
                self.pack_cache,
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


class MLPWithHashEncoding(nn.Module):
    """Hash-grid encoding feeding an eager MLP: the base network of the
    hash-grid nerfacto fields. Submodules `encoding` and `mlp`, as the JAX
    module names them."""

    def __init__(
        self,
        num_levels: int = 16,
        min_res: int = 16,
        max_res: int = 1024,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        num_layers: int = 2,
        layer_width: int = 64,
        out_dim: int = 16,
        activation: Optional[str] = "relu",
        out_activation: Optional[str] = None,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.encoding = HashEncoding(
            num_levels=num_levels,
            min_res=min_res,
            max_res=max_res,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=features_per_level,
            compute_dtype=compute_dtype,
        )
        self.mlp = MLP(
            in_dim=self.encoding.out_dim,
            num_layers=num_layers,
            layer_width=layer_width,
            out_dim=out_dim,
            activation=activation,
            out_activation=out_activation,
            compute_dtype=compute_dtype,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoding.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.encoding(positions))
