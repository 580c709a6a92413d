"""SDF field of the surface methods, NeuS and NeuS-facto
(counterpart of nerfstudio_thermal_tpu/fields/sdf_field.py).

A geometry MLP of weight-normalised layers (`WNDense`, w = g v / |v|_col)
over [x, the 6-frequency encoding of x, the grid features] gives the SDF
and geo features; softplus with beta 100 between layers, a skip at layer 4
scaled by 1/sqrt(2), the geometric (sphere) initialisation. With
`use_grid_feature` the grid features are a hash encoding of the
inf-norm-contracted positions mapped by (x + 2) / 4 (zeros otherwise,
as in the JAX module). A colour MLP (relu, sigmoid out) over [x, the
direction's encoding, the SDF gradient, geo features, appearance
embedding]. NeuS's learned variance is the parameter `variance` (the JAX
module's): inv_s = min(exp(10 variance), 1e6). The field is evaluated at
frustum starts (NeuS's convention).

The SDF's spatial gradient (the normals) is `torch.autograd.grad` of the
summed SDF with respect to a detached leaf of the positions, taken under
`torch.enable_grad()` so that the render and eval paths, which run under
`torch.no_grad()`, get it too; in training with create_graph=True, so that
the eikonal loss differentiates it again (through the hash grid's
`_HashEncodeBwdPos` node and its VJP kernel on the card). Outside training
the outputs are detached.

softplus_b100 is JAX's `softplus(100 x) / 100` (logaddexp(100 x, 0) /
100), written -logsigmoid(-100 x) / 100: its values and first derivative
are JAX's (sigmoid(100 x), 0.5 at 0) and its second derivative is finite
everywhere. `F.softplus` turns linear above its threshold (second
derivative 0 there) and `torch.logaddexp`'s second derivative is NaN for
large negative inputs (inf / inf). The values differ from JAX's by
<= 4e-9, the first derivatives by <= 6e-7 and the second derivatives by
<= 5e-5 against their peak of 25 (where 1 - sigmoid is a few ulps of 1,
each library rounds it its own way); tests/test_torch_sdf_field.py holds
them to that.

The MLPs are plain f32 matrix products (`torch.matmul`, no TF32 under the
port's precision pin): JAX computes them outside any Pallas kernel.
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from nerfstudio_thermal_torch.cameras.rays import RaySamples
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.ops.encodings import HashEncoding, NeRFEncoding
from nerfstudio_thermal_torch.ops.mlp import variance_scaling_
from nerfstudio_thermal_torch.ops.spatial_distortions import SceneContraction

SKIP_IN = (4,)


def softplus_b100(x: torch.Tensor) -> torch.Tensor:
    """softplus with beta 100: logaddexp(100 x, 0) / 100."""
    return -F.logsigmoid(-100.0 * x) / 100.0


class WNDense(nn.Module):
    """A dense layer with weight normalisation, the JAX layout: `kernel` v
    [din, dout], `bias` [dout], `g` [dout]; x @ (v g / max(|v|_col,
    1e-12)) + b. Without weight norm: x @ v + b (no `g`)."""

    def __init__(self, in_dim: int, out_dim: int, use_weight_norm: bool = True) -> None:
        super().__init__()
        self.use_weight_norm = use_weight_norm
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        if use_weight_norm:
            self.g = nn.Parameter(torch.ones(out_dim))

    def weight(self) -> torch.Tensor:
        v = self.kernel
        if not self.use_weight_norm:
            return v
        norm = torch.linalg.vector_norm(v, dim=0)
        return v * (self.g / torch.clamp(norm, min=1e-12))[None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight() + self.bias

    def reset_parameters(self, generator: torch.Generator, kernel: Optional[torch.Tensor] = None,
                         bias: float = 0.0) -> None:
        """`kernel` ([din, dout]) or lecun-normal; the bias constant; g the
        kernel's column norms (w = v at initialisation)."""
        with torch.no_grad():
            if kernel is None:
                t = torch.empty(self.kernel.shape[1], self.kernel.shape[0])
                variance_scaling_(t, 1.0, generator)
                kernel = t.t()
            self.kernel.copy_(kernel)
            self.bias.fill_(bias)
            if self.use_weight_norm:
                self.g.copy_(torch.linalg.vector_norm(self.kernel, dim=0))


class SDFField(nn.Module):
    def __init__(
        self,
        aabb,
        num_images: int,
        num_layers: int = 8,
        hidden_dim: int = 256,
        geo_feat_dim: int = 256,
        num_layers_color: int = 4,
        hidden_dim_color: int = 256,
        appearance_embedding_dim: int = 32,
        use_appearance_embedding: bool = False,
        use_average_appearance_embedding: bool = False,
        bias: float = 0.8,
        geometric_init: bool = True,
        inside_outside: bool = True,
        weight_norm: bool = True,
        use_grid_feature: bool = False,
        beta_init: float = 0.1,
        num_levels: int = 16,
        max_res: int = 2048,
        base_res: int = 16,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
    ) -> None:
        super().__init__()
        self.register_buffer("aabb", torch.as_tensor(aabb, dtype=torch.float32), persistent=False)
        self.num_images = num_images
        self.geo_feat_dim = geo_feat_dim
        self.appearance_embedding_dim = appearance_embedding_dim
        self.use_appearance_embedding = use_appearance_embedding
        self.use_average_appearance_embedding = use_average_appearance_embedding
        self.bias_init = bias
        self.geometric_init = geometric_init
        self.inside_outside = inside_outside
        self.use_grid_feature = use_grid_feature
        self.position_encoding = NeRFEncoding(in_dim=3, num_frequencies=6, min_freq_exp=0.0, max_freq_exp=5.0,
                                              include_input=False)
        self.direction_encoding = NeRFEncoding(in_dim=3, num_frequencies=4, min_freq_exp=0.0, max_freq_exp=3.0,
                                               include_input=True)
        self.grid_dim = num_levels * features_per_level
        if use_grid_feature:
            self.grid_encoding = HashEncoding(num_levels=num_levels, min_res=base_res, max_res=max_res,
                                              log2_hashmap_size=log2_hashmap_size,
                                              features_per_level=features_per_level)
        self.geo_in_dim = in_dim = 3 + self.position_encoding.out_dim + self.grid_dim
        dims = [in_dim] + [hidden_dim] * num_layers + [1 + geo_feat_dim]
        layers = []
        for layer in range(len(dims) - 1):
            out_dim = dims[layer + 1]
            if layer + 1 in SKIP_IN:
                out_dim = dims[layer + 1] - in_dim
                if out_dim <= 0:
                    raise ValueError(f"hidden_dim ({hidden_dim}) must exceed the geo input width ({in_dim}) "
                                     "for the skip connection")
            # the skip layer's input, [h, inputs], is dims[layer] wide again
            layers.append(WNDense(dims[layer], out_dim, weight_norm))
        self.geo_layers = nn.ModuleList(layers)
        cdims = ([3 + self.direction_encoding.out_dim + 3 + geo_feat_dim + appearance_embedding_dim]
                 + [hidden_dim_color] * num_layers_color + [3])
        self.color_layers = nn.ModuleList(WNDense(cdims[i], cdims[i + 1], weight_norm)
                                          for i in range(len(cdims) - 1))
        self.embedding_appearance = nn.Parameter(torch.empty(num_images, appearance_embedding_dim))
        self.beta_init = beta_init
        self.variance = nn.Parameter(torch.tensor(float(beta_init)))  # NeuS's learned variance

    # the geometric (sphere) initialisation -----------------------------

    def geometric_kernel(self, layer: int, shape, generator: torch.Generator) -> torch.Tensor:
        """The JAX module's geometric init of geo layer `layer`'s kernel
        [fan_in, fan_out]: the last layer sqrt(pi / fan_in) (negated when
        inside_outside) + 1e-4 N(0, 1); the others sqrt(2 / fan_out) N(0,
        1), with layer 0's rows past x zeroed and the skip layer's rows of
        the re-entering input past x zeroed."""
        fan_in, fan_out = shape
        noise = torch.randn(shape, generator=generator)
        if layer == len(self.geo_layers) - 1:
            mean = math.sqrt(math.pi) / math.sqrt(fan_in)
            return (-mean if self.inside_outside else mean) + 1e-4 * noise
        w = math.sqrt(2) / math.sqrt(fan_out) * noise
        if layer == 0:
            w[3:, :] = 0.0
        elif layer in SKIP_IN:
            w[-(self.geo_in_dim - 3):, :] = 0.0
        return w

    def reset_parameters(self, generator: torch.Generator) -> None:
        last = len(self.geo_layers) - 1
        for layer, lin in enumerate(self.geo_layers):
            if not self.geometric_init:
                lin.reset_parameters(generator)
                continue
            kernel = self.geometric_kernel(layer, tuple(lin.kernel.shape), generator)
            b = (self.bias_init if self.inside_outside else -self.bias_init) if layer == last else 0.0
            lin.reset_parameters(generator, kernel=kernel, bias=b)
        for lin in self.color_layers:
            lin.reset_parameters(generator)
        with torch.no_grad():
            nn.init.normal_(self.embedding_appearance, 0.0, 1.0, generator=generator)
            self.variance.fill_(self.beta_init)
        if self.use_grid_feature:
            self.grid_encoding.reset_parameters(generator)

    # geometry ----------------------------------------------------------

    def get_inv_s(self) -> torch.Tensor:
        """The learned variance's inverse deviation, min(exp(10 variance), 1e6)."""
        return torch.clamp(torch.exp(self.variance * 10.0), max=1e6)

    def forward_geonetwork(self, positions: torch.Tensor) -> torch.Tensor:
        """[N, 3] world positions -> [N, 1 + geo_feat_dim]."""
        pe = self.position_encoding(positions)
        if self.use_grid_feature:
            warped = (SceneContraction(order=math.inf)(positions) + 2.0) / 4.0
            feat = self.grid_encoding(warped)
        else:
            feat = positions.new_zeros((*positions.shape[:-1], self.grid_dim))
        h = inputs = torch.cat([positions, pe, feat], dim=-1)
        n = len(self.geo_layers)
        for layer, lin in enumerate(self.geo_layers):
            if layer in SKIP_IN:
                h = torch.cat([h, inputs], dim=-1) / math.sqrt(2.0)
            h = lin(h)
            if layer < n - 1:
                h = softplus_b100(h)
        return h

    def get_sdf_at(self, positions: torch.Tensor) -> torch.Tensor:
        """The SDF [..., 1] at world positions [..., 3]."""
        out = self.forward_geonetwork(positions.reshape(-1, 3))
        return out[:, :1].reshape(*positions.shape[:-1], 1)

    @staticmethod
    def start_positions(ray_samples: RaySamples) -> torch.Tensor:
        return ray_samples.origins[..., None, :] + ray_samples.directions[..., None, :] * ray_samples.starts

    def get_sdf(self, ray_samples: RaySamples) -> torch.Tensor:
        """The SDF at the frustum starts, [..., S, 1]."""
        return self.get_sdf_at(self.start_positions(ray_samples))

    def get_sdf_and_gradient(self, positions: torch.Tensor, train: bool = True):
        """(sdf [..., 1], geo features, gradient [..., 3]) at world
        positions: the gradient of the summed SDF, which is each point's
        own (every point's SDF depends on it alone). In training it keeps
        its graph (create_graph) for the eikonal loss; otherwise all three
        come back detached."""
        shape = positions.shape[:-1]
        with torch.enable_grad():
            x = positions.reshape(-1, 3).detach().requires_grad_(True)
            out = self.forward_geonetwork(x)
            sdf = out[:, :1]
            (grad,) = torch.autograd.grad(sdf, x, grad_outputs=torch.ones_like(sdf), create_graph=train)
        geo = out[:, 1:]
        if not train:
            sdf, geo = sdf.detach(), geo.detach()
        return sdf.reshape(*shape, 1), geo.reshape(*shape, -1), grad.reshape(*shape, 3)

    def get_alpha(self, ray_samples: RaySamples, sdf: torch.Tensor, gradients: torch.Tensor,
                  cos_anneal_ratio: float = 1.0) -> torch.Tensor:
        """NeuS's alpha from the SDF at the frustum starts and its
        directional derivative, [..., S, 1]."""
        inv_s = self.get_inv_s()
        true_cos = torch.sum(ray_samples.directions[..., None, :] * gradients, dim=-1, keepdim=True)
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)
        deltas = ray_samples.deltas
        est_next = sdf + iter_cos * deltas * 0.5
        est_prev = sdf - iter_cos * deltas * 0.5
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        return torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)

    # colour ------------------------------------------------------------

    def get_colors(self, points, directions, normals, geo_feat, camera_indices, train: bool) -> torch.Tensor:
        """RGB [..., 3] from [x, direction encoding, normals (the SDF
        gradient), geo features, appearance]: the camera's embedding in
        training when use_appearance_embedding, else the table's mean
        outside training when use_average_appearance_embedding, else
        zeros."""
        d = self.direction_encoding(directions)
        shape = points.shape[:-1]
        table = self.embedding_appearance
        if train and self.use_appearance_embedding:
            emb = table[camera_indices.long()]
        elif not train and self.use_average_appearance_embedding:
            emb = table.mean(dim=0).expand(*shape, self.appearance_embedding_dim)
        else:
            emb = table.new_zeros((*shape, self.appearance_embedding_dim))
        h = torch.cat([points, d, normals, geo_feat, emb], dim=-1)
        n = len(self.color_layers)
        for i, lin in enumerate(self.color_layers):
            h = lin(h)
            if i < n - 1:
                h = torch.relu(h)
        return torch.sigmoid(h)

    def forward(self, ray_samples: RaySamples, train: bool = True, return_alphas: bool = False,
                cos_anneal_ratio: float = 1.0) -> Dict[FieldHeadNames, torch.Tensor]:
        pos = self.start_positions(ray_samples)
        sdf, geo_feat, gradients = self.get_sdf_and_gradient(pos, train=train)
        dirs = ray_samples.directions[..., None, :].expand(pos.shape)
        cam_idx = ray_samples.camera_indices[..., None, :].expand(*pos.shape[:-1], 1)[..., 0]
        rgb = self.get_colors(pos, dirs, gradients, geo_feat, cam_idx, train)
        normals = gradients / torch.clamp(torch.linalg.vector_norm(gradients, dim=-1, keepdim=True), min=1e-12)
        outputs = {
            FieldHeadNames.RGB: rgb,
            FieldHeadNames.SDF: sdf,
            FieldHeadNames.NORMALS: normals,
            FieldHeadNames.GRADIENT: gradients,
        }
        if return_alphas:
            outputs[FieldHeadNames.ALPHA] = self.get_alpha(ray_samples, sdf, gradients, cos_anneal_ratio)
        return outputs
