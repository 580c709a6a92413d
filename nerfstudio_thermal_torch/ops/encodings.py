"""Input encodings (counterpart of nerfstudio_thermal_tpu/ops/encodings.py).

The sinusoidal `NeRFEncoding`, the Fourier-feature `FFEncoding` over a
basis (random: `make_rff_encoding`; MipNeRF-360's polyhedron:
`make_polyhedron_ff_encoding`), the spherical-harmonic `SHEncoding` and
the multiresolution hash grid: `HashEncoding`, with the plain PyTorch versions
of the hash-grid function, of its two gradients and of the position
gradient's VJP (the SDF fields' second derivative). Those plain versions
are the CPU path and the yardstick of the CUDA kernels
(ops/cuda/hash_encoding.py); `HashEncoding` goes through that module's
autograd node, which picks the plain versions for CPU tensors and the
kernels for CUDA tensors.

`NeRFEncoding` (with `covs`, MipNeRF's integrated encoding) keeps the JAX
module's arithmetic, which differs from the
in-kernel encoding of the fused MLP (ops/cuda/fused_mlp.py): here the input
is scaled by 2*pi, then by 2^e, and the cosine is sin(x + pi/2).

The hash grid keeps the JAX function's semantics: per dimension
scaled = pos * scaling in f32; the corners are floor(scaled) and
ceil(scaled) (one row twice, with weights 1 and 0, at an integer
coordinate); the Instant-NGP hash (int32 -> uint32) * prime, XORed and
masked to T - 1, is computed in int64 on operands masked to the table's
bits, which gives the same low bits as the uint32 arithmetic; the 8 corners
in `_CORNER_BITS` order; the trilerp in f32, cast to the compute dtype last;
output [..., L * F], level-major. Factors are kept in JAX's [L, N] layout,
so no [N, L, 8, 3] buffer is built.
"""

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.utils.math import expected_sin, generate_polyhedron_basis

# Instant-NGP spatial-hash primes.
_HASH_PRIMES = (1, 2654435761, 805459861)

# The 8 trilinear-interpolation corners; bit 1 selects ceil, bit 0 floor.
_CORNER_BITS = [((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8)]  # (x, y, z)


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

    def __call__(self, in_tensor: torch.Tensor, covs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """covs: optional [..., in_dim] gaussian variances, which make this
        MipNeRF's integrated positional encoding: each sin is damped by
        exp(-var / 2), var = covs * 2^(2e) (the variance does not carry
        the mean's 2*pi, as in the JAX package)."""
        scaled = (2.0 * math.pi) * in_tensor
        exps = torch.linspace(
            self.min_freq_exp, self.max_freq_exp, self.num_frequencies,
            dtype=torch.float32, device=in_tensor.device,
        )
        freqs = torch.pow(2.0, exps)
        scaled = (scaled[..., None] * freqs).reshape(*scaled.shape[:-1], -1)
        both = torch.cat([scaled, scaled + math.pi / 2.0], dim=-1)
        if covs is None:
            encoded = torch.sin(both)
        else:
            input_var = (covs[..., :, None] * freqs**2).reshape(*covs.shape[:-1], -1)
            encoded = expected_sin(both, torch.cat([input_var, input_var], dim=-1))
        if self.include_input:
            encoded = torch.cat([encoded, in_tensor], dim=-1)
        return encoded



class FFEncoding:
    """Fourier-feature encoding over a basis matrix [in_dim, M]: the input
    scaled by 2*pi, projected through the basis, multiplied by 2^linspace
    frequencies, then sin of the value and of its pi/2 shift. With `covs`
    ([..., in_dim, in_dim] covariances) it is the integrated encoding:
    each sin is damped by exp(-var / 2), var = diag(B^T covs B) * freq^2.
    Output [..., M * num_frequencies * 2 (+ in_dim if include_input)]."""

    def __init__(
        self,
        basis,
        num_frequencies: int = 1,
        min_freq_exp: float = 0.0,
        max_freq_exp: float = 0.0,
        include_input: bool = False,
    ) -> None:
        self.basis = np.asarray(basis, np.float32)
        self.num_frequencies = num_frequencies
        self.min_freq_exp = min_freq_exp
        self.max_freq_exp = max_freq_exp
        self.include_input = include_input

    @property
    def in_dim(self) -> int:
        return self.basis.shape[0]

    @property
    def out_dim(self) -> int:
        d = self.basis.shape[1] * self.num_frequencies * 2
        return d + self.in_dim if self.include_input else d

    def __call__(self, in_tensor: torch.Tensor, covs: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = torch.as_tensor(self.basis, device=in_tensor.device)
        scaled = ((2.0 * math.pi) * in_tensor) @ b  # [..., M]
        exps = torch.linspace(
            self.min_freq_exp, self.max_freq_exp, self.num_frequencies,
            dtype=torch.float32, device=in_tensor.device,
        )
        freqs = torch.pow(2.0, exps)
        scaled = (scaled[..., None] * freqs).reshape(*scaled.shape[:-1], -1)
        both = torch.cat([scaled, scaled + math.pi / 2.0], dim=-1)
        if covs is None:
            encoded = torch.sin(both)
        else:
            input_var = torch.sum((covs @ b) * b, dim=-2)  # [..., M]
            input_var = (input_var[..., None] * freqs**2).reshape(*input_var.shape[:-1], -1)
            encoded = expected_sin(both, torch.cat([input_var, input_var], dim=-1))
        if self.include_input:
            encoded = torch.cat([encoded, in_tensor], dim=-1)
        return encoded


def make_rff_encoding(
    in_dim: int, num_frequencies: int, scale: float, include_input: bool = False, seed: int = 0
) -> FFEncoding:
    """Random Fourier features: a gaussian basis N(0, scale^2) of
    [in_dim, num_frequencies] from `np.random.default_rng(seed)` (the JAX
    package's draw, so both build the same basis), one frequency."""
    if scale <= 0:
        raise ValueError("RFF encoding scale must be > 0")
    b = np.random.default_rng(seed).normal(0.0, scale, (in_dim, num_frequencies))
    return FFEncoding(basis=b.astype(np.float32), num_frequencies=1, include_input=include_input)


def make_polyhedron_ff_encoding(
    num_frequencies: int,
    min_freq_exp: float,
    max_freq_exp: float,
    basis_shape: str = "octahedron",
    basis_subdivisions: int = 1,
    include_input: bool = False,
) -> FFEncoding:
    """MipNeRF-360's polyhedron Fourier features: the basis is
    `generate_polyhedron_basis(basis_shape, basis_subdivisions)^T`."""
    basis = generate_polyhedron_basis(basis_shape, basis_subdivisions).T
    return FFEncoding(
        basis=basis,
        num_frequencies=num_frequencies,
        min_freq_exp=min_freq_exp,
        max_freq_exp=max_freq_exp,
        include_input=include_input,
    )

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


def hash_grid_scalings(num_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """Per-level grid resolutions floor(min_res * growth^level) as f32, with
    growth = exp((ln max - ln min) / (L - 1))."""
    if num_levels > 1:
        growth = math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1))
    else:
        growth = 1.0
    return np.floor(min_res * growth ** np.arange(num_levels)).astype(np.float32)


def _hash_dim(coord: torch.Tensor, d: int, mask: int) -> torch.Tensor:
    """The low bits (mask) of uint32(int32(coord)) * prime_d, in int64: the
    operands are masked first, so the product cannot overflow."""
    return ((coord.to(torch.int64) & mask) * (_HASH_PRIMES[d] & mask)) & mask


def spatial_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Instant-NGP spatial hash of integer grid coords [..., 3] -> int64
    [...] in [0, table_size); table_size is a power of 2."""
    mask = table_size - 1
    return _hash_dim(coords[..., 0], 0, mask) ^ _hash_dim(coords[..., 1], 1, mask) ^ _hash_dim(coords[..., 2], 2, mask)


def _hash_factors(positions: torch.Tensor, scalings: torch.Tensor, table_size: int):
    """Per-dimension hashed floor/ceil coords and trilerp weights, [L, N]
    each, from positions [N, 3] and scalings [L]."""
    mask = table_size - 1
    hf, hc, wf, wc = [], [], [], []
    for d in range(3):
        scaled = positions[:, d][None, :].float() * scalings[:, None].float()  # [L, N]
        floor = torch.floor(scaled)
        offset = scaled - floor
        hf.append(_hash_dim(floor, d, mask))
        hc.append(_hash_dim(torch.ceil(scaled), d, mask))
        wf.append(1.0 - offset)
        wc.append(offset)
    return hf, hc, wf, wc


def _corner_index(hf, hc, bits, level_offset: torch.Tensor) -> torch.Tensor:
    h = (hc[0] if bits[0] else hf[0]) ^ (hc[1] if bits[1] else hf[1]) ^ (hc[2] if bits[2] else hf[2])
    return h + level_offset


def _corner_weights(wf, wc, bits) -> List[torch.Tensor]:
    return [wc[d] if bits[d] else wf[d] for d in range(3)]


def _level_offset(num_levels: int, table_size: int, device) -> torch.Tensor:
    return (torch.arange(num_levels, dtype=torch.int64, device=device) * table_size)[:, None]


def hash_encode_plain(
    table: torch.Tensor,  # [L * T, F]
    positions: torch.Tensor,  # [..., 3] in [0, 1]
    scalings: torch.Tensor,  # [L]
    table_size: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the hash-grid encoding: [..., L * F]
    trilinearly interpolated features, summed over the corners in f32 and
    cast to the compute dtype last."""
    num_levels, f = scalings.shape[0], table.shape[-1]
    batch_shape = positions.shape[:-1]
    hf, hc, wf, wc = _hash_factors(positions.reshape(-1, 3), scalings, table_size)
    level_offset = _level_offset(num_levels, table_size, positions.device)
    cols = [table[:, fc].float() for fc in range(f)]
    out: List[torch.Tensor] = [None] * f
    for bits in _CORNER_BITS:
        idx = _corner_index(hf, hc, bits, level_offset)
        wx, wy, wz = _corner_weights(wf, wc, bits)
        w = wx * wy * wz
        for fc in range(f):
            contrib = cols[fc][idx] * w
            out[fc] = contrib if out[fc] is None else out[fc] + contrib
    out = torch.stack(out, dim=-1).transpose(0, 1).to(compute_dtype)  # [N, L, F]
    return out.reshape(*batch_shape, num_levels * f)


def _grad_cols(g: torch.Tensor, n: int, num_levels: int, f: int) -> List[torch.Tensor]:
    """g [..., L * F] -> per feature [L, N] f32."""
    g = g.reshape(n, num_levels, f).float()
    return [g[:, :, fc].t() for fc in range(f)]


def hash_encode_bwd_table_plain(
    positions: torch.Tensor, g: torch.Tensor, scalings: torch.Tensor, table_size: int, features: int
) -> torch.Tensor:
    """Plain version of the table gradient: g * w of every corner
    scatter-added (f32) into its row. Returns d_table [L * T, F] f32."""
    num_levels = scalings.shape[0]
    pos = positions.reshape(-1, 3)
    g_cols = _grad_cols(g, pos.shape[0], num_levels, features)
    hf, hc, wf, wc = _hash_factors(pos, scalings, table_size)
    level_offset = _level_offset(num_levels, table_size, pos.device)
    d_cols = [torch.zeros(num_levels * table_size, dtype=torch.float32, device=pos.device) for _ in range(features)]
    for bits in _CORNER_BITS:
        idx = _corner_index(hf, hc, bits, level_offset).reshape(-1)
        wx, wy, wz = _corner_weights(wf, wc, bits)
        w = wx * wy * wz
        for fc in range(features):
            d_cols[fc].index_add_(0, idx, (g_cols[fc] * w).reshape(-1))
    return torch.stack(d_cols, dim=-1)


def hash_encode_bwd_pos_plain(
    table: torch.Tensor, positions: torch.Tensor, g: torch.Tensor, scalings: torch.Tensor, table_size: int
) -> torch.Tensor:
    """Plain version of the position gradient: per level and corner,
    (g . row) times +-1 times the other two weights, summed over corners,
    scaled by the level's resolution and summed over levels (offset =
    pos * scaling - floor). Returns f32 of positions' shape."""
    num_levels, f = scalings.shape[0], table.shape[-1]
    pos = positions.reshape(-1, 3)
    g_cols = _grad_cols(g, pos.shape[0], num_levels, f)
    hf, hc, wf, wc = _hash_factors(pos, scalings, table_size)
    level_offset = _level_offset(num_levels, table_size, pos.device)
    cols = [table[:, fc].float() for fc in range(f)]
    d_off = [torch.zeros_like(wf[0]) for _ in range(3)]
    for bits in _CORNER_BITS:
        idx = _corner_index(hf, hc, bits, level_offset)
        g_dot_feat = torch.zeros_like(wf[0])
        for fc in range(f):
            g_dot_feat = g_dot_feat + g_cols[fc] * cols[fc][idx]
        wx, wy, wz = _corner_weights(wf, wc, bits)
        signs = [1.0 if b else -1.0 for b in bits]
        d_off[0] = d_off[0] + g_dot_feat * signs[0] * wy * wz
        d_off[1] = d_off[1] + g_dot_feat * signs[1] * wx * wz
        d_off[2] = d_off[2] + g_dot_feat * signs[2] * wx * wy
    scal = scalings[:, None].float()
    d_pos = torch.stack([(d_off[d] * scal).sum(dim=0) for d in range(3)], dim=-1)
    return d_pos.reshape(positions.shape)


def hash_encode_bwd_pos_vjp_plain(
    table: torch.Tensor,
    positions: torch.Tensor,
    g: torch.Tensor,
    v: torch.Tensor,
    scalings: torch.Tensor,
    table_size: int,
    need_g: bool = True,
    need_table: bool = True,
    need_pos: bool = True,
):
    """Plain version of the position gradient's VJP: the gradients of
    <v, hash_encode_bwd_pos_plain(table, positions, g, ...)> for the
    cotangent v [N, 3], written out (no autograd). Per point, level (scaling
    s) and corner c, with w_{c,d} its trilinear factors, sg_{c,d} = +1 on a
    ceil bit and -1 on a floor bit, and row_c its table row:
        a_c = s * sum_d v_d sg_{c,d} prod_{e != d} w_{c,e}
        dg[l, f] = sum_c a_c row_c[f]
        d_table[row_c, f] += g[l, f] a_c
        d_pos2_k += s^2 sum_c (g . row_c) sg_{c,k}
                    sum_{d != k} v_d sg_{c,d} prod_{e not in {d, k}} w_{c,e}
    (the corner rows do not depend on the positions: floor is piecewise
    constant). Sums in corner order, then d_pos2 over the levels. Returns
    (dg [..., L * F], d_table [L * T, F], d_pos2 [..., 3]), all f32, None
    for each output not asked for."""
    num_levels, f = scalings.shape[0], table.shape[-1]
    pos = positions.reshape(-1, 3)
    n = pos.shape[0]
    g_cols = _grad_cols(g, n, num_levels, f)
    vx, vy, vz = (v.reshape(n, 3)[:, d].float()[None, :] for d in range(3))
    hf, hc, wf, wc = _hash_factors(pos, scalings, table_size)
    level_offset = _level_offset(num_levels, table_size, pos.device)
    cols = [table[:, fc].float() for fc in range(f)]
    scal = scalings[:, None].float()
    zeros = torch.zeros_like(wf[0])
    dg_cols = [zeros] * f
    d_cols = [torch.zeros(num_levels * table_size, dtype=torch.float32, device=pos.device) for _ in range(f)]
    dp = [zeros] * 3
    for bits in _CORNER_BITS:
        idx = _corner_index(hf, hc, bits, level_offset)
        wx, wy, wz = _corner_weights(wf, wc, bits)
        sx, sy, sz = (1.0 if b else -1.0 for b in bits)
        ux, uy, uz = vx * sx, vy * sy, vz * sz
        a = scal * (ux * wy * wz + uy * wx * wz + uz * wx * wy)
        rows = [cols[fc][idx] for fc in range(f)] if need_g or need_pos else None
        if need_g:
            dg_cols = [dg_cols[fc] + a * rows[fc] for fc in range(f)]
        if need_table:
            for fc in range(f):
                d_cols[fc].index_add_(0, idx.reshape(-1), (g_cols[fc] * a).reshape(-1))
        if need_pos:
            gdf = zeros
            for fc in range(f):
                gdf = gdf + g_cols[fc] * rows[fc]
            dp[0] = dp[0] + gdf * sx * (uy * wz + uz * wy)
            dp[1] = dp[1] + gdf * sy * (ux * wz + uz * wx)
            dp[2] = dp[2] + gdf * sz * (ux * wy + uy * wx)
    dg = d_table = d_pos2 = None
    if need_g:
        dg = torch.stack(dg_cols, dim=-1).transpose(0, 1).reshape(*positions.shape[:-1], num_levels * f)
    if need_table:
        d_table = torch.stack(d_cols, dim=-1)
    if need_pos:
        d_pos2 = torch.stack([(dp[d] * scal * scal).sum(dim=0) for d in range(3)], dim=-1).reshape(positions.shape)
    return dg, d_table, d_pos2


class HashEncoding(nn.Module):
    """Instant-NGP multiresolution hash-grid encoding: a `hash_table`
    parameter [L * T, F] in f32, initialised U(-hash_init_scale,
    hash_init_scale), and per-level resolutions.

    On CUDA tensors it runs the hand-written kernels for every table size.
    The JAX module's `use_pallas` picks between two Pallas routes of the
    same function (a one-hot matmul for small tables, a row gather with an
    MXU scatter for large ones); on this card one set of gather and scatter
    kernels serves both, so the module takes no such flag."""

    def __init__(
        self,
        num_levels: int = 16,
        min_res: int = 16,
        max_res: int = 1024,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        hash_init_scale: float = 1e-3,
        compute_dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.num_levels = num_levels
        self.log2_hashmap_size = log2_hashmap_size
        self.features_per_level = features_per_level
        self.hash_init_scale = hash_init_scale
        self.compute_dtype = compute_dtype
        self.hash_table = nn.Parameter(torch.zeros(self.table_size * num_levels, features_per_level))
        scalings = torch.from_numpy(hash_grid_scalings(num_levels, min_res, max_res))
        self.register_buffer("scalings", scalings, persistent=False)

    @property
    def table_size(self) -> int:
        return 2**self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            u = torch.rand(self.hash_table.shape, generator=generator)
            self.hash_table.copy_(self.hash_init_scale * (2.0 * u - 1.0))

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        # the kernels' module imports this one for the plain versions
        from nerfstudio_thermal_torch.ops.cuda.hash_encoding import hash_encode

        return hash_encode(self.hash_table, positions, self.scalings, self.table_size, self.compute_dtype)
