"""Fused ray-march and whole-field MLPs: hand-written Hopper kernels, their
plain PyTorch versions and their autograd nodes.

Counterpart of nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:
`fused_ray_mlp` (TPU kernels `_ray_fwd_kernel`, `_ray_bwd_kernel`) and
`fused_field_mlp` (`_field_fwd_kernel`, `_field_bwd_kernel`). The CUDA
sources are nerfstudio_thermal_torch/csrc/fused_ray_fwd.cu and
fused_ray_bwd.cu (with fused_ray_common.cuh); their headers say what bounds
each kernel and what the first design gives up. Layouts are JAX's at the
public functions: origins, dirs [R, 3], ts [R * S, 1], emb [R, E]; the ray
output [R * S, out + 1] holds the MLP output and the in-box selector last,
the field output [R * S, C + 2] the colour, the raw density and the
selector, both in the compute dtype.

`fused_ray_mlp` and `fused_field_mlp` are each one autograd node that
dispatches on the device of the origins: CPU tensors run the plain
versions in both directions; CUDA tensors launch the kernels (built with
nvcc at first use, ops/cuda/build.py) or raise. The ray node skips the
whole input-gradient chain (layer 0's dX product, encoding backward,
contraction VJP, per-ray sums) when (o, d, t) need no gradient or `input_grads` is False, as the
TPU kernel's `need_input_grads=False` does.

Numerics (both versions, the TPU kernels' rounding points): pos = o + t d
(one product, one sum; the kernels use IEEE-rounded intrinsics so that no
FMA forms); the contraction and selector in f32 (`contract`); the MLPs as
ops/cuda/fused_mlp.py computes them. The whole field rounds SH(dir) and the
embedding rows to the compute dtype before the head; its backward rounds g
to the compute dtype, keeps the head's input gradient in f32 and rounds
g_base = [g_raw, d_geo] to the compute dtype before the base walk.
"""

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from nerfstudio_thermal_torch.ops.cuda import build
from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
from nerfstudio_thermal_torch.ops.encodings import sh_encoding

FreqEncoding = fm.FreqEncoding

# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


@dataclass
class Contracted:
    """One block of samples through posgen and the contraction."""

    pos: torch.Tensor  # [N, 3] o + t d
    d_rep: torch.Tensor  # [N, 3] each sample's ray direction
    x: torch.Tensor  # [N, 3] p01 * sel, the encoding's input
    sel: torch.Tensor  # [N, 1] 0/1 in-box selector
    mag: torch.Tensor  # [N, 1] inf-norm of pos
    safe: torch.Tensor  # [N, 1] max(mag, 1e-12)


def posgen(origins: torch.Tensor, dirs: torch.Tensor, ts: torch.Tensor, num_samples: int):
    """TPU `_posgen_fwd`: (pos = o + t d [R S, 3], d per sample [R S, 3])."""
    o_rep = origins.float().repeat_interleave(num_samples, dim=0)
    d_rep = dirs.float().repeat_interleave(num_samples, dim=0)
    return o_rep + ts.float() * d_rep, d_rep


def contract(origins: torch.Tensor, dirs: torch.Tensor, ts: torch.Tensor, num_samples: int) -> Contracted:
    """TPU `_contract_fwd` on the sample positions: the inf-norm scene
    contraction, (x + 2) / 4 and the in-(0, 1)^3 selector."""
    pos, d_rep = posgen(origins, dirs, ts, num_samples)
    mag = torch.amax(torch.abs(pos), dim=-1, keepdim=True)
    safe = torch.clamp(mag, min=1e-12)
    contracted = (2.0 - 1.0 / safe) * (pos / safe)
    cpos = torch.where(mag < 1.0, pos, contracted)
    p01 = (cpos + 2.0) * 0.25
    sel = torch.all((p01 > 0.0) & (p01 < 1.0), dim=-1, keepdim=True).float()
    return Contracted(pos, d_rep, p01 * sel, sel, mag, safe)


def contract_bwd(dx: torch.Tensor, c: Contracted) -> torch.Tensor:
    """TPU `_contract_bwd`: the VJP of x with respect to pos, written out
    (every component tied at the inf-norm gets the max's gradient, which
    autograd through `amax` would not give; the selector has none)."""
    g = dx * c.sel * 0.25
    m = c.safe
    gdotx = (g * c.pos).sum(dim=-1, keepdim=True)
    s = torch.sign(c.pos) * (torch.abs(c.pos) >= c.mag).float()
    d_contracted = g * (2.0 / m - 1.0 / (m * m)) + gdotx * (2.0 / (m * m * m) - 2.0 / (m * m)) * s
    return torch.where(c.mag < 1.0, g, d_contracted)


def ray_sums(v: torch.Tensor, num_samples: int) -> torch.Tensor:
    """[R S, K] -> [R, K]: each ray's samples summed."""
    return v.reshape(-1, num_samples, v.shape[-1]).sum(dim=1)


_SH = dict(c1=0.4886025119029199, c4=1.0925484305920792, c6=0.9461746957575601,
           c8=0.5462742152960396, c9=0.5900435899266435, c10=2.890611442640554,
           c11=0.4570457994644658, c12=0.3731763325901154, c14=1.445305721320277)


def sh4_vjp(dirs: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """VJP of degree-4 SH (TPU `_sh4_2d`, ops/encodings.py sh_encoding):
    dirs [R, 3], g [R, 16] -> [R, 3] f32. Each partial is written out as a
    product chain and the terms summed in component order, the same
    operations as fused_ray_common.cuh sh4_vjp."""
    k = _SH
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    zz5m1 = zz * 5.0 - 1.0
    zz15m3 = zz * 15.0 - 3.0
    xx3yy3 = xx * 3.0 - yy * 3.0
    xxyy = xx - yy
    g = g.float()
    dx = (g[:, 3] * k["c1"] + g[:, 4] * (k["c4"] * y) + g[:, 7] * (k["c4"] * z)
          + g[:, 8] * ((k["c8"] * x) * 2.0) + g[:, 9] * (((k["c9"] * x) * y) * 6.0)
          + g[:, 10] * ((k["c10"] * y) * z) + g[:, 13] * (k["c11"] * zz5m1)
          + g[:, 14] * (((k["c14"] * x) * z) * 2.0) + g[:, 15] * (k["c9"] * xx3yy3))
    dy = (g[:, 1] * k["c1"] + g[:, 4] * (k["c4"] * x) + g[:, 5] * (k["c4"] * z)
          + g[:, 8] * ((k["c8"] * y) * -2.0) + g[:, 9] * (k["c9"] * xx3yy3)
          + g[:, 10] * ((k["c10"] * x) * z) + g[:, 11] * (k["c11"] * zz5m1)
          + g[:, 14] * (((k["c14"] * y) * z) * -2.0) + g[:, 15] * (((k["c9"] * x) * y) * -6.0))
    dz = (g[:, 2] * k["c1"] + g[:, 5] * (k["c4"] * y) + g[:, 6] * ((k["c6"] * z) * 2.0)
          + g[:, 7] * (k["c4"] * x) + g[:, 10] * ((k["c10"] * x) * y)
          + g[:, 11] * (((k["c11"] * y) * z) * 10.0) + g[:, 12] * (k["c12"] * zz15m3)
          + g[:, 13] * (((k["c11"] * x) * z) * 10.0) + g[:, 14] * (k["c14"] * xxyy))
    return torch.stack([dx, dy, dz], dim=-1)


def fused_ray_mlp_plain(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    ts: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    num_samples: int,
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    freq_encoding: FreqEncoding = (10, 0.0, 9.0, True),
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of the ray forward: [R S, out + 1] in the compute
    dtype, the selector last."""
    c = contract(origins, dirs, ts, num_samples)
    h = fm.fused_mlp_plain(c.x, weights, biases, "relu", out_activation, skip_connections,
                           freq_encoding, compute_dtype)
    return torch.cat([h, c.sel.to(compute_dtype)], dim=-1)


def fused_ray_mlp_bwd_plain(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    ts: torch.Tensor,
    g: torch.Tensor,  # [R S, out + 1] (the selector lane is not read)
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    num_samples: int,
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    freq_encoding: FreqEncoding = (10, 0.0, 9.0, True),
    compute_dtype: torch.dtype = torch.bfloat16,
    need_input_grads: bool = True,
):
    """Plain version of the ray backward (TPU `_ray_bwd_kernel`): (d_o, d_d,
    d_t or three Nones without need_input_grads, [dW] f32, [db] f32)."""
    out_dim = weights[-1].shape[1]
    with torch.no_grad():
        c = contract(origins, dirs, ts, num_samples)
        dx, dws, dbs = fm.fused_mlp_bwd_plain(c.x, g[:, :out_dim], weights, biases, "relu", out_activation,
                                              skip_connections, freq_encoding, compute_dtype)
        if not need_input_grads:
            return None, None, None, dws, dbs
        d_pos = contract_bwd(dx, c)
        d_t = (d_pos * c.d_rep).sum(dim=-1, keepdim=True)
        return ray_sums(d_pos, num_samples), ray_sums(d_pos * ts.float(), num_samples), d_t, dws, dbs


def _head_input(dirs, emb, base_out, num_samples, compute_dtype):
    """[SH4(dir) | geo columns of the base output | emb], each rounded to
    the compute dtype, per sample."""
    sh = sh_encoding(dirs.float(), 4).to(compute_dtype).repeat_interleave(num_samples, dim=0)
    e = emb.float().to(compute_dtype).repeat_interleave(num_samples, dim=0)
    return torch.cat([sh, base_out[:, 1:], e], dim=-1)


def fused_field_mlp_plain(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    ts: torch.Tensor,
    emb: torch.Tensor,
    base_weights: Sequence[torch.Tensor],
    base_biases: Sequence[torch.Tensor],
    head_weights: Sequence[torch.Tensor],
    head_biases: Sequence[torch.Tensor],
    num_samples: int,
    skip_connections: Sequence[int] = (),
    freq_encoding: FreqEncoding = (10, 0.0, 9.0, True),
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of the whole-field forward: [R S, C + 2] (colour, raw
    density, selector) in the compute dtype."""
    c = contract(origins, dirs, ts, num_samples)
    base = fm.fused_mlp_plain(c.x, base_weights, base_biases, "relu", None, skip_connections,
                              freq_encoding, compute_dtype)
    head_in = _head_input(dirs, emb, base, num_samples, compute_dtype)
    rgb = fm.fused_mlp_plain(head_in, head_weights, head_biases, "relu", "sigmoid", (), None, compute_dtype)
    return torch.cat([rgb, base[:, :1], c.sel.to(compute_dtype)], dim=-1)


def fused_field_mlp_bwd_plain(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    ts: torch.Tensor,
    emb: torch.Tensor,
    g: torch.Tensor,  # [R S, C + 2]
    base_weights: Sequence[torch.Tensor],
    base_biases: Sequence[torch.Tensor],
    head_weights: Sequence[torch.Tensor],
    head_biases: Sequence[torch.Tensor],
    num_samples: int,
    skip_connections: Sequence[int] = (),
    freq_encoding: FreqEncoding = (10, 0.0, 9.0, True),
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """Plain version of the whole-field backward (TPU `_field_bwd_kernel`):
    (d_o, d_d, d_t, d_emb, [dW base], [db base], [dW head], [db head]), f32."""
    cdt = compute_dtype
    num_channels = head_weights[-1].shape[1]
    geo = base_weights[-1].shape[1] - 1
    with torch.no_grad():
        c = contract(origins, dirs, ts, num_samples)
        base = fm.fused_mlp_plain(c.x, base_weights, base_biases, "relu", None, skip_connections,
                                  freq_encoding, cdt)
        head_in = _head_input(dirs, emb, base, num_samples, cdt)
        g = g.to(cdt)
        d_head_in, dhw, dhb = fm.mlp_bwd_walk_plain(
            head_in, g[:, :num_channels], head_weights, head_biases, "relu", "sigmoid", (), cdt
        )
        g_base = torch.cat([g[:, num_channels : num_channels + 1].float(), d_head_in[:, 16 : 16 + geo]], dim=-1)
        dx, dbw, dbb = fm.fused_mlp_bwd_plain(c.x, g_base.to(cdt), base_weights, base_biases, "relu", None,
                                              skip_connections, freq_encoding, cdt)
        d_pos = contract_bwd(dx, c)
        d_t = (d_pos * c.d_rep).sum(dim=-1, keepdim=True)
        d_sh = ray_sums(d_head_in[:, :16], num_samples)
        d_d = ray_sums(d_pos * ts.float(), num_samples) + sh4_vjp(dirs.float(), d_sh)
        d_emb = ray_sums(d_head_in[:, 16 + geo :], num_samples)
        return ray_sums(d_pos, num_samples), d_d, d_t, d_emb, dbw, dbb, dhw, dhb


# --------------------------------------------------------------------------
# Load (ops/cuda/build.py compiles)
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(_I)


def _bind_fwd(lib: ctypes.CDLL) -> None:
    lib.fused_ray_fwd.argtypes = [_P] * 8 + [_I, _I, _IP, _I, _I, _I, _P]
    lib.fused_ray_fwd.restype = _I
    lib.fused_field_fwd.argtypes = [_P] * 13 + [_I, _I, _I, _IP, _I, _IP, _I, _I, _I, _P]
    lib.fused_field_fwd.restype = _I


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.fused_mlp_bwd_sizes.argtypes = [_IP, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_mlp_bwd_sizes.restype = _I
    lib.fused_ray_bwd.argtypes = [_P] * 18 + [_I, _I, _IP, _I, _I, _I, _I, _P]
    lib.fused_ray_bwd.restype = _I
    lib.fused_field_bwd.argtypes = [_P] * 29 + [_I, _I, _I, _IP, _I, _IP, _I, _I, _I, _P]
    lib.fused_field_bwd.restype = _I


def load_library(kind: str) -> ctypes.CDLL:
    """Build (at first use) and load the forward ("fwd") or backward
    ("bwd") library of the ray-march and whole-field kernels."""
    return build.load(f"fused_ray_{kind}", _bind_fwd if kind == "fwd" else _bind_bwd)


# --------------------------------------------------------------------------
# Kernel launches
# --------------------------------------------------------------------------


def _desc(packed: fm.Packed):
    return (ctypes.c_int * len(packed.desc))(*packed.desc), len(packed.desc)


def _bf16(dtype: torch.dtype) -> int:
    return int(dtype == torch.bfloat16)


def _check_rays(origins, dirs, ts, num_samples, emb=None) -> int:
    r = origins.shape[0]
    tensors = (origins, dirs, ts) + ((emb,) if emb is not None else ())
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused ray kernels: origins, dirs, ts (and emb) must be contiguous f32 CUDA tensors")
    if tuple(origins.shape) != (r, 3) or tuple(dirs.shape) != (r, 3) or ts.numel() != r * num_samples:
        raise ValueError(f"fused ray kernels: origins, dirs [R, 3] and ts [R * {num_samples}, 1] expected")
    if emb is not None and (emb.dim() != 2 or emb.shape[0] != r):
        raise ValueError("fused field kernel: emb must be [R, E]")
    return r


def launch_ray(origins, dirs, ts, num_samples: int, packed: fm.Packed) -> torch.Tensor:
    """One ray-march forward: -> [R S, out + 1] in the compute dtype."""
    r = _check_rays(origins, dirs, ts, num_samples)
    n = r * num_samples
    out = torch.empty(n, packed.out_dim + 1, dtype=packed.compute_dtype, device=origins.device)
    if n == 0:
        return out
    x = torch.empty(n, 3, dtype=torch.float32, device=origins.device)
    desc, desc_len = _desc(packed)
    err = load_library("fwd").fused_ray_fwd(
        origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), packed.weights.data_ptr(),
        packed.biases.data_ptr(), packed.freqs.data_ptr(), x.data_ptr(), out.data_ptr(),
        r, num_samples, desc, desc_len, _bf16(packed.compute_dtype), *build.device_and_stream(origins),
    )
    if err != 0:
        raise RuntimeError(f"fused_ray_fwd kernel launch failed: cudaError {err}")
    fused_ray_mlp.launches += 1
    return out


def launch_field(origins, dirs, ts, emb, num_samples: int, base: fm.Packed, head: fm.Packed):
    """One whole-field forward: -> (out [R S, C + 2] in the compute dtype,
    the head input [R S, 16 + geo + E] f32 the backward reads)."""
    r = _check_rays(origins, dirs, ts, num_samples, emb)
    n, dev, cdt = r * num_samples, origins.device, base.compute_dtype
    out = torch.empty(n, head.out_dim + 2, dtype=cdt, device=dev)
    head_in = torch.empty(n, head.desc[1], dtype=torch.float32, device=dev)
    if n == 0:
        return out, head_in
    x = torch.empty(n, 3, dtype=torch.float32, device=dev)
    base_out = torch.empty(n, base.out_dim, dtype=cdt, device=dev)
    (bd, bl), (hd, hl) = _desc(base), _desc(head)
    err = load_library("fwd").fused_field_fwd(
        origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), emb.data_ptr(), base.weights.data_ptr(),
        base.biases.data_ptr(), base.freqs.data_ptr(), head.weights.data_ptr(), head.biases.data_ptr(),
        x.data_ptr(), base_out.data_ptr(), head_in.data_ptr(), out.data_ptr(),
        r, num_samples, emb.shape[1], bd, bl, hd, hl, _bf16(cdt), *build.device_and_stream(origins),
    )
    if err != 0:
        raise RuntimeError(f"fused_field_fwd kernel launch failed: cudaError {err}")
    fused_field_mlp.launches += 1
    return out, head_in


def _bwd_buffers(lib, packs: Sequence[fm.Packed], n: int, like: torch.Tensor):
    """Workspace and scratch of the fused-MLP backward, for the larger of
    the stacks at n points."""
    ws_elems = scratch_floats = 0
    for p in packs:
        if p.weights_t is None:
            raise ValueError("fused ray backward kernels: pack the MLPs with transposed=True")
        desc, desc_len = _desc(p)
        sizes = (ctypes.c_longlong * 3)()
        err = lib.fused_mlp_bwd_sizes(desc, desc_len, n, _bf16(p.compute_dtype), build.device_and_stream(like)[0],
                                      sizes)
        if err != 0:
            raise RuntimeError(f"fused ray backward: the kernel refuses this MLP (cudaError {err})")
        if sizes[2] > fm.SMEM_LIMIT:
            raise ValueError("fused ray backward: widths exceed the backward kernel's shared memory")
        ws_elems, scratch_floats = max(ws_elems, sizes[0]), max(scratch_floats, sizes[1])
    return (torch.empty(ws_elems, dtype=packs[0].compute_dtype, device=like.device),
            torch.empty(scratch_floats, dtype=torch.float32, device=like.device))


def _f32(*shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(*shape, dtype=torch.float32, device=like.device)


def fused_ray_mlp_bwd(origins, dirs, ts, g, num_samples: int, packed: fm.Packed, need_input_grads: bool):
    """One ray-march backward launch: g [R S, out] in the compute dtype ->
    ((d_o, d_d, d_t), or three Nones without need_input_grads; dW padded
    [total_w] f32; db padded [total_b] f32). `fm.unpack_grads` gives the
    per-layer tensors."""
    r = _check_rays(origins, dirs, ts, num_samples)
    n = r * num_samples
    if tuple(g.shape) != (n, packed.out_dim) or g.dtype != packed.compute_dtype or not g.is_contiguous():
        raise ValueError("fused_ray_bwd kernel: g must be a contiguous [R S, out] tensor in the compute dtype")
    if n == 0:
        zeros = (torch.zeros(0, 3, device=origins.device), torch.zeros(0, 3, device=origins.device),
                 torch.zeros(0, 1, device=origins.device))
        return (zeros if need_input_grads else (None,) * 3,
                torch.zeros(packed.weights.numel(), device=origins.device),
                torch.zeros(packed.biases.numel(), device=origins.device))
    # the kernels write every element of these
    dw, db = _f32(packed.weights.numel(), like=origins), _f32(packed.biases.numel(), like=origins)
    x, dx, d_pos = _f32(n, 3, like=origins), _f32(n, 3, like=origins), _f32(n, 3, like=origins)
    d_o, d_d, d_t = ((_f32(r, 3, like=origins), _f32(r, 3, like=origins), _f32(n, 1, like=origins))
                     if need_input_grads else (None,) * 3)
    lib = load_library("bwd")
    ws, scratch = _bwd_buffers(lib, [packed], n, origins)
    desc, desc_len = _desc(packed)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    err = lib.fused_ray_bwd(
        origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), g.data_ptr(), packed.weights.data_ptr(),
        packed.weights_t.data_ptr(), packed.biases.data_ptr(), packed.freqs.data_ptr(), ws.data_ptr(),
        scratch.data_ptr(), x.data_ptr(), dx.data_ptr(), d_pos.data_ptr(), dw.data_ptr(), db.data_ptr(),
        ptr(d_o), ptr(d_d), ptr(d_t), r, num_samples, desc, desc_len,
        _bf16(packed.compute_dtype), int(need_input_grads), *build.device_and_stream(origins),
    )
    if err != 0:
        raise RuntimeError(f"fused_ray_bwd kernel launch failed: cudaError {err}")
    fused_ray_mlp_bwd.launches += 1
    fused_ray_mlp_bwd.input_grad_launches += int(need_input_grads)
    return (d_o, d_d, d_t), dw, db


def fused_field_mlp_bwd(origins, dirs, ts, emb, g, head_in, num_samples: int, base: fm.Packed, head: fm.Packed):
    """One whole-field backward launch: g [R S, C + 2] in the compute dtype
    and the forward's head input -> (d_o, d_d, d_t, d_emb, [dW, db of the
    base stack, dW, db of the head], padded f32)."""
    r = _check_rays(origins, dirs, ts, num_samples, emb)
    n, cdt = r * num_samples, base.compute_dtype
    C, E, width = head.out_dim, emb.shape[1], head.desc[1]
    if tuple(g.shape) != (n, C + 2) or g.dtype != cdt or not g.is_contiguous():
        raise ValueError("fused_field_bwd kernel: g must be a contiguous [R S, C + 2] tensor in the compute dtype")
    if tuple(head_in.shape) != (n, width) or head_in.dtype != torch.float32 or not head_in.is_contiguous():
        raise ValueError("fused_field_bwd kernel: head_in must be the forward's [R S, 16 + geo + E] f32 tensor")
    sizes = [p.weights.numel() if i == 0 else p.biases.numel() for p in (base, head) for i in (0, 1)]
    if n == 0:
        zeros = lambda *shape: torch.zeros(*shape, device=origins.device)  # noqa: E731
        return zeros(0, 3), zeros(0, 3), zeros(0, 1), zeros(0, E), [zeros(k) for k in sizes]
    grads = [_f32(k, like=origins) for k in sizes]
    d_o, d_d, d_t, d_emb = _f32(r, 3, like=origins), _f32(r, 3, like=origins), _f32(n, 1, like=origins), _f32(r, E, like=origins)
    lib = load_library("bwd")
    ws, scratch = _bwd_buffers(lib, [base, head], n, origins)
    g_rgb = g[:, :C].contiguous()
    x, dx, d_pos = _f32(n, 3, like=origins), _f32(n, 3, like=origins), _f32(n, 3, like=origins)
    d_head_in, dsh = _f32(n, width, like=origins), _f32(r, 16, like=origins)
    g_base = torch.empty(n, base.out_dim, dtype=cdt, device=origins.device)
    (bd, bl), (hd, hl) = _desc(base), _desc(head)
    err = lib.fused_field_bwd(
        origins.data_ptr(), dirs.data_ptr(), ts.data_ptr(), g.data_ptr(), g_rgb.data_ptr(), head_in.data_ptr(),
        base.weights.data_ptr(), base.weights_t.data_ptr(), base.biases.data_ptr(), base.freqs.data_ptr(),
        head.weights.data_ptr(), head.weights_t.data_ptr(), head.biases.data_ptr(), ws.data_ptr(),
        scratch.data_ptr(), x.data_ptr(), dx.data_ptr(), d_pos.data_ptr(), d_head_in.data_ptr(),
        g_base.data_ptr(), dsh.data_ptr(), *(t.data_ptr() for t in grads), d_o.data_ptr(), d_d.data_ptr(),
        d_t.data_ptr(), d_emb.data_ptr(), r, num_samples, E, bd, bl, hd, hl, _bf16(cdt),
        *build.device_and_stream(origins),
    )
    if err != 0:
        raise RuntimeError(f"fused_field_bwd kernel launch failed: cudaError {err}")
    fused_field_mlp_bwd.launches += 1
    return d_o, d_d, d_t, d_emb, grads


# --------------------------------------------------------------------------
# Autograd nodes
# --------------------------------------------------------------------------


def _check_stack(weights, biases, device, compute_dtype) -> None:
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused ray kernels: compute dtype {compute_dtype} not supported")
    if not 1 <= len(weights) <= fm.MAX_LAYERS or len(weights) != len(biases):
        raise ValueError(f"fused ray kernels: 1..{fm.MAX_LAYERS} layers with one bias each")
    for t in (*weights, *biases):
        if t.device != device:
            raise ValueError("fused ray kernels: parameters must be on the rays' device")


def _ray_inputs(origins, dirs, ts):
    if origins.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused ray kernels: unsupported device {origins.device}")
    return origins.float().contiguous(), dirs.float().contiguous(), ts.float().reshape(-1, 1).contiguous()


def _param_grads(dws, dbs, weights, biases) -> List[torch.Tensor]:
    return [dw.to(w.dtype) for dw, w in zip(dws, weights)] + [db.reshape(b.shape).to(b.dtype) for db, b in zip(dbs, biases)]


class _FusedRayMLP(torch.autograd.Function):
    """fused_ray_mlp as one autograd node: kernels on CUDA, plain versions
    on the CPU, in both directions."""

    @staticmethod
    def forward(ctx, origins, dirs, ts, spec, cache, *params):
        num_samples, out_activation, skips, freq_encoding, compute_dtype, _ = spec
        weights, biases = params[: len(params) // 2], params[len(params) // 2 :]
        ctx.spec = spec
        ctx.packed = None
        ctx.save_for_backward(origins, dirs, ts, *params)
        if origins.device.type == "cpu":
            return fused_ray_mlp_plain(origins, dirs, ts, weights, biases, num_samples, out_activation, skips,
                                       freq_encoding, compute_dtype)
        ctx.packed = fm.prepare(3, weights, biases, out_activation, skips, freq_encoding, compute_dtype,
                                transposed=any(ctx.needs_input_grad), cache=cache)
        return launch_ray(origins, dirs, ts, num_samples, ctx.packed)

    @staticmethod
    def backward(ctx, g):
        origins, dirs, ts, *params = ctx.saved_tensors
        weights, biases = params[: len(params) // 2], params[len(params) // 2 :]
        num_samples, out_activation, skips, freq_encoding, compute_dtype, input_grads = ctx.spec
        need = input_grads and any(ctx.needs_input_grad[:3])
        if origins.device.type == "cpu":
            d_o, d_d, d_t, dws, dbs = fused_ray_mlp_bwd_plain(
                origins, dirs, ts, g, weights, biases, num_samples, out_activation, skips, freq_encoding,
                compute_dtype, need,
            )
        else:
            out_dim = weights[-1].shape[1]
            (d_o, d_d, d_t), dw, db = fused_ray_mlp_bwd(
                origins, dirs, ts, g[:, :out_dim].to(compute_dtype).contiguous(), num_samples, ctx.packed, need
            )
            dws, dbs = fm.unpack_grads(dw, db, ctx.packed.desc, ctx.packed.shapes)
        return (d_o, d_d, d_t, None, None, *_param_grads(dws, dbs, weights, biases))


def fused_ray_mlp(
    origins: torch.Tensor,  # [R, 3] world-space ray origins
    dirs: torch.Tensor,  # [R, 3] ray directions
    ts: torch.Tensor,  # [R * S, 1] sample midpoints, row-major per ray
    weights: Sequence[torch.Tensor],  # per layer [din, dout]
    biases: Sequence[torch.Tensor],
    num_samples: int,
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    freq_encoding: FreqEncoding = (10, 0.0, 9.0, True),
    compute_dtype: torch.dtype = torch.bfloat16,
    input_grads: bool = True,
    pack_cache: Optional[fm.PackCache] = None,
) -> torch.Tensor:
    """Fused ray-march field evaluation, differentiable: position
    generation, contraction, selector, frequency encoding and the MLP
    stack. Returns [R * S, out + 1] in the compute dtype, the in-scene
    selector last. `input_grads=False` (the proposal fields without camera
    gradients) skips d(origins, dirs, ts) in the backward."""
    skips = tuple(sorted(set(skip_connections)))
    if out_activation not in (None, "sigmoid"):
        raise ValueError("fused ray kernels: a none or sigmoid output only")
    origins, dirs, ts = _ray_inputs(origins, dirs, ts)
    if origins.device.type == "cuda":
        _check_stack(weights, biases, origins.device, compute_dtype)
    spec = (num_samples, out_activation, skips, freq_encoding, compute_dtype, input_grads)
    return _FusedRayMLP.apply(origins, dirs, ts, spec, pack_cache, *weights, *biases)


def _split_field_params(params, n_base: int):
    """(base weights, base biases, head weights, head biases)."""
    n_head = (len(params) - 2 * n_base) // 2
    return (params[:n_base], params[n_base : 2 * n_base], params[2 * n_base : 2 * n_base + n_head],
            params[2 * n_base + n_head :])


class _FusedFieldMLP(torch.autograd.Function):
    """fused_field_mlp as one autograd node. On CUDA the forward keeps the
    head input it assembles, and the backward reads it."""

    @staticmethod
    def forward(ctx, origins, dirs, ts, emb, spec, caches, n_base, *params):
        num_samples, skips, freq_encoding, compute_dtype = spec
        bw, bb, hw, hb = _split_field_params(params, n_base)
        ctx.spec, ctx.n_base = spec, n_base
        ctx.packs = ctx.head_in = None
        ctx.save_for_backward(origins, dirs, ts, emb, *params)
        if origins.device.type == "cpu":
            return fused_field_mlp_plain(origins, dirs, ts, emb, bw, bb, hw, hb, num_samples, skips,
                                         freq_encoding, compute_dtype)
        grads = any(ctx.needs_input_grad)
        base = fm.prepare(3, bw, bb, None, skips, freq_encoding, compute_dtype, transposed=grads, cache=caches[0])
        head = fm.prepare(hw[0].shape[0], hw, hb, "sigmoid", (), None, compute_dtype, transposed=grads,
                          cache=caches[1])
        out, head_in = launch_field(origins, dirs, ts, emb, num_samples, base, head)
        ctx.packs, ctx.head_in = (base, head), head_in
        return out

    @staticmethod
    def backward(ctx, g):
        origins, dirs, ts, emb, *params = ctx.saved_tensors
        num_samples, skips, freq_encoding, compute_dtype = ctx.spec
        bw, bb, hw, hb = _split_field_params(params, ctx.n_base)
        if origins.device.type == "cpu":
            d_o, d_d, d_t, d_emb, dbw, dbb, dhw, dhb = fused_field_mlp_bwd_plain(
                origins, dirs, ts, emb, g, bw, bb, hw, hb, num_samples, skips, freq_encoding, compute_dtype
            )
        else:
            base, head = ctx.packs
            d_o, d_d, d_t, d_emb, (gbw, gbb, ghw, ghb) = fused_field_mlp_bwd(
                origins, dirs, ts, emb, g.to(compute_dtype).contiguous(), ctx.head_in, num_samples, base, head
            )
            dbw, dbb = fm.unpack_grads(gbw, gbb, base.desc, base.shapes)
            dhw, dhb = fm.unpack_grads(ghw, ghb, head.desc, head.shapes)
        return (d_o, d_d, d_t, d_emb, None, None, None,
                *_param_grads(dbw, dbb, bw, bb), *_param_grads(dhw, dhb, hw, hb))


def fused_field_mlp(
    origins: torch.Tensor,  # [R, 3] f32
    dirs: torch.Tensor,  # [R, 3] f32 unit directions
    ts: torch.Tensor,  # [R * S, 1] f32 sample midpoints
    emb: torch.Tensor,  # [R, E] f32 per-ray appearance embeddings
    base_weights: Sequence[torch.Tensor],
    base_biases: Sequence[torch.Tensor],
    head_weights: Sequence[torch.Tensor],
    head_biases: Sequence[torch.Tensor],
    num_samples: int,
    skip_connections: Sequence[int] = (),
    freq_encoding: FreqEncoding = (10, 0.0, 9.0, True),
    compute_dtype: torch.dtype = torch.bfloat16,
    pack_caches: Tuple[Optional[fm.PackCache], Optional[fm.PackCache]] = (None, None),
) -> torch.Tensor:
    """The whole NerfactoField forward, differentiable: the ray march and
    base stack of `fused_ray_mlp`, SH4 of the directions, the appearance
    embedding and the colour head (relu, relu, sigmoid). Returns
    [R * S, C + 2]: colour, raw (pre-trunc_exp) density and the selector,
    in the compute dtype. The head input is [SH4(dir), geo, emb]."""
    skips = tuple(sorted(set(skip_connections)))
    origins, dirs, ts = _ray_inputs(origins, dirs, ts)
    emb = emb.float().contiguous()
    if origins.device.type == "cuda":
        _check_stack(base_weights, base_biases, origins.device, compute_dtype)
        _check_stack(head_weights, head_biases, origins.device, compute_dtype)
    spec = (num_samples, skips, freq_encoding, compute_dtype)
    return _FusedFieldMLP.apply(origins, dirs, ts, emb, spec, pack_caches, len(base_weights),
                                *base_weights, *base_biases, *head_weights, *head_biases)


# Kernel launches since the last reset; the CPU path does not count. The
# ray backward also counts those of its launches that computed input
# gradients.
fused_ray_mlp.launches = 0
fused_ray_mlp_bwd.launches = 0
fused_ray_mlp_bwd.input_grad_launches = 0
fused_field_mlp.launches = 0
fused_field_mlp_bwd.launches = 0
