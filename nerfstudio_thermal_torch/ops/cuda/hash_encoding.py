"""Hash-grid encoding: hand-written Hopper kernels and their autograd node.

Counterpart of nerfstudio_thermal_tpu/ops/encodings.py:hash_encode (with its
custom VJP) and of the TPU kernels that compute the same function:
ops/pallas/hash_gather.py:hash_encode_hybrid (an XLA row-gather forward and
the `_bwd_table_kernel` scatter) and ops/pallas/hash_encoding.py:
hash_encode_pallas (`_fwd_kernel`, `_bwd_table_kernel`, `_bwd_pos_kernel`).
The CUDA source is nerfstudio_thermal_torch/csrc/hash_encoding.cu; its
header says what bounds each kernel and how each is mapped: the forward and
the table gradient give a block a tile of consecutive points (256 and 32),
whose warps take one level of 32 points each, lane = point, with the tile
of the output (or of g) staged in shared memory; the table gradient sums
the lanes of a warp that add to the same row before one atomic. The plain
PyTorch versions of the three functions are in ops/encodings.py.

`hash_encode` is one autograd node that dispatches on the device of the
positions: for CPU tensors the forward is `hash_encode_plain` and the
backward `hash_encode_bwd_table_plain` / `hash_encode_bwd_pos_plain`; for
CUDA tensors all three are kernels, built with nvcc at first use
(ops/cuda/build.py) and launched on torch's current stream. There is no
fallback from one to the other: a CUDA tensor launches the kernel or
raises. The node saves only (table, positions, scalings): the backward
recomputes the corners and re-gathers the rows. It runs the table kernel
when the table needs a gradient and the position kernel only when the
positions need one.

The kernels take F = 2 features per level (the configurations' value); the
plain versions take any F.
"""

import ctypes

import torch

from nerfstudio_thermal_torch.ops import encodings
from nerfstudio_thermal_torch.ops.cuda import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _bind(lib: ctypes.CDLL) -> None:
    lib.hash_encode_fwd.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
    lib.hash_encode_bwd_table.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
    lib.hash_encode_bwd_pos.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
    for fn in (lib.hash_encode_fwd, lib.hash_encode_bwd_table, lib.hash_encode_bwd_pos):
        fn.restype = _I


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the hash-grid kernels' library."""
    return build.load("hash_encoding", _bind)


def _log2(table_size: int) -> int:
    if table_size <= 0 or table_size & (table_size - 1):
        raise ValueError(f"hash_encode: table size {table_size} is not a power of 2")
    return table_size.bit_length() - 1


def _check_kernel_args(table, positions, scalings, table_size, dtype) -> None:
    """What the kernels take: f32 contiguous table [L * T, 2], positions
    [N, 3] and scalings [L] on one CUDA device; bf16 or f32 output."""
    dev = positions.device
    if dev.type != "cuda":
        raise ValueError(f"hash_encode kernels: unsupported device {dev}")
    num_levels = scalings.shape[0]
    if tuple(table.shape) != (num_levels * table_size, 2):
        raise ValueError(
            f"hash_encode kernels: the table must be [L * T, 2] = [{num_levels * table_size}, 2], "
            f"got {tuple(table.shape)}"
        )
    for name, t in (("table", table), ("positions", positions), ("scalings", scalings)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"hash_encode kernels: {name} must be a contiguous f32 tensor on {dev}")
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"hash_encode kernels: positions must be [N, 3], got {tuple(positions.shape)}")
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"hash_encode kernels: compute dtype {dtype} not supported")
    _log2(table_size)


def _check_g(g: torch.Tensor, n: int, num_levels: int) -> None:
    if tuple(g.shape) != (n, 2 * num_levels) or g.dtype not in KERNEL_DTYPES or not g.is_contiguous():
        raise ValueError("hash_encode kernels: g must be a contiguous [N, 2L] bf16 or f32 tensor")


def hash_encode_fwd(table, positions, scalings, table_size: int, compute_dtype: torch.dtype) -> torch.Tensor:
    """One forward launch: positions [N, 3] -> [N, 2L] in the compute dtype."""
    _check_kernel_args(table, positions, scalings, table_size, compute_dtype)
    n, num_levels = positions.shape[0], scalings.shape[0]
    out = torch.empty(n, 2 * num_levels, dtype=compute_dtype, device=positions.device)
    if n == 0:
        return out
    err = load_library().hash_encode_fwd(
        positions.data_ptr(), table.data_ptr(), scalings.data_ptr(), out.data_ptr(), n, num_levels,
        _log2(table_size), int(compute_dtype == torch.bfloat16), *build.device_and_stream(positions),
    )
    if err != 0:
        raise RuntimeError(f"hash_encode_fwd kernel launch failed: cudaError {err}")
    hash_encode_fwd.launches += 1
    return out


def hash_encode_bwd_table(positions, g, scalings, table_size: int) -> torch.Tensor:
    """One table-gradient launch: d_table [L * T, 2] f32, g * w of every
    corner added with atomics."""
    num_levels = scalings.shape[0]
    d_table = torch.zeros(num_levels * table_size, 2, device=positions.device)
    _check_kernel_args(d_table, positions, scalings, table_size, g.dtype)
    n = positions.shape[0]
    _check_g(g, n, num_levels)
    if n == 0:
        return d_table
    if g.data_ptr() % 16:  # the kernel reads g's tiles 16 bytes at a time
        g = g.clone()
    err = load_library().hash_encode_bwd_table(
        positions.data_ptr(), g.data_ptr(), scalings.data_ptr(), d_table.data_ptr(), n, num_levels,
        _log2(table_size), int(g.dtype == torch.bfloat16), *build.device_and_stream(positions),
    )
    if err != 0:
        raise RuntimeError(f"hash_encode_bwd_table kernel launch failed: cudaError {err}")
    hash_encode_bwd_table.launches += 1
    return d_table


def hash_encode_bwd_pos(table, positions, g, scalings, table_size: int) -> torch.Tensor:
    """One position-gradient launch: d_pos [N, 3] f32."""
    _check_kernel_args(table, positions, scalings, table_size, g.dtype)
    n, num_levels = positions.shape[0], scalings.shape[0]
    _check_g(g, n, num_levels)
    d_pos = torch.empty(n, 3, dtype=torch.float32, device=positions.device)
    if n == 0:
        return d_pos
    err = load_library().hash_encode_bwd_pos(
        positions.data_ptr(), table.data_ptr(), g.data_ptr(), scalings.data_ptr(), d_pos.data_ptr(), n,
        num_levels, _log2(table_size), int(g.dtype == torch.bfloat16), *build.device_and_stream(positions),
    )
    if err != 0:
        raise RuntimeError(f"hash_encode_bwd_pos kernel launch failed: cudaError {err}")
    hash_encode_bwd_pos.launches += 1
    return d_pos


class _HashEncode(torch.autograd.Function):
    """hash_encode as one autograd node: kernels on CUDA, plain versions on
    the CPU, in both directions."""

    @staticmethod
    def forward(ctx, table, positions, scalings, table_size, compute_dtype):
        ctx.table_size = table_size
        ctx.save_for_backward(table, positions, scalings)
        if positions.device.type == "cpu":
            return encodings.hash_encode_plain(table, positions, scalings, table_size, compute_dtype)
        return hash_encode_fwd(table, positions, scalings, table_size, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        table, positions, scalings = ctx.saved_tensors
        need_table, need_pos = ctx.needs_input_grad[:2]
        t = ctx.table_size
        d_table = d_pos = None
        if positions.device.type == "cpu":
            if need_table:
                d_table = encodings.hash_encode_bwd_table_plain(positions, g, scalings, t, table.shape[-1])
            if need_pos:
                d_pos = encodings.hash_encode_bwd_pos_plain(table, positions, g, scalings, t)
        else:
            g = g.contiguous()
            if need_table:
                d_table = hash_encode_bwd_table(positions, g, scalings, t)
            if need_pos:
                d_pos = hash_encode_bwd_pos(table, positions, g, scalings, t)
        if d_table is not None:
            d_table = d_table.to(table.dtype)
        if d_pos is not None:
            d_pos = d_pos.to(positions.dtype)
        return d_table, d_pos, None, None, None


def hash_encode(
    table: torch.Tensor,  # [L * T, F]
    positions: torch.Tensor,  # [..., 3] in [0, 1]
    scalings: torch.Tensor,  # [L]
    table_size: int,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Multiresolution hash-grid encoding, differentiable in the table and
    the positions: [..., L * F] in the compute dtype."""
    num_levels, f = scalings.shape[0], table.shape[-1]
    batch_shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3)
    if pos.device.type == "cuda":
        pos = pos.float().contiguous()
    elif pos.device.type != "cpu":
        raise ValueError(f"hash_encode: unsupported device {pos.device}")
    out = _HashEncode.apply(table, pos, scalings, table_size, compute_dtype)
    return out.reshape(*batch_shape, num_levels * f)


# Kernel launches since the last reset; the CPU path does not count.
hash_encode_fwd.launches = 0
hash_encode_bwd_table.launches = 0
hash_encode_bwd_pos.launches = 0
