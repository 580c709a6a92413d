"""Hash-grid encoding: hand-written Hopper kernels and their autograd nodes.

Counterpart of nerfstudio_thermal_tpu/ops/encodings.py:hash_encode (with its
custom VJP) and of the TPU kernels that compute the same function:
ops/pallas/hash_gather.py:hash_encode_hybrid (an XLA row-gather forward and
the `_bwd_table_kernel` scatter) and ops/pallas/hash_encoding.py:
hash_encode_pallas (`_fwd_kernel`, `_bwd_table_kernel`, `_bwd_pos_kernel`).
The CUDA source is nerfstudio_thermal_torch/csrc/hash_encoding.cu; its
header says what bounds each kernel and how each is mapped: all three give
a block a tile of consecutive points (256, 32 and, for the position
gradient of 8 or more levels, 256), whose warps take one level of 32
points each, lane = point, with the tile of the output (or of g) staged in
shared memory; the table gradient sums the lanes of a warp that add to the
same row before one atomic; the position gradient stages each level's
terms and sums a point's levels in one thread, in order (fewer levels walk
them one thread per point); the position gradient's VJP (for an SDF's
second derivative) keeps that tile mapping, with g and dg staged in one
tile. The plain PyTorch versions of the four functions are in
ops/encodings.py.

`hash_encode` is one autograd node that dispatches on the device of the
positions: for CPU tensors the forward is `hash_encode_plain` and the
backward `hash_encode_bwd_table_plain` / `hash_encode_bwd_pos_plain`; for
CUDA tensors all three are kernels, built with nvcc at first use
(ops/cuda/build.py) and launched on torch's current stream. There is no
fallback from one to the other: a CUDA tensor launches the kernel or
raises. The node saves only (table, positions, scalings): the backward
recomputes the corners and re-gathers the rows. It runs the table kernel
when the table's gradient is wanted (not under torch.autograd.grad of the
positions alone, as an SDF's normals take it) and the position gradient
only when the positions need one, through a node of its own,
`_HashEncodeBwdPos`, so that d_pos keeps its graph under
create_graph=True (the eikonal loss differentiates it again). That node's
backward is the fourth kernel, `hash_encode_bwd_pos_vjp` (no TPU kernel
computes it: JAX differentiates its jnp backward), or its plain version
on the CPU.

The kernels take F = 2 features per level (the configurations' value); the
plain versions take any F. The VJP kernel takes g in f32.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from nerfstudio_thermal_torch.ops import encodings
from nerfstudio_thermal_torch.ops.cuda import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _bind(lib: ctypes.CDLL) -> None:
    lib.hash_encode_fwd.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
    lib.hash_encode_bwd_table.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
    lib.hash_encode_bwd_pos.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P]
    lib.hash_encode_bwd_pos_vjp.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _P]
    for fn in (lib.hash_encode_fwd, lib.hash_encode_bwd_table, lib.hash_encode_bwd_pos, lib.hash_encode_bwd_pos_vjp):
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
    if g.data_ptr() % 16:  # the kernel reads g's tiles 16 bytes at a time
        g = g.clone()
    err = load_library().hash_encode_bwd_pos(
        positions.data_ptr(), table.data_ptr(), g.data_ptr(), scalings.data_ptr(), d_pos.data_ptr(), n,
        num_levels, _log2(table_size), int(g.dtype == torch.bfloat16), *build.device_and_stream(positions),
    )
    if err != 0:
        raise RuntimeError(f"hash_encode_bwd_pos kernel launch failed: cudaError {err}")
    hash_encode_bwd_pos.launches += 1
    return d_pos


def hash_encode_bwd_pos_vjp(table, positions, g, v, scalings, table_size: int, need_g: bool = True,
                            need_table: bool = True, need_pos: bool = True):
    """One launch of the position gradient's VJP for the cotangent v [N, 3]
    of d_pos: (dg [N, 2L], d_table [L * T, 2], d_pos2 [N, 3]), f32, None
    for each output not asked for (its pointer is null and the kernel skips
    its work). g is taken in f32."""
    _check_kernel_args(table, positions, scalings, table_size, torch.float32)
    n, num_levels = positions.shape[0], scalings.shape[0]
    g = g.float().contiguous()
    _check_g(g, n, num_levels)
    if g.data_ptr() % 16:  # the kernel reads g's tiles 16 bytes at a time
        g = g.clone()
    v = v.float().contiguous()
    if tuple(v.shape) != (n, 3) or v.device != positions.device:
        raise ValueError(f"hash_encode_bwd_pos_vjp: v must be [N, 3] on {positions.device}, got {tuple(v.shape)}")
    dev = positions.device
    dg = torch.empty(n, 2 * num_levels, device=dev) if need_g else None
    d_table = torch.zeros(num_levels * table_size, 2, device=dev) if need_table else None
    d_pos2 = torch.empty(n, 3, device=dev) if need_pos else None
    if n == 0 or not (need_g or need_table or need_pos):
        return dg, d_table, d_pos2
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = load_library().hash_encode_bwd_pos_vjp(
        positions.data_ptr(), table.data_ptr(), g.data_ptr(), v.data_ptr(), scalings.data_ptr(), ptr(dg),
        ptr(d_table), ptr(d_pos2), n, num_levels, _log2(table_size), *build.device_and_stream(positions),
    )
    if err != 0:
        raise RuntimeError(f"hash_encode_bwd_pos_vjp kernel launch failed: cudaError {err}")
    hash_encode_bwd_pos_vjp.launches += 1
    return dg, d_table, d_pos2


def _wanted(ctx, i: int) -> bool:
    """Whether a backward must give its input i a gradient: the input needs
    one and the engine will run the node that gradient flows to. Under
    torch.autograd.grad of the positions only (an SDF's normals) the
    table's node does not run, so its scatter is skipped; `hash_encode`
    hands the table in through a view so that the engine can be asked (it
    cannot be asked about a leaf's accumulator under autograd.grad: then
    the answer is yes)."""
    if not ctx.needs_input_grad[i]:
        return False
    try:
        return bool(torch._C._will_engine_execute_node(ctx.next_functions[i][0]))
    except RuntimeError:
        return True


class _HashEncodeBwdPos(torch.autograd.Function):
    """The position gradient d_pos (row 10: the kernel on CUDA,
    hash_encode_bwd_pos_plain on the CPU) as an autograd node of its own, so
    that d_pos keeps its graph under create_graph=True on both devices (an
    SDF's eikonal loss differentiates it again). Its backward is the VJP:
    `hash_encode_bwd_pos_vjp` on CUDA, `hash_encode_bwd_pos_vjp_plain` on
    the CPU, each output only where its input needs it. A third derivative
    raises (once_differentiable)."""

    @staticmethod
    def forward(ctx, table, positions, g, scalings, table_size):
        ctx.table_size = table_size
        ctx.save_for_backward(table, positions, g, scalings)
        if positions.device.type == "cpu":
            return encodings.hash_encode_bwd_pos_plain(table, positions, g, scalings, table_size)
        return hash_encode_bwd_pos(table, positions, g.contiguous(), scalings, table_size)

    @staticmethod
    @once_differentiable
    def backward(ctx, v):
        table, positions, g, scalings = ctx.saved_tensors
        need_table, need_pos, need_g = (_wanted(ctx, i) for i in range(3))
        args = (table, positions, g, v, scalings, ctx.table_size, need_g, need_table, need_pos)
        if positions.device.type == "cpu":
            dg, d_table, d_pos2 = encodings.hash_encode_bwd_pos_vjp_plain(*args)
        else:
            dg, d_table, d_pos2 = hash_encode_bwd_pos_vjp(*args)
        return (
            None if d_table is None else d_table.to(table.dtype),
            None if d_pos2 is None else d_pos2.to(positions.dtype),
            None if dg is None else dg.to(g.dtype),
            None,
            None,
        )


class _HashEncode(torch.autograd.Function):
    """hash_encode as one autograd node: kernels on CUDA, plain versions on
    the CPU, in both directions. The position gradient goes through
    `_HashEncodeBwdPos`, so it can be differentiated again."""

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
        need_table, need_pos = _wanted(ctx, 0), _wanted(ctx, 1)
        t = ctx.table_size
        d_table = d_pos = None
        if positions.device.type != "cpu":
            g = g.contiguous()
        if need_table:
            if positions.device.type == "cpu":
                d_table = encodings.hash_encode_bwd_table_plain(positions, g, scalings, t, table.shape[-1])
            else:
                d_table = hash_encode_bwd_table(positions, g, scalings, t)
            d_table = d_table.to(table.dtype)
        if need_pos:
            d_pos = _HashEncodeBwdPos.apply(table, positions, g, scalings, t).to(positions.dtype)
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
    # a view, so that a backward can ask whether the table's gradient is wanted (_wanted)
    out = _HashEncode.apply(table.view_as(table), pos, scalings, table_size, compute_dtype)
    return out.reshape(*batch_shape, num_levels * f)


# Kernel launches since the last reset; the CPU path does not count.
hash_encode_fwd.launches = 0
hash_encode_bwd_table.launches = 0
hash_encode_bwd_pos.launches = 0
hash_encode_bwd_pos_vjp.launches = 0
