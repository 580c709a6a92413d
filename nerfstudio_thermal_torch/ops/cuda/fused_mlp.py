"""Fused MLP: hand-written Hopper kernels and their plain PyTorch versions.

Counterpart of nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:fused_mlp,
forward and backward (the TPU kernel bodies `_fwd_kernel` and
`_bwd_kernel`). The CUDA sources are nerfstudio_thermal_torch/csrc/
fused_mlp_fwd.cu and fused_mlp_bwd.cu; their headers say what bounds each
kernel and what the first design gives up.

`fused_mlp` is one autograd node that dispatches on the device of its
input: for a CPU tensor the forward is `fused_mlp_plain` and the backward
`fused_mlp_bwd_plain`; for a CUDA tensor both are kernels, built with nvcc
on first use into build/kernels/ and loaded with ctypes (ops/cuda/build.py).
There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.

The forward has three paths, chosen by the kernel library from the
descriptor and the compute dtype (`forward_plan` asks it which): the f32
kernel; for bf16 the one-pass narrow kernel (no skip layer, every padded
width <= 64: the proposal stacks, the colour head) or the wgmma kernel
(every other stack whose padded widths are <= 256: the 8 x 256 base
stacks), which reads the weights in its own order, laid out by the plan
the library returns (`Packed.weights_wg`, `_pack_wgmma`).

Numerics (both versions): the frequency table is 2*pi*exp2(e_k) in f32;
pre = x_d * f_k is one product; the encoding [sin(pre), cos(pre), x] is
rounded to the compute dtype. Each layer adds its bias (rounded to the
compute dtype) to an f32 accumulator, applies relu (or the output
activation) in f32 and rounds to the compute dtype. The backward follows
the rounding points of the TPU kernel's `_mlp_bwd_walk` (see
`fused_mlp_bwd_plain`).
"""

import collections
import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from nerfstudio_thermal_torch.ops.cuda import build

MAX_LAYERS = 16
_DESC_HEADER = 9  # ints before the per-layer descriptors
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
# Forward paths, in the order of the kernel library's FwdPath values.
FWD_PATHS = ("f32", "narrow", "wgmma")

FreqEncoding = Tuple[int, float, float, bool]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def encoding_dim(in_dim: int, freq_encoding: Optional[FreqEncoding]) -> int:
    if freq_encoding is None:
        return in_dim
    nf, _, _, include_input = freq_encoding
    return in_dim * nf * 2 + (in_dim if include_input else 0)


def frequencies(freq_encoding: FreqEncoding, device) -> torch.Tensor:
    """[F] f32: 2*pi*exp2(min + (max - min) * k / (F - 1)), in f32 as the
    TPU kernel computes it."""
    nf, min_exp, max_exp, _ = freq_encoding
    k = torch.arange(nf, dtype=torch.float32, device=device)
    exps = min_exp + (max_exp - min_exp) * k / max(nf - 1, 1)
    return (2.0 * math.pi) * torch.exp2(exps)


def encode(x: torch.Tensor, freq_encoding: FreqEncoding) -> torch.Tensor:
    """In-kernel NeRF encoding, f32: [sin(pre), cos(pre) (, x)], pre laid
    out d * F + k."""
    pre = (x[..., :, None] * frequencies(freq_encoding, x.device)).reshape(*x.shape[:-1], -1)
    parts = [torch.sin(pre), torch.cos(pre)]
    if freq_encoding[3]:
        parts.append(x)
    return torch.cat(parts, dim=-1)


def _apply_act(h: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    if name is None:
        return h
    if name == "relu":
        return torch.relu(h)
    if name == "sigmoid":
        return torch.sigmoid(h)
    raise ValueError(f"unsupported activation {name}")


def fused_mlp_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],  # per layer [din, dout]
    biases: Sequence[torch.Tensor],  # per layer [dout]
    activation: str = "relu",
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    freq_encoding: Optional[FreqEncoding] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same function, layer by layer."""
    if freq_encoding is not None:
        x0 = encode(x.float(), freq_encoding).to(compute_dtype)
    else:
        x0 = x.to(compute_dtype)
    h = x0
    n = len(weights)
    for li, (w, b) in enumerate(zip(weights, biases)):
        inp = torch.cat([x0, h], dim=-1) if (li in skip_connections and li != 0) else h
        pre = inp.float() @ w.to(compute_dtype).float() + b.to(compute_dtype).float()
        h = _apply_act(pre, activation if li < n - 1 else out_activation).to(compute_dtype)
    return h


# --------------------------------------------------------------------------
# Load (ops/cuda/build.py compiles)
# --------------------------------------------------------------------------


_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(_I)


def _bind_fwd(lib: ctypes.CDLL) -> None:
    lib.fused_mlp_fwd_plan.argtypes = [_IP, _I, _I, _IP, _IP, ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_mlp_fwd_plan.restype = _I
    lib.fused_mlp_fwd.argtypes = [_P, _P, _P, ctypes.c_longlong, _P, _P, _P, _I, _IP, _I, _I, _I, _P]
    lib.fused_mlp_fwd.restype = _I


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.fused_mlp_bwd_sizes.argtypes = [_IP, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_mlp_bwd_sizes.restype = _I
    lib.fused_mlp_bwd.argtypes = [_P] * 11 + [_I, _IP, _I, _I, _I, _P]
    lib.fused_mlp_bwd.restype = _I


def load_library(kind: str) -> ctypes.CDLL:
    """Build (at first use) and load the forward ("fwd") or backward
    ("bwd") kernel's shared library."""
    return build.load(f"fused_mlp_{kind}", _bind_fwd if kind == "fwd" else _bind_bwd)


# --------------------------------------------------------------------------
# Weight packing (shapes, padding and layout the kernel reads)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _fragment_index(k_pad: int, n_pad: int, device) -> torch.Tensor:
    """Flat indices into a row-major [k_pad, n_pad] matrix, in the order of
    mma.m16n8k16 B fragments: [k-tile][n-tile pair][lane][8 values], so one
    16-byte load per lane yields the fragments of two n-tiles."""
    kt = torch.arange(k_pad // 16, device=device)[:, None, None, None]
    pair = torch.arange(n_pad // 16, device=device)[None, :, None, None]
    lane = torch.arange(32, device=device)[None, None, :, None]
    j = torch.arange(8, device=device)[None, None, None, :]
    k = kt * 16 + 2 * (lane % 4) + j % 2 + 8 * ((j % 4) // 2)
    n = pair * 16 + 8 * (j // 4) + lane // 4
    return (k * n_pad + n).reshape(-1)


def _pad_layers(
    weights: Sequence[torch.Tensor],
    skips: Sequence[int],
    enc_dim: int,
    compute_dtype: torch.dtype,
) -> Tuple[List[torch.Tensor], List[bool], int]:
    """Every layer as a zero-padded [k_pad, n_pad] matrix in the compute
    dtype (multiples of 16), skip layers laid out as [x0 rows | pad | h rows
    | pad]. Returns (matrices, skip flags, in_pad)."""
    in_pad = _round_up(enc_dim, 16)
    device = weights[0].device
    mats, flags = [], []
    prev = enc_dim
    for li, w in enumerate(weights):
        din, dout = w.shape
        skip = li in skips and li != 0
        if li == 0:
            if din != enc_dim:
                raise ValueError(f"layer 0 takes {din} inputs, the input gives {enc_dim}")
        elif skip:
            if din != enc_dim + prev:
                raise ValueError(f"skip layer {li} takes {din} inputs, expected {enc_dim + prev}")
        elif din != prev:
            raise ValueError(f"layer {li} takes {din} inputs, the previous layer gives {prev}")
        wp = torch.zeros(_k_pad(skip, din, enc_dim, in_pad), _round_up(dout, 16),
                         dtype=compute_dtype, device=device)
        for src, dst, cnt in _row_segments(skip, din, enc_dim, in_pad):
            wp[dst : dst + cnt, :dout] = w[src : src + cnt].to(compute_dtype)
        mats.append(wp)
        flags.append(skip)
        prev = dout
    return mats, flags, in_pad


def _k_pad(skip: bool, din: int, enc_dim: int, in_pad: int) -> int:
    return in_pad + _round_up(din - enc_dim, 16) if skip else _round_up(din, 16)


def _row_segments(skip: bool, din: int, enc_dim: int, in_pad: int):
    """(source row, padded row, count) of a layer's weight rows."""
    if skip:
        return [(0, 0, enc_dim), (enc_dim, in_pad, din - enc_dim)]
    return [(0, 0, din)]


def _pack_matrix(m: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """A padded [K, N] matrix in the order the kernels read it: mma B
    fragments for bf16, row-major for f32."""
    if compute_dtype == torch.bfloat16:
        return m.reshape(-1)[_fragment_index(m.shape[0], m.shape[1], m.device)]
    return m.reshape(-1)


def pack(
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    skips: Sequence[int],
    enc_dim: int,
    compute_dtype: torch.dtype,
    transposed: bool = False,
):
    """Pad every layer to multiples of 16 (zero weight rows and columns),
    lay skip layers out as [x0 rows | pad | h rows | pad], and pack.

    Returns (weights, biases, per-layer desc ints, in_pad, hid_pad), and
    with `transposed` also the packed W^T of every layer ([n_pad, k_pad],
    at the same offsets), which the backward's dh W^T products read."""
    mats, flags, in_pad = _pad_layers(weights, skips, enc_dim, compute_dtype)
    device = weights[0].device
    packed_w, packed_t, packed_b, desc = [], [], [], []
    w_off = b_off = 0
    hid_pad = 16
    for li, (wp, b, skip) in enumerate(zip(mats, biases, flags)):
        k_pad, n_pad = wp.shape
        packed_w.append(_pack_matrix(wp, compute_dtype))
        if transposed:
            packed_t.append(_pack_matrix(wp.t().contiguous(), compute_dtype))
        bp = torch.zeros(n_pad, dtype=torch.float32, device=device)
        bp[: b.shape[0]] = b.to(compute_dtype).float()
        packed_b.append(bp)
        desc += [k_pad, n_pad, int(skip), w_off, b_off]
        w_off += k_pad * n_pad
        b_off += n_pad
        if li < len(mats) - 1:
            hid_pad = max(hid_pad, n_pad)
    out = (torch.cat(packed_w), torch.cat(packed_b), desc, in_pad, hid_pad)
    return out + (torch.cat(packed_t),) if transposed else out


def unpack_grads(
    dw: torch.Tensor,  # [total_w] f32, padded row-major [k_pad, n_pad] per layer
    db: torch.Tensor,  # [total_b] f32
    desc: List[int],
    shapes: Sequence[Tuple[int, int]],
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The backward kernel's padded dW/db back to per-layer [din, dout] and
    [dout], both skip segments included."""
    in_pad, enc_dim = desc[2], desc[3]
    dws, dbs = [], []
    for li, (din, dout) in enumerate(shapes):
        k_pad, n_pad, skip, w_off, b_off = desc[_DESC_HEADER + 5 * li : _DESC_HEADER + 5 * li + 5]
        m = dw[w_off : w_off + k_pad * n_pad].view(k_pad, n_pad)
        rows = [m[dst : dst + cnt, :dout] for _, dst, cnt in _row_segments(bool(skip), din, enc_dim, in_pad)]
        dws.append(torch.cat(rows) if len(rows) > 1 else rows[0])
        dbs.append(db[b_off : b_off + dout])
    return dws, dbs


def forward_plan(desc: Sequence[int], compute_dtype: torch.dtype) -> Tuple[str, List[Tuple[int, int, int, int]], int]:
    """The forward kernel library's plan of a stack (fused_mlp_fwd.cu
    fused_mlp_fwd_plan): its path (one of FWD_PATHS) and, on the wgmma
    path, per layer (wgmma width nw, 64-row slices of x0, 64-row slices of
    the previous layer's output, offset of the layer's slices in elements)
    and the length of the wgmma-order weights. Raises for a stack no
    forward kernel takes."""
    c_desc = (ctypes.c_int * len(desc))(*desc)
    path, layers, elems = ctypes.c_int(), (ctypes.c_int * (4 * MAX_LAYERS))(), ctypes.c_longlong()
    err = load_library("fwd").fused_mlp_fwd_plan(
        c_desc, len(desc), int(compute_dtype == torch.bfloat16), ctypes.byref(path), layers, ctypes.byref(elems)
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd: malformed descriptor (cudaError {err})")
    if path.value < 0:
        widths = [desc[_DESC_HEADER + 5 * i + 1] for i in range(desc[0])]
        raise ValueError(f"fused_mlp: no {compute_dtype} forward kernel takes this stack "
                         f"(padded input {desc[2]}, layers {widths})")
    plan = [tuple(layers[4 * i : 4 * i + 4]) for i in range(desc[0])] if FWD_PATHS[path.value] == "wgmma" else []
    return FWD_PATHS[path.value], plan, elems.value


@functools.lru_cache(maxsize=16)
def _wgmma_index(nw: int, device) -> torch.Tensor:
    """Flat indices into a slice stored n-major ([nw, 64]: row n holds
    the slice's 64 k values of column n), in wgmma's K-major 128-byte
    swizzle order: row n is 128 bytes, and its 16-byte chunk c of k values
    8c .. 8c + 7 sits at chunk position c ^ (n % 8)."""
    n = torch.arange(nw, device=device)[:, None, None]
    pos = torch.arange(8, device=device)[None, :, None]
    e = torch.arange(8, device=device)[None, None, :]
    return (n * 64 + (pos ^ (n % 8)) * 8 + e).reshape(-1)


def _pack_wgmma(
    mats: Sequence[torch.Tensor], flags: Sequence[bool], in_pad: int,
    plan: Sequence[Tuple[int, int, int, int]], total: int,
) -> torch.Tensor:
    """The padded [k_pad, n_pad] layers in the wide path's order: per layer
    of the plan (`forward_plan`) the 64-row slices of its x0 rows (rows
    0 .. in_pad), then of its h rows (from in_pad in a skip layer, from 0
    otherwise), each zero beyond the layer's rows and columns, laid out by
    `_wgmma_index`; `total` elements in all."""
    out = []
    for (nw, slices_x0, slices_h, _), wp, skip in zip(plan, mats, flags):
        for start, stop, slices in ((0, in_pad, slices_x0), (in_pad if skip else 0, wp.shape[0], slices_h)):
            rows = wp[start:stop][: 64 * slices]
            seg = torch.zeros(slices * 64, nw, dtype=wp.dtype, device=wp.device)
            seg[: rows.shape[0], : wp.shape[1]] = rows
            for s in range(slices):
                out.append(seg[64 * s : 64 * s + 64].t().reshape(-1)[_wgmma_index(nw, wp.device)])
    packed = torch.cat(out)
    assert packed.numel() == total
    return packed


# --------------------------------------------------------------------------
# Wrapper
# --------------------------------------------------------------------------


@dataclass
class Packed:
    """Weights, biases and descriptor of one MLP, in the kernels' layout."""

    weights: torch.Tensor
    biases: torch.Tensor
    freqs: torch.Tensor  # encoding frequencies (unused without encoding)
    desc: List[int]
    out_dim: int
    compute_dtype: torch.dtype
    shapes: List[Tuple[int, int]]  # per layer [din, dout]
    weights_t: Optional[torch.Tensor] = None  # packed W^T, for the backward
    fwd_path: Optional[str] = None  # the forward kernel (forward_plan); None off the card
    weights_wg: Optional[torch.Tensor] = None  # the wgmma path's weights (_pack_wgmma)


class PackCache:
    """Packed weights of one MLP by the identity and version of its tensors:
    a training step runs each field's MLP twice with the same weights, and
    an optimizer step bumps the versions. Entries hold their tensors, so an
    address cannot be reused while its entry lives."""

    def __init__(self, size: int = 2):
        self.size = size
        self.entries: "collections.OrderedDict" = collections.OrderedDict()

    def get(self, key, tensors, build) -> "Packed":
        hit = self.entries.get(key)
        if hit is not None:
            self.entries.move_to_end(key)
            return hit[1]
        packed = build()
        self.entries[key] = (tensors, packed)
        if len(self.entries) > self.size:
            self.entries.popitem(last=False)
        return packed


def prepare(
    in_dim: int,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    out_activation: Optional[str],
    skips: Sequence[int],
    freq_encoding: Optional[FreqEncoding],
    compute_dtype: torch.dtype,
    transposed: bool = False,
    cache: Optional[PackCache] = None,
) -> Packed:
    """Pack an MLP for `launch` (and, with `transposed`, for
    `launch_bwd`). For CUDA tensors the kernel library names the forward
    path, and a stack no forward kernel takes raises; CPU tensors get the
    packing alone (the tests' emulations read it). With a cache, calls with
    unchanged tensors reuse the packing."""
    args = (in_dim, weights, biases, out_activation, skips, freq_encoding, compute_dtype, transposed)
    if cache is None:
        return _prepare(*args)
    tensors = (*weights, *biases)
    key = (
        tuple((t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device) for t in tensors),
        in_dim, out_activation, tuple(skips), freq_encoding, compute_dtype, transposed,
    )
    return cache.get(key, tensors, lambda: _prepare(*args))


def _prepare(in_dim, weights, biases, out_activation, skips, freq_encoding, compute_dtype, transposed) -> Packed:
    enc_dim = encoding_dim(in_dim, freq_encoding)
    w, b, layer_desc, in_pad, hid_pad, *wt = pack(
        weights, biases, skips, enc_dim, compute_dtype, transposed
    )
    out_dim = weights[-1].shape[1]
    header = [
        len(weights), in_dim, in_pad, enc_dim,
        freq_encoding[0] if freq_encoding is not None else 0,
        int(bool(freq_encoding[3])) if freq_encoding is not None else 0,
        hid_pad, out_dim, int(out_activation == "sigmoid"),
    ]
    freqs = (
        frequencies(freq_encoding, w.device)
        if freq_encoding is not None
        else torch.zeros(1, dtype=torch.float32, device=w.device)
    )
    shapes = [tuple(t.shape) for t in weights]
    desc = header + layer_desc
    path = weights_wg = None
    if w.device.type == "cuda":
        path, plan, total = forward_plan(desc, compute_dtype)
        if path == "wgmma":
            mats, flags, _ = _pad_layers(weights, skips, enc_dim, compute_dtype)
            weights_wg = _pack_wgmma(mats, flags, in_pad, plan, total)
    return Packed(w, b, freqs, desc, out_dim, compute_dtype, shapes, wt[0] if wt else None, path, weights_wg)


def wgmma_args(packed: Packed) -> Tuple[Optional[int], int]:
    """(pointer, length) of a stack's wgmma-order weights, as the kernel
    libraries take them; (None, 0) off the wgmma path."""
    if packed.weights_wg is None:
        return None, 0
    return packed.weights_wg.data_ptr(), packed.weights_wg.numel()


def launch(x: torch.Tensor, packed: Packed) -> torch.Tensor:
    """One forward launch on the current stream, on the stack's path
    (`Packed.fwd_path`): x [N, in_dim] f32 CUDA, contiguous -> [N,
    out_dim] in the compute dtype."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_mlp kernel: x must be a contiguous [N, in_dim] f32 CUDA tensor")
    if x.shape[1] != packed.desc[1]:
        raise ValueError(f"fused_mlp kernel: x has {x.shape[1]} columns, the MLP takes {packed.desc[1]}")
    n = x.shape[0]
    out = torch.empty(n, packed.out_dim, dtype=packed.compute_dtype, device=x.device)
    if n == 0:
        return out
    desc = (ctypes.c_int * len(packed.desc))(*packed.desc)
    err = load_library("fwd").fused_mlp_fwd(
        x.data_ptr(), packed.weights.data_ptr(), *wgmma_args(packed), packed.biases.data_ptr(),
        packed.freqs.data_ptr(), out.data_ptr(), n, desc, len(packed.desc),
        int(packed.compute_dtype == torch.bfloat16),
        *build.device_and_stream(x),
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd kernel launch failed ({packed.fwd_path} path): cudaError {err}")
    fused_mlp.launches += 1
    fused_mlp.path_launches[packed.fwd_path] += 1
    return out


@dataclass
class BwdSizes:
    """What one backward needs, as the kernel library plans it."""

    ws_elems: int  # workspace elements in the compute dtype (0 on the narrow path)
    scratch_floats: int  # f32 scratch: dW/db slabs and partial sums
    narrow: bool  # the one-pass kernel (bf16, no skip, every width <= 64)


def bwd_sizes(lib: ctypes.CDLL, packed: Packed, n: int, like: torch.Tensor) -> BwdSizes:
    """The backward's plan for `packed` at n points on `like`'s device
    (`lib` is either backward library: both export fused_mlp_bwd_sizes)."""
    desc = (ctypes.c_int * len(packed.desc))(*packed.desc)
    out = (ctypes.c_longlong * 4)()
    err = lib.fused_mlp_bwd_sizes(desc, len(packed.desc), n, int(packed.compute_dtype == torch.bfloat16),
                                  build.device_and_stream(like)[0], out)
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd: the kernel refuses this MLP (cudaError {err})")
    if out[2] > SMEM_LIMIT:
        raise ValueError("fused_mlp_bwd: widths exceed the backward kernel's shared memory")
    return BwdSizes(out[0], out[1], bool(out[3]))


def launch_bwd(
    x: torch.Tensor, g: torch.Tensor, packed: Packed
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward on the current stream (the one-pass kernel and two
    sums for a narrow bf16 stack, else the walk, dW and three sums):
    x [N, in_dim] f32 and g [N, out_dim] in the compute dtype, contiguous
    CUDA tensors -> (dx [N, in_dim] f32, dW padded [total_w] f32, db padded
    [total_b] f32); `unpack_grads` gives the per-layer tensors."""
    if packed.weights_t is None:
        raise ValueError("fused_mlp_bwd kernel: pack the MLP with transposed=True")
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_mlp_bwd kernel: x must be a contiguous [N, in_dim] f32 CUDA tensor")
    if x.shape[1] != packed.desc[1]:
        raise ValueError(f"fused_mlp_bwd kernel: x has {x.shape[1]} columns, the MLP takes {packed.desc[1]}")
    n = x.shape[0]
    if tuple(g.shape) != (n, packed.out_dim) or g.dtype != packed.compute_dtype or not g.is_contiguous():
        raise ValueError("fused_mlp_bwd kernel: g must be a contiguous [N, out_dim] tensor in the compute dtype")
    dev = x.device
    if n == 0:
        return (
            torch.zeros(0, x.shape[1], dtype=torch.float32, device=dev),
            torch.zeros(packed.weights.numel(), dtype=torch.float32, device=dev),
            torch.zeros(packed.biases.numel(), dtype=torch.float32, device=dev),
        )
    # the kernels write every element of the three outputs
    dx = torch.empty(n, x.shape[1], dtype=torch.float32, device=dev)
    dw = torch.empty(packed.weights.numel(), dtype=torch.float32, device=dev)
    db = torch.empty(packed.biases.numel(), dtype=torch.float32, device=dev)
    lib = load_library("bwd")
    desc = (ctypes.c_int * len(packed.desc))(*packed.desc)
    bf16 = int(packed.compute_dtype == torch.bfloat16)
    sizes = bwd_sizes(lib, packed, n, x)
    workspace = torch.empty(sizes.ws_elems, dtype=packed.compute_dtype, device=dev)
    scratch = torch.empty(sizes.scratch_floats, dtype=torch.float32, device=dev)
    err = lib.fused_mlp_bwd(
        x.data_ptr(), g.data_ptr(), packed.weights.data_ptr(), packed.weights_t.data_ptr(),
        packed.biases.data_ptr(), packed.freqs.data_ptr(), workspace.data_ptr(), scratch.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), db.data_ptr(), n, desc, len(packed.desc), bf16,
        *build.device_and_stream(x),
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd kernel launch failed: cudaError {err}")
    fused_mlp_bwd.launches += 1
    return dx, dw, db


def fused_mlp_bwd_plain(
    x: torch.Tensor,
    g: torch.Tensor,  # [N, out_dim] cotangent of the output
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    activation: str = "relu",
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    freq_encoding: Optional[FreqEncoding] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Plain PyTorch version of the backward kernel (see
    `mlp_bwd_walk_plain`); the encoding backward is f32, and without the
    encoding dx is the walk's dx0 rounded to the compute dtype.
    Returns (dx in x's dtype, [dW] f32, [db] f32)."""
    cdt = compute_dtype
    with torch.no_grad():
        if freq_encoding is not None:
            x0 = encode(x.float(), freq_encoding).to(cdt)
        else:
            x0 = x.to(cdt)
        dx0, dws, dbs = mlp_bwd_walk_plain(x0, g, weights, biases, activation, out_activation,
                                           skip_connections, cdt)
        if freq_encoding is not None:
            dx = _encode_bwd(x.float(), dx0, freq_encoding)
        else:
            dx = dx0.to(cdt)
    return dx.to(x.dtype), dws, dbs


def mlp_bwd_walk_plain(
    x0: torch.Tensor,  # [N, enc_dim] the (encoded) input in the compute dtype
    g: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    activation: str = "relu",
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """The backward walk, layer by layer, with the rounding points of the
    TPU kernel's `_mlp_bwd_walk` (it is not autograd of `fused_mlp_plain`,
    which rounds elsewhere): g is rounded to the compute dtype; a sigmoid
    head multiplies by y (1 - y) of the f32 final pre-activation; hidden
    layers mask dh by post_act (compute dtype) > 0; db sums dh in f32
    before dh is rounded; the rounded dh feeds dW (f32 accumulation) and
    dh W^T; a skip layer's x0 columns and layer 0's go to dx0.
    Returns (dx0 f32, [dW] f32, [db] f32)."""
    skips = tuple(skip_connections)
    cdt = compute_dtype
    with torch.no_grad():
        n = len(weights)
        wc = [w.to(cdt).float() for w in weights]
        post, h, final_pre = [], x0, None
        for li, (w, b) in enumerate(zip(wc, biases)):
            inp = torch.cat([x0, h], dim=-1) if (li in skips and li != 0) else h
            pre = inp.float() @ w + b.to(cdt).float()
            if li == n - 1:
                final_pre = pre
            h = _apply_act(pre, activation if li < n - 1 else out_activation).to(cdt)
            post.append(h)

        dh = g.to(cdt).float()
        if out_activation == "sigmoid":
            y = torch.sigmoid(final_pre)
            dh = dh * y * (1.0 - y)
        enc_dim = x0.shape[-1]
        dx0 = torch.zeros(x0.shape, dtype=torch.float32, device=x0.device)
        dws, dbs = [None] * n, [None] * n
        for li in reversed(range(n)):
            if li < n - 1 and activation == "relu":
                dh = dh * (post[li].float() > 0.0)
            h_prev = x0 if li == 0 else post[li - 1]
            dbs[li] = dh.sum(dim=0)
            dhc = dh.to(cdt).float()
            skip = li in skips and li != 0
            x_in = torch.cat([x0, h_prev], dim=-1) if skip else h_prev
            dws[li] = x_in.float().t() @ dhc
            dh = dhc @ wc[li].t()
            if skip:
                dx0 = dx0 + dh[:, :enc_dim]
                dh = dh[:, enc_dim:]
            if li == 0:
                dx0 = dx0 + dh
    return dx0, dws, dbs


def _encode_bwd(x: torch.Tensor, d_enc: torch.Tensor, freq_encoding: FreqEncoding) -> torch.Tensor:
    """d_enc [N, enc_dim] -> dx [N, in_dim], in f32: d_pre = d_sin cos(pre)
    - d_cos sin(pre), summed over frequencies with the forward's table."""
    nf_total = x.shape[-1] * freq_encoding[0]
    f = frequencies(freq_encoding, x.device)
    pre = (x[..., :, None] * f).reshape(x.shape[0], -1)
    d_pre = d_enc[:, :nf_total] * torch.cos(pre) - d_enc[:, nf_total : 2 * nf_total] * torch.sin(pre)
    dx = d_pre.reshape(x.shape[0], x.shape[1], -1) @ f
    if freq_encoding[3]:
        dx = dx + d_enc[:, 2 * nf_total :]
    return dx


def fused_mlp_bwd(
    x: torch.Tensor,
    g: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    activation: str = "relu",
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    freq_encoding: Optional[FreqEncoding] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    packed: Optional[Packed] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """The backward of `fused_mlp`: (dx, [dW] f32, [db] f32). A CPU tensor
    runs `fused_mlp_bwd_plain`; a CUDA tensor launches the kernel (with
    `packed` from the forward when given) or raises."""
    skips = tuple(sorted(set(skip_connections)))
    if x.device.type == "cpu":
        return fused_mlp_bwd_plain(
            x, g, weights, biases, activation, out_activation, skips, freq_encoding, compute_dtype
        )
    _check_kernel_args(x, weights, biases, activation, out_activation, freq_encoding, compute_dtype)
    if packed is None or packed.weights_t is None:
        packed = prepare(x.shape[1], weights, biases, out_activation, skips, freq_encoding,
                         compute_dtype, transposed=True)
    dx, dw, db = launch_bwd(x.float().contiguous(), g.to(compute_dtype).contiguous(), packed)
    dws, dbs = unpack_grads(dw, db, packed.desc, packed.shapes)
    dx = dx if freq_encoding is not None else dx.to(compute_dtype)
    return dx.to(x.dtype), dws, dbs


class _FusedMLP(torch.autograd.Function):
    """fused_mlp as one autograd node: kernels on CUDA, plain versions on
    the CPU, in both directions. The forward keeps x and the packed weights
    (with their transposes when a gradient is wanted) for the backward."""

    @staticmethod
    def forward(ctx, x, spec, cache, *params):
        weights, biases = params[: len(params) // 2], params[len(params) // 2 :]
        activation, out_activation, skips, freq_encoding, compute_dtype = spec
        ctx.spec = spec
        ctx.packed = None
        ctx.save_for_backward(x, *params)
        if x.device.type == "cpu":
            return fused_mlp_plain(
                x, weights, biases, activation, out_activation, skips, freq_encoding, compute_dtype
            )
        ctx.packed = prepare(x.shape[1], weights, biases, out_activation, skips, freq_encoding,
                             compute_dtype, transposed=any(ctx.needs_input_grad), cache=cache)
        return launch(x, ctx.packed)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        weights, biases = params[: len(params) // 2], params[len(params) // 2 :]
        dx, dws, dbs = fused_mlp_bwd(x, g, weights, biases, *ctx.spec, packed=ctx.packed)
        dws = [dw.to(w.dtype) for dw, w in zip(dws, weights)]
        dbs = [db.reshape(b.shape).to(b.dtype) for db, b in zip(dbs, biases)]
        return (dx, None, None, *dws, *dbs)


def _check_kernel_args(x, weights, biases, activation, out_activation, freq_encoding, compute_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    if activation != "relu" or out_activation not in (None, "sigmoid"):
        raise ValueError("fused_mlp kernel: relu hidden layers and a none/sigmoid output only")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mlp kernel: compute dtype {compute_dtype} not supported")
    if x.dim() != 2:
        raise ValueError(f"fused_mlp kernel: x must be [N, in_dim], got {tuple(x.shape)}")
    if freq_encoding is not None and x.dtype != torch.float32:
        raise ValueError("fused_mlp kernel: with the in-kernel encoding x must be f32")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_mlp kernel: x dtype {x.dtype} not supported")
    if not 1 <= len(weights) <= MAX_LAYERS or len(weights) != len(biases):
        raise ValueError(f"fused_mlp kernel: 1..{MAX_LAYERS} layers with one bias each")
    for t in (*weights, *biases):
        if t.device != x.device:
            raise ValueError("fused_mlp kernel: parameters must be on the input's device")


def fused_mlp(
    x: torch.Tensor,  # [N, in_dim]; raw f32 coordinates when freq_encoding is set
    weights: Sequence[torch.Tensor],  # per layer [din, dout]
    biases: Sequence[torch.Tensor],  # per layer [dout]
    activation: str = "relu",
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    freq_encoding: Optional[FreqEncoding] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    pack_cache: Optional[PackCache] = None,
) -> torch.Tensor:
    """The whole MLP stack in one kernel, differentiable. Returns
    [N, out_dim] in the compute dtype. Skip layers (li in skip_connections,
    li != 0) take concat([x0, h]); with freq_encoding=(F, min_exp, max_exp,
    include_input) the NeRF encoding runs inside the kernel. A caller that
    runs the same weights repeatedly passes its own `pack_cache`."""
    skips = tuple(sorted(set(skip_connections)))
    spec = (activation, out_activation, skips, freq_encoding, compute_dtype)
    if x.device.type != "cpu":
        _check_kernel_args(x, weights, biases, activation, out_activation, freq_encoding, compute_dtype)
        x = x.float().contiguous()
    return _FusedMLP.apply(x, spec, pack_cache, *weights, *biases)


# Kernel launches since the last reset; the CPU path does not count. The
# forward also counts its launches by path (FWD_PATHS).
fused_mlp.launches = 0
fused_mlp.path_launches = collections.Counter()
fused_mlp_bwd.launches = 0
