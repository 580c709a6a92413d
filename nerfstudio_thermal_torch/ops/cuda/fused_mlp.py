"""Fused-MLP forward: a hand-written Hopper kernel and its plain PyTorch version.

Counterpart of nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:fused_mlp
(forward only; the TPU kernel body is `_fwd_kernel`). The CUDA source is
nerfstudio_thermal_torch/csrc/fused_mlp_fwd.cu; its header says what bounds
the kernel and what the first design gives up.

`fused_mlp` dispatches on the device of its input: a CPU tensor goes to
`fused_mlp_plain`, a CUDA tensor to the kernel, which is built with nvcc on
first use into build/kernels/ and loaded with ctypes. There is no fallback
from one to the other: a CUDA tensor launches the kernel or raises.

Numerics (both versions): the frequency table is 2*pi*exp2(e_k) in f32;
pre = x_d * f_k is one product; the encoding [sin(pre), cos(pre), x] is
rounded to the compute dtype. Each layer adds its bias (rounded to the
compute dtype) to an f32 accumulator, applies relu (or the output
activation) in f32 and rounds to the compute dtype.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCE = _PKG_DIR / "csrc" / "fused_mlp_fwd.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
MAX_LAYERS = 16
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

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
# Build and load
# --------------------------------------------------------------------------

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the fused-MLP kernel cannot be built")


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfused_mlp_fwd-{digest}.so"


def build() -> Tuple[Path, float, str]:
    """Compile the kernel if its library is missing. Returns (path, seconds
    spent compiling, compiler output)."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_mlp_fwd.argtypes = [p, p, p, p, p, i, ctypes.POINTER(i), i, i, i, p]
        lib.fused_mlp_fwd.restype = i
        _lib = lib
    return _lib


# --------------------------------------------------------------------------
# Weight packing (shapes, padding and layout the kernel reads)
# --------------------------------------------------------------------------


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


def pack(
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    skips: Sequence[int],
    enc_dim: int,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, List[int], int, int]:
    """Pad every layer to multiples of 16 (zero weight rows and columns),
    lay skip layers out as [x0 rows | pad | h rows | pad], and pack.

    Returns (weights, biases, per-layer desc ints, in_pad, hid_pad)."""
    in_pad = _round_up(enc_dim, 16)
    device = weights[0].device
    packed_w, packed_b, desc = [], [], []
    w_off = b_off = 0
    prev = enc_dim
    hid_pad = 16
    for li, (w, b) in enumerate(zip(weights, biases)):
        din, dout = w.shape
        skip = li in skips and li != 0
        n_pad = _round_up(dout, 16)
        wc = w.to(compute_dtype)
        if li == 0:
            if din != enc_dim:
                raise ValueError(f"layer 0 takes {din} inputs, the input gives {enc_dim}")
            k_pad = in_pad
            rows = [(0, 0, din)]
        elif skip:
            if din != enc_dim + prev:
                raise ValueError(f"skip layer {li} takes {din} inputs, expected {enc_dim + prev}")
            k_pad = in_pad + _round_up(prev, 16)
            rows = [(0, 0, enc_dim), (enc_dim, in_pad, prev)]
        else:
            if din != prev:
                raise ValueError(f"layer {li} takes {din} inputs, the previous layer gives {prev}")
            k_pad = _round_up(prev, 16)
            rows = [(0, 0, din)]
        wp = torch.zeros(k_pad, n_pad, dtype=compute_dtype, device=device)
        for src, dst, cnt in rows:
            wp[dst : dst + cnt, :dout] = wc[src : src + cnt]
        if compute_dtype == torch.bfloat16:
            wp = wp.reshape(-1)[_fragment_index(k_pad, n_pad, device)]
        packed_w.append(wp.reshape(-1))
        bp = torch.zeros(n_pad, dtype=torch.float32, device=device)
        bp[:dout] = b.to(compute_dtype).float()
        packed_b.append(bp)
        desc += [k_pad, n_pad, int(skip), w_off, b_off]
        w_off += k_pad * n_pad
        b_off += n_pad
        if li < len(weights) - 1:
            hid_pad = max(hid_pad, n_pad)
        prev = dout
    return torch.cat(packed_w), torch.cat(packed_b), desc, in_pad, hid_pad


def smem_bytes(in_pad: int, hid_pad: int, compute_dtype: torch.dtype) -> int:
    if compute_dtype == torch.bfloat16:
        return 128 * (in_pad + 8) * 2 + 2 * 128 * (hid_pad + 8) * 2
    return 64 * (in_pad + 1) * 4 + 2 * 64 * (hid_pad + 1) * 4


# --------------------------------------------------------------------------
# Wrapper
# --------------------------------------------------------------------------


@dataclass
class Packed:
    """Weights, biases and descriptor of one MLP, in the kernel's layout."""

    weights: torch.Tensor
    biases: torch.Tensor
    freqs: torch.Tensor  # encoding frequencies (unused without encoding)
    desc: List[int]
    out_dim: int
    compute_dtype: torch.dtype


def prepare(
    in_dim: int,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    out_activation: Optional[str],
    skips: Sequence[int],
    freq_encoding: Optional[FreqEncoding],
    compute_dtype: torch.dtype,
) -> Packed:
    """Pack an MLP for `launch` and check that it fits the kernel."""
    enc_dim = encoding_dim(in_dim, freq_encoding)
    w, b, layer_desc, in_pad, hid_pad = pack(weights, biases, skips, enc_dim, compute_dtype)
    if smem_bytes(in_pad, hid_pad, compute_dtype) > SMEM_LIMIT:
        raise ValueError(
            f"fused_mlp: widths (input {in_pad}, hidden {hid_pad}) exceed the "
            "kernel's shared memory"
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
    return Packed(w, b, freqs, header + layer_desc, out_dim, compute_dtype)


def launch(x: torch.Tensor, packed: Packed) -> torch.Tensor:
    """One kernel launch on the current stream: x [N, in_dim] f32 CUDA,
    contiguous -> [N, out_dim] in the compute dtype."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("fused_mlp kernel: x must be a contiguous [N, in_dim] f32 CUDA tensor")
    if x.shape[1] != packed.desc[1]:
        raise ValueError(f"fused_mlp kernel: x has {x.shape[1]} columns, the MLP takes {packed.desc[1]}")
    n = x.shape[0]
    out = torch.empty(n, packed.out_dim, dtype=packed.compute_dtype, device=x.device)
    if n == 0:
        return out
    desc = (ctypes.c_int * len(packed.desc))(*packed.desc)
    err = load_library().fused_mlp_fwd(
        x.data_ptr(), packed.weights.data_ptr(), packed.biases.data_ptr(), packed.freqs.data_ptr(),
        out.data_ptr(), n, desc, len(packed.desc), int(packed.compute_dtype == torch.bfloat16),
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd kernel launch failed: cudaError {err}")
    fused_mlp.launches += 1
    return out


class _FusedMLPForward(torch.autograd.Function):
    """The kernel as an autograd node. Eval needs no gradient; the backward
    kernels (the TPU's _bwd_kernel / _bwd_saved_kernel) come with the
    training slice, and until then a backward raises."""

    @staticmethod
    def forward(ctx, x, spec, *params):
        weights, biases = params[: len(params) // 2], params[len(params) // 2 :]
        out_activation, skips, freq_encoding, compute_dtype = spec
        packed = prepare(x.shape[1], weights, biases, out_activation, skips, freq_encoding, compute_dtype)
        return launch(x, packed)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "fused_mlp backward on CUDA arrives with the training slice of the port"
        )


def fused_mlp(
    x: torch.Tensor,  # [N, in_dim]; raw f32 coordinates when freq_encoding is set
    weights: Sequence[torch.Tensor],  # per layer [din, dout]
    biases: Sequence[torch.Tensor],  # per layer [dout]
    activation: str = "relu",
    out_activation: Optional[str] = None,
    skip_connections: Sequence[int] = (),
    freq_encoding: Optional[FreqEncoding] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The whole MLP stack in one kernel. Returns [N, out_dim] in the
    compute dtype. Skip layers (li in skip_connections, li != 0) take
    concat([x0, h]); with freq_encoding=(F, min_exp, max_exp,
    include_input) the NeRF encoding runs inside the kernel."""
    skips = tuple(sorted(set(skip_connections)))
    if x.device.type == "cpu":
        return fused_mlp_plain(
            x, weights, biases, activation, out_activation, skips, freq_encoding, compute_dtype
        )
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
    x = x.float().contiguous()
    spec = (out_activation, skips, freq_encoding, compute_dtype)
    return _FusedMLPForward.apply(x, spec, *weights, *biases)


# Kernel launches since the last reset; the CPU path does not count.
fused_mlp.launches = 0
