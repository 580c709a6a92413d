"""Build and load the port's CUDA kernels.

Each source under nerfstudio_thermal_torch/csrc/ is compiled by nvcc for
sm_90a into a shared library with a plain C interface, at first use, into
build/kernels/ (keyed by a hash of the source, of every file it includes
from csrc/, and of the flags), and loaded with ctypes. The kernel wrappers
(fused_mlp.py, fused_ray.py, hash_encoding.py) bind their functions'
argument types through `load`.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
SOURCES = {
    "fused_mlp_fwd": _PKG_DIR / "csrc" / "fused_mlp_fwd.cu",
    "fused_mlp_bwd": _PKG_DIR / "csrc" / "fused_mlp_bwd.cu",
    "hash_encoding": _PKG_DIR / "csrc" / "hash_encoding.cu",
    "fused_ray_fwd": _PKG_DIR / "csrc" / "fused_ray_fwd.cu",
    "fused_ray_bwd": _PKG_DIR / "csrc" / "fused_ray_bwd.cu",
}
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> List[Path]:
    """The source and every file it includes with #include "...", found
    next to the including file, recursively, each once."""
    files, todo = [], [source.resolve()]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / name.decode()).resolve())
    return files


def library_path(name: str) -> Path:
    source = SOURCES[name]
    digest = hashlib.sha1()
    for path in source_files(source):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Tuple[Path, float, str]]:
    """Compile the kernels whose libraries are missing, one nvcc per source,
    all started together. Returns {name: (path, seconds spent compiling,
    compiler output)}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result, running = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            result[name] = (path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, time.perf_counter())
    failures = []
    for name, (proc, tmp, path, t0) in running.items():
        output, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {SOURCES[name].name} ({proc.returncode}):\n{output}")
            continue
        os.replace(tmp, path)
        result[name] = (path, seconds, output)
    if failures:
        raise RuntimeError("\n".join(failures))
    return result


def device_and_stream(t: torch.Tensor) -> Tuple[int, int]:
    """The device index of a CUDA tensor and the handle of torch's current
    stream there, as the kernels' C functions take them."""
    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(t.device).cuda_stream


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (at first use) and load one kernel's shared library; `bind`
    sets the argument and result types of its functions."""
    if name not in _libs:
        path, _, _ = build([name])[name]
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _libs[name] = lib
    return _libs[name]
