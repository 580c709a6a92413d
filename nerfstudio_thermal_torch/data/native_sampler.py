"""The native (C++) batch sampler (counterpart of
nerfstudio_thermal_tpu/data/native_sampler.py).

nerfstudio_thermal_torch/native/batch_sampler.cpp is a byte-identical copy
of the JAX package's source: patch-aligned pixel sampling and the GT
gather of one step, multithreaded, behind a plain C interface. At first
use it is compiled with g++ into build/native/ (keyed by a hash of the
source and the flags; the JAX package's own Makefile and tree are never
touched) and loaded with ctypes. As in the JAX package, the data manager
falls back to the Python PixelSampler when the library cannot be built or
loaded.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parents[1] / "native" / "batch_sampler.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
_lib = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libbatch_sampler-{digest}.so"


def build() -> Path:
    """Compile the library if it is missing (into a temporary name, then
    renamed, so concurrent builds never load a partial file)."""
    path = library_path()
    if not path.exists():
        compiler = shutil.which(os.environ.get("CXX", "g++"))
        if compiler is None:
            raise RuntimeError("no C++ compiler to build the native batch sampler")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([compiler, *_FLAGS, "-o", str(tmp), str(_SOURCE)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, path)
    return path


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
        assert lib.native_sampler_abi_version() == 1
        lib.sample_batch.restype = ctypes.c_int
        lib.sample_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),  # images
            ctypes.POINTER(ctypes.c_int32),   # heights
            ctypes.POINTER(ctypes.c_int32),   # widths
            ctypes.c_int32,                   # channels
            ctypes.POINTER(ctypes.c_float),   # is_thermal
            ctypes.c_int32,                   # n_images
            ctypes.c_uint64,                  # seed
            ctypes.c_int32,                   # num_rays
            ctypes.c_int32,                   # patch
            ctypes.c_int32,                   # num_threads
            ctypes.POINTER(ctypes.c_int32),   # ray_indices out
            ctypes.POINTER(ctypes.c_float),   # image out
            ctypes.POINTER(ctypes.c_float),   # thermal out
        ]
        _lib = lib
    except Exception:
        _load_failed = True
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


class NativeBatchSampler:
    """The C++ sampler over a fully cached image set with one channel
    count: the batches of the JAX package's NativeBatchSampler."""

    def __init__(self, images, is_thermal, patch_size: int = 1, seed: int = 0, num_threads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native batch sampler unavailable (no C++ compiler, or the build failed)")
        self._lib = lib
        # contiguous float32 copies stay alive for the pointer table
        self._images = [np.ascontiguousarray(im, np.float32) for im in images]
        channels = {im.shape[-1] for im in self._images}
        if len(channels) != 1:
            raise ValueError("all images must share a channel count")
        self.channels = channels.pop()
        n = len(self._images)
        self._ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data_as(ctypes.c_void_p).value for im in self._images])
        self._heights = np.asarray([im.shape[0] for im in self._images], np.int32)
        self._widths = np.asarray([im.shape[1] for im in self._images], np.int32)
        self._thermal = np.asarray(is_thermal, np.float32)
        if len(self._thermal) != n:
            raise ValueError("one is_thermal flag per image expected")
        self.patch = int(patch_size)
        self.seed = int(seed)
        self.num_threads = int(num_threads)
        self._step = 0

    def sample(self, num_rays: int, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """{"ray_indices": [R, 3] int32, "image": [R, C] f32, "is_thermal":
        [R] f32}; the draw is a pure function of (seed, step), seeded
        seed + step * 1000003 as in the JAX package."""
        eff_step = int(step) if step is not None else self._step
        unit = self.patch * self.patch
        num_rays = (num_rays // unit) * unit
        ray_indices = np.empty((num_rays, 3), np.int32)
        image_out = np.empty((num_rays, self.channels), np.float32)
        thermal_out = np.empty((num_rays,), np.float32)
        rc = self._lib.sample_batch(
            self._ptrs,
            self._heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.channels,
            self._thermal.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(self._images),
            ctypes.c_uint64(self.seed + eff_step * 1000003),
            num_rays,
            self.patch,
            self.num_threads,
            ray_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            image_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            thermal_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise RuntimeError(f"native sample_batch failed rc={rc}")
        self._step = eff_step + 1
        return {"ray_indices": ray_indices, "image": image_out, "is_thermal": thermal_out}
