"""Build a host C++ source of nerfstudio_thermal_torch/native/ with g++
into build/native/ at first use (keyed by a hash of the source and the
flags), for loading with ctypes."""

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]


def library_path(source: Path, stem: str, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha1(Path(source).read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return Path(build_dir) / f"{stem}-{digest}.so"


def build_library(source: Path, stem: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library if it is missing (into a temporary name, then
    renamed, so concurrent builds never load a partial file)."""
    path = library_path(source, stem, build_dir)
    if not path.exists():
        compiler = shutil.which(os.environ.get("CXX", "g++"))
        if compiler is None:
            raise RuntimeError(f"no C++ compiler to build {Path(source).name}")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([compiler, *FLAGS, "-o", str(tmp), str(source)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, path)
    return path
