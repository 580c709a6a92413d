"""The port's native (C++) batch sampler against the JAX package's.

The port builds its byte-identical copy of native/batch_sampler.cpp into
build/native/; the JAX package's NativeBatchSampler is driven through the
same library (its module's `_lib` set to the port's), so nothing of the
JAX tree is built or written. Batches are compared exactly: the draw is a
pure function of (seed, step), seeded seed + step * 1000003 on both sides.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import nerfstudio_thermal_tpu
from nerfstudio_thermal_tpu.data import native_sampler as jax_native

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.data import native_sampler
from nerfstudio_thermal_torch.data.pixel_samplers import PixelSampler, PixelSamplerConfig
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_render import tiny

torch.set_num_threads(1)

JAX_TREE = Path(nerfstudio_thermal_tpu.__file__).resolve().parent
STEPS = (0, 1, 7, 29, 123457)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("scene"), num_pairs=4)


def _trainer(scene, tmp_path, native=True):
    method = get_method_config("thermal-nerfacto-tpu")
    tiny(method.model, "float32")
    method.data = scene
    method.datamanager.train_num_rays_per_batch = 64
    method.datamanager.use_native_sampler = native
    return setup_trainer(method, base_dir=tmp_path, device="cpu")


def test_the_source_is_a_copy_of_the_jax_packages():
    assert native_sampler._SOURCE.read_bytes() == (JAX_TREE / "native" / "batch_sampler.cpp").read_bytes()
    assert native_sampler.library_path().parent.parts[-2:] == ("build", "native")


def test_batches_match_jax_native_sampler(scene, tmp_path, monkeypatch):
    """The default data manager samples through the native sampler, and its
    batches equal the JAX package's NativeBatchSampler's on the same images,
    seed and steps."""
    assert native_sampler.native_available()
    monkeypatch.setattr(jax_native, "_lib", native_sampler._load())
    # the JAX wrapper loads nothing itself (no make, no library of its tree)
    assert jax_native._load() is native_sampler._load()
    trainer = _trainer(scene, tmp_path)
    dm = trainer.datamanager
    assert dm.config.use_native_sampler and dm.uses_native_sampler
    images = [dm.train_dataset.get_image(i) for i in range(len(dm.train_dataset))]
    want = jax_native.NativeBatchSampler(images, dm.train_dataset.is_thermal, patch_size=2, seed=0)
    assert want._lib is native_sampler._load()
    for step in STEPS:
        got, ref = dm.next_train(step), want.sample(64, step=step)
        assert set(got) == set(ref) == {"ray_indices", "image", "is_thermal"}
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{k} at step {step}")


def test_python_sampler_without_the_library(scene, tmp_path, monkeypatch):
    """As in the JAX package: when the library cannot be built or loaded,
    or use_native_sampler is off, the Python PixelSampler gives the
    batches."""
    monkeypatch.setattr(native_sampler, "_lib", None)
    monkeypatch.setattr(native_sampler, "_load_failed", True)
    for native in (True, False):
        dm = _trainer(scene, tmp_path / str(native), native).datamanager
        assert not dm.uses_native_sampler
        ref = PixelSampler(PixelSamplerConfig(64, 2), dm.train_dataset, seed=0)
        for step in STEPS[:3]:
            got, want = dm.next_train(step), ref.sample(step=step)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_the_build_is_atomic(tmp_path, monkeypatch):
    """A build writes a temporary file and renames it, so workers that
    build at the same time never load a partial library."""
    monkeypatch.setattr(native_sampler, "_BUILD_DIR", tmp_path / "native")
    path = native_sampler.build()
    assert path.exists() and path.parent == tmp_path / "native"
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    mtime = path.stat().st_mtime_ns
    assert native_sampler.build() == path and path.stat().st_mtime_ns == mtime  # built once
    assert os.access(path, os.R_OK)
