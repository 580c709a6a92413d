"""The port's PrefetchingDataManager against its VanillaDataManager and the
JAX package's stream, its resume hook in the trainer, and the data
modules' small helpers against the JAX package.

The prefetching manager's batches are the stateless (seed, step) batches
of `VanillaDataManager.next_train`, bitwise: in order, after
`set_start_step` forward and backward (a rewind serves the asked step
inline and keeps the future batch), and after realignments in a row
while the worker is drawing (the race the generation tags close)."""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.configs.dataparser_configs import build_dataparser as jax_build_dataparser
from nerfstudio_thermal_tpu.data import datamanagers as jax_dm
from nerfstudio_thermal_tpu.data import datasets as jax_datasets
from nerfstudio_thermal_tpu.data.dataparsers.nerfstudio_dataparser import (
    ThermalNerfDataParserConfig as JaxParserConfig,
)
from nerfstudio_thermal_tpu.data.scene_box import SceneBox as JaxSceneBox

from nerfstudio_thermal_torch.configs.dataparser_configs import build_dataparser
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.data import datamanagers as dm
from nerfstudio_thermal_torch.data import datasets
from nerfstudio_thermal_torch.data.dataparsers.nerfstudio_dataparser import ThermalNerfDataParserConfig
from nerfstudio_thermal_torch.data.scene_box import SceneBox
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_hash_slice import tiny_hash

torch.set_num_threads(1)

RAYS = 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("prefetch") / "d")


def _config(native: bool):
    return dm.VanillaDataManagerConfig(train_num_rays_per_batch=RAYS, patch_size=2, use_native_sampler=native)


def _managers(scene, native: bool = False):
    parser = ThermalNerfDataParserConfig(data=scene, train_split_fraction=0.5)
    pre = dm.PrefetchingDataManager(_config(native), build_dataparser(parser))
    van = dm.VanillaDataManager(_config(native), build_dataparser(parser))
    assert pre.uses_native_sampler == van.uses_native_sampler == native
    return pre, van


def _jax_manager(scene):
    parser = JaxParserConfig(data=scene, train_split_fraction=0.5)
    return jax_dm.VanillaDataManager(
        jax_dm.VanillaDataManagerConfig(train_num_rays_per_batch=RAYS, patch_size=2, use_native_sampler=False),
        jax_build_dataparser(parser),
    )


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("native", [False, True], ids=["python_sampler", "native_sampler"])
def test_prefetch_matches_stateless_stream(scene, native):
    pre, van = _managers(scene, native)
    jax_van = _jax_manager(scene) if not native else None
    try:
        for step in range(6):
            a = pre.next_train(step)
            _same(a, van.next_train(step))
            if jax_van is not None:
                _same(a, jax_van.next_train(step))
    finally:
        pre.close()


@pytest.mark.parametrize("native", [False, True], ids=["python_sampler", "native_sampler"])
def test_prefetch_realigns_after_resume(scene, native):
    pre, van = _managers(scene, native)
    try:
        pre.next_train(0)
        pre.next_train(1)
        # a resume far ahead: served at once, not after replaying 2..9999
        pre.set_start_step(10_000)
        _same(pre.next_train(10_000), van.next_train(10_000))
        _same(pre.next_train(10_001), van.next_train(10_001))
        # a rewind (queued tags > step): the asked batch inline, the queued one kept
        pre.set_start_step(500)
        time.sleep(0.2)  # let the worker run ahead
        _same(pre.next_train(3), van.next_train(3))
        assert pre._lookahead is not None and pre._lookahead[1] == 500
        _same(pre.next_train(4), van.next_train(4))
        _same(pre.next_train(500), van.next_train(500))
        assert pre._lookahead is None
        _same(pre.next_train(501), van.next_train(501))
    finally:
        pre.close()


def test_prefetch_realign_hammer(scene):
    """Realignments in a row while the worker is mid-draw, with the
    interpreter switching threads every microsecond: every next_train
    returns the right stateless batch, against the JAX stream."""
    pre, _ = _managers(scene)
    jax_van = _jax_manager(scene)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for s in [7, 123, 45, 9000, 2, 777, 777, 0] * 3:
            pre.set_start_step(s)
            _same(pre.next_train(s), jax_van.next_train(s))
    finally:
        sys.setswitchinterval(interval)
        pre.close()


def test_prefetch_close_stops_the_worker(scene):
    pre, _ = _managers(scene)
    pre.next_train(0)
    pre.close()
    pre._thread.join(timeout=5.0)
    assert not pre._thread.is_alive()


def _tiny(scene, load_dir=None):
    method = get_method_config("thermal-nerfacto")
    tiny_hash(method.model, "float32")
    method.datamanager.train_num_rays_per_batch = 64
    method.dataparser.data = scene
    method.data = scene
    method.trainer.load_dir = load_dir
    return method


def test_trainer_resume_realigns_the_prefetch_stream(scene, tmp_path, monkeypatch):
    """A trainer reloaded from a checkpoint calls set_start_step, and its
    next batch is the stateless batch of the checkpoint's step; the resumed
    step is the uninterrupted run's, and the default data manager is still
    the vanilla one."""
    plain = setup_trainer(_tiny(scene), base_dir=tmp_path / "plain", device="cpu")
    assert type(plain.datamanager) is dm.VanillaDataManager
    first = setup_trainer(_tiny(scene), base_dir=tmp_path / "a", device="cpu",
                          datamanager_cls=dm.PrefetchingDataManager)
    first.setup()
    for step in range(3):
        first.train_iteration(step)
    path = first.save_checkpoint(3)
    want = first.train_iteration(3)
    first.datamanager.close()

    calls = []
    original = dm.PrefetchingDataManager.set_start_step

    def spy(self, step):
        calls.append(step)
        return original(self, step)

    monkeypatch.setattr(dm.PrefetchingDataManager, "set_start_step", spy)
    resumed = setup_trainer(_tiny(scene, path.parent), base_dir=tmp_path / "b", device="cpu",
                            datamanager_cls=dm.PrefetchingDataManager)
    try:
        time.sleep(0.1)  # the worker has queued steps 0, 1, ... before the load
        resumed.setup()
        assert calls == [3] and resumed._start_step == 3
        _same(resumed.datamanager.next_train(3), plain.datamanager.next_train(3))
        resumed.datamanager.set_start_step(3)
        got = resumed.train_iteration(3)
        assert set(got) == set(want)
        for k in want:
            assert float(got[k]) == float(want[k]), k
    finally:
        resumed.datamanager.close()


def test_small_helpers_match_jax(scene):
    """num_train_data, InputDataset.preload, the ThermalDataset alias and
    SceneBox.within, against the JAX package's."""
    parser = ThermalNerfDataParserConfig(data=scene, train_split_fraction=0.5)
    van = dm.VanillaDataManager(_config(False), build_dataparser(parser))
    assert van.num_train_data() == _jax_manager(scene).num_train_data() == len(van.train_dataset)
    gen = dm.RandomCamerasDataManager(dm.RandomCamerasDataManagerConfig())
    jax_gen = jax_dm.RandomCamerasDataManager(jax_dm.RandomCamerasDataManagerConfig())
    assert gen.num_train_data() == jax_gen.num_train_data() == 1

    assert datasets.ThermalDataset is datasets.InputDataset
    assert jax_datasets.ThermalDataset is jax_datasets.InputDataset
    port_ds = datasets.ThermalDataset(van.train_dataparser_outputs)
    jax_ds = jax_datasets.ThermalDataset(_jax_manager(scene).train_dataparser_outputs)
    port_ds.preload()
    jax_ds.preload()
    assert sorted(port_ds._cache) == sorted(jax_ds._cache) == list(range(len(port_ds)))
    for i in range(len(port_ds)):
        np.testing.assert_array_equal(port_ds._cache[i], jax_ds._cache[i])

    rng = np.random.default_rng(0)
    aabb = np.array([[-1.0, -0.5, -2.0], [1.0, 0.5, 2.0]], np.float32)
    pos = rng.uniform(-2.5, 2.5, (64, 5, 3)).astype(np.float32)
    pos[0, 0] = aabb[0]  # on the faces: outside (strict comparisons)
    pos[0, 1] = aabb[1]
    got = SceneBox(torch.as_tensor(aabb)).within(torch.as_tensor(pos))
    want = np.asarray(JaxSceneBox(jnp.asarray(aabb)).within(jnp.asarray(pos)))
    assert got.dtype == torch.bool and got.shape == want.shape == (64, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    jax.clear_caches()
