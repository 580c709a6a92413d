"""The slice on the CPU: a tiny thermal-nerfacto (tests/test_torch_hash_slice.py's
`tiny_hash`) trains three steps on a scene of 24-bit BMP RGB frames and
16-bit grey TIFF thermal frames (half of them Deflate), written by
chip_smoke.py's writers as phase 23 writes them on the card, its batches drawn through the port's PrefetchingDataManager and its
images decoded by the port, against the JAX package's steps on the same
scene (loaded through Pillow) from the same params and jitter draws.

Each step's batch equals the JAX sampler's bitwise (the decoders and the
prefetch stream both exact). Losses and metrics hold to rel 1e-4 and every
group's gradient to rel L2 1e-3, the f32 tolerances of
tests/test_torch_hash_slice.py, at each of the three steps (the JAX
gradient from its Adam moments: mu_t = 0.9 mu_(t-1) + 0.1 g_t)."""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from nerfstudio_thermal_torch.configs.method_configs import get_method_config, setup_trainer
from nerfstudio_thermal_torch.data.datamanagers import PrefetchingDataManager
from nerfstudio_thermal_torch.utils.jax_params import export_jax_tree, load_jax_params
from chip_smoke import bmp24_bytes, tiff_bytes
from tests.fixtures import make_synthetic_rgbt_dataset
from tests.test_torch_hash_slice import METHOD, tiny_hash
from tests.test_torch_train import GRAD_TOL, LOSS_TOL, JaxSide, _method, adam_state, flat, rel_l2

torch.set_num_threads(1)

STEPS = 3


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = make_synthetic_rgbt_dataset(tmp_path_factory.mktemp("tiff_bmp"), num_pairs=4)
    meta = json.loads((root / "transforms.json").read_text())
    for i, frame in enumerate(meta["frames"]):
        png = root / frame["file_path"]
        arr = np.asarray(Image.open(png))
        if frame["is_thermal"]:
            new = png.with_suffix(".tif")
            new.write_bytes(tiff_bytes(arr[..., 0].astype(np.uint16) * 257 + (i % 3), deflate=i % 2 == 1))
        else:
            new = png.with_suffix(".bmp")
            new.write_bytes(bmp24_bytes(arr))
        png.unlink()
        frame["file_path"] = new.relative_to(root).as_posix()
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def test_scene_is_bmp_and_tiff(scene):
    frames = json.loads((scene / "transforms.json").read_text())["frames"]
    kinds = {(f["is_thermal"], (scene / f["file_path"]).read_bytes()[:2]) for f in frames}
    assert kinds == {(0, b"BM"), (1, b"II")}
    thermal = [np.asarray(Image.open(scene / f["file_path"])) for f in frames if f["is_thermal"]]
    assert all(t.dtype == np.uint16 for t in thermal)


def test_three_steps_through_prefetch_match_jax(scene, tmp_path):
    js = JaxSide(scene, "float32", METHOD, tiny_hash)
    state = js.state()
    method = _method(get_method_config, "float32", scene, METHOD, tiny_hash)
    trainer = setup_trainer(method, base_dir=tmp_path, device="cpu", datamanager_cls=PrefetchingDataManager)
    load_jax_params(trainer.model, jax.tree.map(np.asarray, js.params))
    trainer.setup()
    dm = trainer.datamanager
    assert isinstance(dm, PrefetchingDataManager) and not dm.uses_native_sampler
    try:
        mu_prev = None
        for step in range(STEPS):
            want_batch = js.batch(step)
            batch = dm.next_train(step)
            assert set(batch) == set(want_batch)
            for k in batch:
                assert batch[k].dtype == want_batch[k].dtype, k
                np.testing.assert_array_equal(batch[k], want_batch[k], err_msg=k)
            uniforms = js.uniforms(state.rng)
            new_state, want = js.step_fn(state, want_batch)
            got = trainer._train_step(trainer.state, {k: torch.as_tensor(v) for k, v in batch.items()},
                                      uniforms=uniforms)
            assert set(got) == set(want)
            for k, w in want.items():
                w = float(w)
                assert np.isfinite(float(got[k])), (step, k)
                assert abs(float(got[k]) - w) <= LOSS_TOL["float32"] * max(abs(w), 1e-3), (step, k, float(got[k]), w)
            grads = flat(export_jax_tree(trainer.model, grads=True))
            mu_now = {}
            for group in js.params:
                count, mu, _ = adam_state(new_state.opt_state, group)
                assert count == step + 1 == trainer.optimizers.groups[group].count
                mu_now[group] = flat({group: jax.tree.map(np.asarray, mu)})
                keys = sorted(mu_now[group])
                prev = mu_prev[group] if mu_prev else {k: np.zeros_like(v) for k, v in mu_now[group].items()}
                want_g = np.concatenate([((mu_now[group][k] - 0.9 * prev[k]) / 0.1).ravel() for k in keys])
                got_g = np.concatenate([grads[k].ravel() for k in keys])
                assert np.isfinite(got_g).all(), (step, group)
                assert rel_l2(got_g, want_g) <= GRAD_TOL["float32"], (step, group, rel_l2(got_g, want_g))
            mu_prev = mu_now
            state = new_state
    finally:
        dm.close()
