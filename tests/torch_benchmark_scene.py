"""A tiny Blender scene and a tiny nerfacto for ns-benchmark's tests (CPU
and card). Imports no JAX.

`write_blender_scene` writes one scene in the Blender layout
(transforms_{train,val,test}.json, train/r_i.png) from a numpy seed: RGB
frames of 32 x 32, the least LPIPS's VGG takes with room (ns-eval scores
LPIPS). `tiny_nerfacto` cuts nerfacto's widths, grids and samples for a
few-second run; `patched_method_config` makes ns-train build it.
"""

import contextlib
import json
from pathlib import Path

import numpy as np

SIZE = 32


def write_blender_scene(root: Path, frames: int = 2, size: int = SIZE, seed: int = 0) -> Path:
    from nerfstudio_thermal_torch.utils.writer import write_png

    gen = np.random.default_rng(seed)
    (root / "train").mkdir(parents=True, exist_ok=True)
    records = []
    for i in range(frames):
        eye = np.array([4.0 * np.cos(2.0 * i), 4.0 * np.sin(2.0 * i), 1.0])
        forward = -eye / np.linalg.norm(eye)
        right = np.cross(forward, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, forward), -forward, eye
        write_png(root / "train" / f"r_{i}.png", gen.integers(0, 256, (size, size, 3), dtype=np.uint8))
        records.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    for split in ("train", "val", "test"):
        (root / f"transforms_{split}.json").write_text(json.dumps({"camera_angle_x": 0.69, "frames": records}))
    return root


def tiny_nerfacto(config):
    m = config.model
    m.num_levels, m.base_res, m.max_res, m.log2_hashmap_size = 3, 4, 32, 9
    m.hidden_dim = m.hidden_dim_color = 16
    m.appearance_embed_dim = 4
    m.num_proposal_samples_per_ray, m.num_nerf_samples_per_ray = (8, 6), 4
    m.eval_num_rays_per_chunk = 256
    m.compute_dtype = "float32"
    m.proposal_net_args_list = [
        {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 16, "use_linear": False},
        {"hidden_dim": 8, "log2_hashmap_size": 8, "num_levels": 2, "max_res": 32, "use_linear": False},
    ]
    config.datamanager.train_num_rays_per_batch = config.datamanager.eval_num_rays_per_batch = 64
    return config


@contextlib.contextmanager
def patched_method_config():
    """While open, ns-train builds the tiny nerfacto for `nerfacto`."""
    from nerfstudio_thermal_torch.configs import method_configs
    from nerfstudio_thermal_torch.scripts import train

    original = train.get_method_config
    train.get_method_config = lambda name: tiny_nerfacto(method_configs.get_method_config(name))
    try:
        yield
    finally:
        train.get_method_config = original
