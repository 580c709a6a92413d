"""ns-render: render a trained run along a camera path or the eval cameras
(counterpart of nerfstudio_thermal_tpu/scripts/render.py).

    python -m nerfstudio_thermal_torch.scripts.render camera-path --load-config RUN/config.yml \
        --camera-path-filename PATH.json [--output-path renders/output.mp4] \
        [--rendered-output-names rgb rgb_thermal depth removal removal_thermal] \
        [--removal-min-density-diff 0.05] [--fps 24]
    ... interpolated [--interpolation-steps 10] [--rgb-poses-only true]
    ... spiral
    ... dataset

Renders on the card. The modes: `camera-path` reads a JSON with
render_height, render_width and camera_path[] (camera_to_world, 16
numbers, and fov in degrees); `interpolated` passes through the eval
cameras (the RGB ones only with --rgb-poses-only); `spiral` circles the
first eval camera in 30 steps; `dataset` renders every eval camera.
--rendered-output-names picks the model's outputs: the paper's "removal"
and "removal_thermal" keep only the matter both spectra agree on
(--removal-min-density-diff sets their threshold). Depth outputs are
colour-mapped with their modality's accumulation, one-channel outputs
shown grey, per-sample outputs (e.g. "density") as their per-pixel mean.
One output goes to --output-path; several to <stem>_<name><suffix> beside
it (dataset mode: <output-path>/<name>/). A .mp4 / .gif path is encoded
with imageio where it and its encoder exist; otherwise the frames are
written as PNGs (00000.png, ...) into the path without its suffix.
"""

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from nerfstudio_thermal_torch.cameras import camera_paths
from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType
from nerfstudio_thermal_torch.utils import colormaps
from nerfstudio_thermal_torch.utils.precision import pin_precision
from nerfstudio_thermal_torch.utils.writer import write_png

SPIRAL_STEPS = 30
USAGE = (
    "usage: ns-render {camera-path|interpolated|spiral|dataset} "
    "--load-config CONFIG.yml [--output-path PATH] "
    "[--rendered-output-names rgb rgb_thermal depth removal ...] "
    "[--camera-path-filename PATH.json] [--interpolation-steps N] "
    "[--rgb-poses-only true] [--removal-min-density-diff X] [--fps N]"
)


def to_uint8(frame: np.ndarray) -> np.ndarray:
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def _save_frames(frames: List[np.ndarray], output_path: Path, fps: float = 24.0) -> None:
    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_path.suffix in (".mp4", ".gif"):
        try:
            # imageio is optional: the card's machine may not have it, and
            # the frames are then written as PNGs
            import imageio

            imageio.mimsave(output_path, [to_uint8(f) for f in frames], fps=fps)
            print(f"wrote {output_path}")
            return
        except Exception as e:
            print(f"video encode unavailable ({e}); writing frames instead")
            output_path = output_path.with_suffix("")
    output_path.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        write_png(output_path / f"{i:05d}.png", to_uint8(f))
    print(f"wrote {len(frames)} frames to {output_path}")


def _render_trajectory(
    trainer, cameras: Cameras, output_names: List[str], removal_min_density_diff: Optional[float] = None
) -> Dict[str, List[np.ndarray]]:
    """One full render per camera; {output name: [h, w, 3] frames in [0, 1]}."""
    model = trainer.pipeline.model
    if removal_min_density_diff is not None and hasattr(model.config, "removal_min_density_diff"):
        model.config.removal_min_density_diff = removal_min_density_diff
    results = {name: [] for name in output_names}
    # depth colormaps also need the matching accumulation
    needed = set(output_names)
    for name in output_names:
        if name.startswith("depth"):
            needed.add("accumulation_thermal" if name.endswith("_thermal") else "accumulation")
    include_per_sample = False
    n = len(cameras)
    for i in range(n):
        dev = model.render_camera_device(cameras, i, include_per_sample=include_per_sample)
        if not include_per_sample and not needed.issubset(dev):
            # a requested output (e.g. "density") is per-sample, which the
            # render drops unless asked: render again with them
            include_per_sample = True
            dev = model.render_camera_device(cameras, i, include_per_sample=True)
        h, w = int(cameras.height[i]), int(cameras.width[i])
        # per-ray [h * w, C] -> [h, w, C]; per-sample [h * w, S, 1] -> [h, w, S]
        outputs = {k: v.float().cpu().numpy().reshape(h, w, -1) for k, v in dev.items() if k in needed}
        for name in output_names:
            if name not in outputs:
                raise KeyError(f"output '{name}' not produced by the model; available: {sorted(dev)}")
            img = outputs[name]
            if name.startswith("depth"):
                suffix = "_thermal" if name.endswith("_thermal") else ""
                img = colormaps.apply_depth_colormap(img, accumulation=outputs.get(f"accumulation{suffix}"))
            elif img.shape[-1] == 1:
                img = np.repeat(np.clip(img, 0, 1), 3, axis=-1)
            elif img.shape[-1] not in (3, 4):
                # a per-sample output has no image form: its per-pixel mean
                img = np.clip(img.mean(axis=-1, keepdims=True), 0, 1).repeat(3, axis=-1)
            results[name].append(np.asarray(img))
        print(f"rendered {i + 1}/{n}", end="\r", flush=True)
    print()
    return results


def camera_path_cameras(path_json: dict) -> Cameras:
    """The cameras of a camera-path JSON: one perspective camera per entry,
    its focal length from the vertical fov (50 degrees by default)."""
    h, w = int(path_json["render_height"]), int(path_json["render_width"])
    poses, focals = [], []
    for cam in path_json["camera_path"]:
        poses.append(np.asarray(cam["camera_to_world"], np.float32).reshape(4, 4)[:3])
        focals.append(h / (2 * np.tan(np.radians(float(cam.get("fov", 50.0))) / 2)))
    k = len(poses)
    return Cameras(
        camera_to_worlds=torch.as_tensor(np.stack(poses)),
        fx=torch.as_tensor(np.asarray(focals, np.float32)),
        fy=torch.as_tensor(np.asarray(focals, np.float32)),
        cx=torch.full((k,), w / 2, dtype=torch.float32),
        cy=torch.full((k,), h / 2, dtype=torch.float32),
        width=torch.full((k,), w, dtype=torch.int32),
        height=torch.full((k,), h, dtype=torch.int32),
        camera_type=torch.full((k,), CameraType.PERSPECTIVE.value, dtype=torch.int32),
    )


def _parse(args: List[str]):
    opts = {
        "load_config": None,
        "output_path": Path("renders/output.mp4"),
        "rendered_output_names": ["rgb"],
        "camera_path_filename": None,
        "interpolation_steps": 10,
        "rgb_poses_only": False,
        "removal_min_density_diff": None,
        "fps": 24.0,
    }
    i = 0
    while i < len(args):
        tok = args[i]
        key = tok.lstrip("-").replace("-", "_")
        if key == "rendered_output_names":
            names = []
            i += 1
            while i < len(args) and not args[i].startswith("--"):
                names.append(args[i])
                i += 1
            opts[key] = names
            continue
        if key not in opts or i + 1 >= len(args):
            print(f"error: unknown flag or missing value: {tok}", file=sys.stderr)
            return None
        val = args[i + 1]
        if key == "interpolation_steps":
            val = int(val)
        elif key in ("fps", "removal_min_density_diff"):
            val = float(val)
        elif key == "rgb_poses_only":
            val = val.lower() in ("1", "true", "yes")
        else:
            val = Path(val)
        opts[key] = val
        i += 2
    return opts


def main(argv: Optional[List[str]] = None, *, device: Union[str, torch.device] = "cuda") -> int:
    """`device` is the seam for tests, which pass "cpu"."""
    pin_precision()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    mode = argv[0]
    if mode not in ("camera-path", "interpolated", "spiral", "dataset"):
        print(f"error: unknown render mode '{mode}'", file=sys.stderr)
        return 2
    opts = _parse(argv[1:])
    if opts is None:
        return 2
    if opts["load_config"] is None:
        print("error: --load-config is required", file=sys.stderr)
        return 2
    if mode == "camera-path" and opts["camera_path_filename"] is None:
        print("error: --camera-path-filename is required", file=sys.stderr)
        return 2

    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    _, trainer = eval_setup(opts["load_config"], device=device)
    dm = trainer.datamanager
    names, diff, fps = opts["rendered_output_names"], opts["removal_min_density_diff"], opts["fps"]
    out = Path(opts["output_path"])
    if mode == "dataset":
        for name, frames in _render_trajectory(trainer, dm.eval_cameras, names, diff).items():
            _save_frames(frames, out / name, fps)
        return 0

    if mode == "interpolated":
        cams = dm.eval_cameras
        indices = np.nonzero(dm.eval_dataset.is_thermal == 0)[0] if opts["rgb_poses_only"] else None
        cameras = camera_paths.get_interpolated_camera_path(
            cams, steps=opts["interpolation_steps"] * max(len(cams) - 1, 1), indices=indices
        )
    elif mode == "spiral":
        c = dm.eval_cameras
        cameras = camera_paths.get_spiral_path(
            c.camera_to_worlds[0].cpu().numpy(), float(c.fx[0]), float(c.fy[0]), float(c.cx[0]), float(c.cy[0]),
            int(c.width[0]), int(c.height[0]), steps=SPIRAL_STEPS,
        )
    else:
        cameras = camera_path_cameras(json.loads(Path(opts["camera_path_filename"]).read_text()))

    results = _render_trajectory(trainer, cameras, names, diff)
    if len(results) == 1:
        _save_frames(next(iter(results.values())), out, fps)
    else:
        for name, frames in results.items():
            _save_frames(frames, out.parent / f"{out.stem}_{name}{out.suffix}", fps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
