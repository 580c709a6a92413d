"""ns-export: export point clouds, meshes and cameras from a trained run
(counterpart of nerfstudio_thermal_tpu/scripts/exporter.py).

    python -m nerfstudio_thermal_torch.scripts.exporter MODE --load-config RUN/config.yml --output-dir DIR [...]

Reloads the run through `eval_setup` on the card and writes what the JAX
package's ns-export writes:
- `pointcloud`: point_cloud.ply, the eval cameras' expected depth
  backprojected where the accumulation exceeds --min-accumulation, in
  "rgb_thermal" colour with --use-thermal-color true;
- `tsdf`: tsdf_mesh.ply, the train cameras' renders fused into a TSDF
  volume on the card (exporter/tsdf_utils.py);
- `poisson`: poisson_mesh.ply, the eval point cloud with depth normals
  through an FFT Poisson solve on the card (exporter/poisson.py);
- `marching-cubes`: sdf_marching_cubes_mesh.ply, the isosurface of the
  model's `sdf_fn` at --isosurface-threshold (default 0), or of minus its
  `density_fn` at minus the threshold (default 15); a threshold that
  yields no faces falls back to the grid's median level;
- `texture`: that mesh baked into mesh.obj, mesh.mtl and texture.png;
- `cameras`: cameras.json, the train cameras' poses and intrinsics.
- `gaussian-splat`: splat.ply, a splatfacto model's alive gaussians in
  the 3DGS convention (Inria's channel-major `f_rest`), the rows with a
  non-finite value left out; the bytes the JAX package writes. Any other
  model prints the JAX package's error and returns 2.
The grids are evaluated and the images rendered on the card; marching
cubes and the file writes run on the host.
"""

import json
import sys
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from nerfstudio_thermal_torch.utils.precision import pin_precision

USAGE = (
    "usage: ns-export "
    "{pointcloud|tsdf|poisson|marching-cubes|texture|cameras} "
    "--load-config CONFIG.yml --output-dir DIR\n"
    "  pointcloud: [--num-points N] [--min-accumulation X] "
    "[--use-thermal-color true] [--stride K]\n"
    "  tsdf: [--resolution R] [--downscale-factor K] "
    "[--bounding-box-min x,y,z] [--bounding-box-max x,y,z]\n"
    "  poisson: [--resolution R] [--num-points N] "
    "[--min-accumulation X]\n"
    "  marching-cubes: [--resolution R] [--isosurface-threshold T] "
    "[--bounding-box-min x,y,z] [--bounding-box-max x,y,z]\n"
    "  texture: [--resolution R] [--px-per-uv-triangle P] "
    "[--isosurface-threshold T]"
)
MODES = ("pointcloud", "tsdf", "poisson", "marching-cubes", "texture", "cameras", "gaussian-splat")


def _parse(argv: List[str]) -> Optional[dict]:
    """The JAX package's flag parsing: `--flag value` or `--flag=value`."""
    opts = {
        "load_config": None,
        "output_dir": Path("exports"),
        "min_accumulation": 0.5,
        "use_thermal_color": False,
        "stride": 4,
        "resolution": None,
        "downscale_factor": 2,
        "isosurface_threshold": None,
        "num_points": None,
        "px_per_uv_triangle": 8,
        "bounding_box_min": (-1.0, -1.0, -1.0),
        "bounding_box_max": (1.0, 1.0, 1.0),
    }
    i = 0
    while i < len(argv):
        tok = argv[i]
        key = tok.lstrip("-").replace("-", "_")
        val = tok.split("=", 1)[1] if "=" in tok else argv[i + 1]
        i += 1 if "=" in tok else 2
        if "=" in tok:
            key = key.split("=")[0]
        if key in ("load_config", "output_dir"):
            opts[key] = Path(val)
        elif key in ("min_accumulation", "isosurface_threshold"):
            opts[key] = float(val)
        elif key in ("stride", "resolution", "downscale_factor", "num_points", "px_per_uv_triangle"):
            opts[key] = int(val)
        elif key == "use_thermal_color":
            opts[key] = val.lower() in ("1", "true", "yes")
        elif key in ("bounding_box_min", "bounding_box_max"):
            opts[key] = tuple(float(x) for x in val.split(","))
        else:
            print(f"error: unknown flag --{key}", file=sys.stderr)
            return None
    return opts


def camera_frames(cameras) -> list:
    """cameras.json's records: pose, intrinsics and size of each camera."""
    cams = cameras.to("cpu")
    return [
        {
            "camera_to_world": cams.camera_to_worlds[i].numpy().tolist(),
            "fx": float(cams.fx[i]),
            "fy": float(cams.fy[i]),
            "cx": float(cams.cx[i]),
            "cy": float(cams.cy[i]),
            "width": int(cams.width[i]),
            "height": int(cams.height[i]),
        }
        for i in range(len(cams))
    ]


def write_splat_ply(model, out: Path):
    """The 3DGS PLY of a splatfacto model: x y z nx ny nz f_dc_* f_rest_*
    opacity scale_* rot_* of the gaussians its `_host_alive` snapshot holds
    (every slot without one), rows with a non-finite value dropped.
    Returns (path, vertex count)."""
    p = {k: getattr(model, k).detach().float().cpu().numpy() for k in
         ("xyz", "features_dc", "features_rest", "opacities", "scales", "quats")}
    alive = model._host_alive.cpu().numpy() if model._host_alive is not None else np.ones(len(p["xyz"]), bool)
    pos = p["xyz"][alive]
    dc = p["features_dc"][alive]
    n = len(pos)
    # Inria's ordering: f_rest channel-major
    rest = p["features_rest"][alive].transpose(0, 2, 1).reshape(n, -1)
    cols = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}
    for a in "xyz":
        cols[f"n{a}"] = np.zeros(n, np.float32)
    for i in range(3):
        cols[f"f_dc_{i}"] = dc[:, i]
    for i in range(rest.shape[1]):
        cols[f"f_rest_{i}"] = rest[:, i]
    cols["opacity"] = p["opacities"][alive]
    for i in range(3):
        cols[f"scale_{i}"] = p["scales"][alive][:, i]
    for i in range(4):
        cols[f"rot_{i}"] = p["quats"][alive][:, i]
    finite = np.ones(n, bool)
    for v in cols.values():
        finite &= np.isfinite(v)
    count = int(finite.sum())
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {count}"]
    header += [f"property float {k}" for k in cols]
    header.append("end_header")
    data = np.empty(count, dtype=[(k, "<f4") for k in cols])
    for k, v in cols.items():
        data[k] = v[finite].astype(np.float32)
    with open(out, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(data.tobytes())
    return out, count


def field_callable(model):
    """(fn, default level, sign) for meshing: the SDF where the model has
    `sdf_fn`, else minus the density (inside < level). fn maps host points
    [N, 3] to host values [N], evaluated on the model's device."""
    if hasattr(model, "sdf_fn"):
        field, sign = model.sdf_fn, 1.0
    else:
        field, sign = model.density_fn, -1.0

    @torch.no_grad()
    def fn(pts: np.ndarray) -> np.ndarray:
        values = field(torch.as_tensor(pts, dtype=torch.float32, device=model.device))
        return sign * values.float().cpu().numpy().reshape(-1)

    return fn, sign


def mesh_field(model, opts: dict):
    """The marching-cubes mesh of mode marching-cubes / texture: (verts,
    faces, normals)."""
    from nerfstudio_thermal_torch.exporter.marching_cubes import (
        evaluate_sdf_grid,
        generate_mesh_with_multires_marching_cubes,
        marching_cubes,
    )

    fn, sign = field_callable(model)
    if sign > 0:
        level = opts["isosurface_threshold"] or 0.0
    else:
        level = -(opts["isosurface_threshold"] or 15.0)
    resolution = opts["resolution"] or 128
    verts, faces, normals = generate_mesh_with_multires_marching_cubes(
        fn, resolution=resolution, bounding_box_min=opts["bounding_box_min"],
        bounding_box_max=opts["bounding_box_max"], isosurface_threshold=level,
    )
    if len(faces) == 0:
        # the threshold missed the field's range: fall back to the median
        # level so that an isosurface exists
        grid, origin, spacing = evaluate_sdf_grid(fn, resolution, opts["bounding_box_min"], opts["bounding_box_max"])
        level = float(np.median(grid))
        print(f"threshold produced an empty mesh; retrying at the median field value {level:.4f}")
        verts, faces, normals = marching_cubes(
            grid, level=level, origin=origin, spacing=spacing, gradient_direction="ascent",
        )
    return verts, faces, normals


def main(argv: Optional[List[str]] = None, *, device: Union[str, torch.device] = "cuda") -> int:
    """`device` is the seam for tests, which pass "cpu"."""
    pin_precision()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0
    mode = argv[0]
    opts = _parse(argv[1:])
    if opts is None:
        return 2
    if opts["load_config"] is None:
        print("error: --load-config is required", file=sys.stderr)
        return 2
    if mode not in MODES:
        print(f"error: unknown export mode '{mode}'", file=sys.stderr)
        return 2

    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    _, trainer = eval_setup(opts["load_config"], device=device)
    dm, model = trainer.datamanager, trainer.pipeline.model
    if mode == "gaussian-splat":
        from nerfstudio_thermal_torch.models.splatfacto import SplatfactoModel

        if not isinstance(model, SplatfactoModel):
            print("error: 'gaussian-splat' export requires a splatfacto model", file=sys.stderr)
            return 2
    out_dir = Path(opts["output_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)

    if mode == "gaussian-splat":
        out, n = write_splat_ply(model, out_dir / "splat.ply")
        print(f"wrote {out} ({n} gaussians)")
        return 0

    if mode == "cameras":
        (out_dir / "cameras.json").write_text(json.dumps(camera_frames(dm.train_cameras), indent=2))
        print(f"wrote {out_dir / 'cameras.json'}")
        return 0

    if mode == "pointcloud":
        from nerfstudio_thermal_torch.exporter.exporter_utils import generate_point_cloud, write_ply

        points, colors = generate_point_cloud(
            model, dm.eval_cameras, min_accumulation=opts["min_accumulation"],
            use_thermal_color=opts["use_thermal_color"], stride=opts["stride"],
        )
        write_ply(out_dir / "point_cloud.ply", points, colors)
        print(f"wrote {len(points)} points to {out_dir / 'point_cloud.ply'}")
        return 0

    if mode == "tsdf":
        from nerfstudio_thermal_torch.exporter.tsdf_utils import export_tsdf_mesh

        out = export_tsdf_mesh(
            model, dm.train_cameras, out_dir, downscale_factor=opts["downscale_factor"],
            resolution=opts["resolution"] or 128, bounding_box_min=opts["bounding_box_min"],
            bounding_box_max=opts["bounding_box_max"],
        )
        print(f"wrote {out}")
        return 0

    if mode == "poisson":
        from nerfstudio_thermal_torch.exporter.poisson import export_poisson_mesh

        out = export_poisson_mesh(
            model, dm.eval_cameras, out_dir, num_points=opts["num_points"] or 500000,
            resolution=opts["resolution"] or 128, min_accumulation=opts["min_accumulation"], stride=opts["stride"],
        )
        print(f"wrote {out}")
        return 0

    # marching-cubes and texture
    verts, faces, normals = mesh_field(model, opts)
    if mode == "marching-cubes":
        from nerfstudio_thermal_torch.exporter.exporter_utils import write_ply_mesh

        out = out_dir / "sdf_marching_cubes_mesh.ply"
        write_ply_mesh(out, verts, faces, normals=normals)
        print(f"wrote {out} ({len(verts)} verts, {len(faces)} faces)")
        return 0
    from nerfstudio_thermal_torch.exporter.texture_utils import export_textured_mesh

    out = export_textured_mesh(model, verts, faces, out_dir, px_per_uv_triangle=opts["px_per_uv_triangle"])
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
