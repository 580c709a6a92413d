"""ns-texture: texture an existing mesh with colours queried from a trained
run (counterpart of nerfstudio_thermal_tpu/scripts/texture.py).

    python -m nerfstudio_thermal_torch.scripts.texture --load-config RUN/config.yml \
        --input-mesh-filename MESH.ply --output-dir DIR [--px-per-uv-triangle N] [--target-num-faces N]

Reads a PLY mesh (as `ns-export marching-cubes` writes it), keeps at most
--target-num-faces faces (uniformly subsampled; "none" keeps all), reloads
the run through `eval_setup` on the card and bakes a texture by rendering
short rays toward the surface: mesh.obj, mesh.mtl and texture.png.
"""

import sys
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

USAGE = (
    "usage: ns-texture --load-config CONFIG --input-mesh-filename MESH.ply "
    "--output-dir DIR [--px-per-uv-triangle N] [--target-num-faces N]"
)


def _decimate(vertices, faces, target_num_faces):
    """Cheap decimation: uniformly subsample faces (adequate for texturing
    a dense marching-cubes mesh), dropping the vertices no kept face uses."""
    if target_num_faces is None or len(faces) <= target_num_faces:
        return vertices, faces
    keep = np.round(np.linspace(0, len(faces) - 1, target_num_faces)).astype(int)
    faces = faces[keep]
    used = np.unique(faces)
    remap = np.full(len(vertices), -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[faces]


def main(argv: Optional[List[str]] = None, *, device: Union[str, torch.device] = "cuda") -> int:
    """`device` is the seam for tests, which pass "cpu"."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE)
        return 0

    opts = {
        "load_config": None,
        "input_mesh_filename": None,
        "output_dir": Path("texture"),
        "px_per_uv_triangle": 4,
        "target_num_faces": 50000,
    }
    i = 0
    while i < len(argv):
        key = argv[i].lstrip("-").replace("-", "_")
        if "=" in argv[i]:
            key, val = key.split("=", 1)
            i += 1
        else:
            val = argv[i + 1]
            i += 2
        if key not in opts:
            print(f"error: unknown flag --{key.replace('_', '-')}", file=sys.stderr)
            return 2
        opts[key] = val
    if opts["load_config"] is None or opts["input_mesh_filename"] is None:
        print("error: --load-config and --input-mesh-filename are required", file=sys.stderr)
        return 2

    from nerfstudio_thermal_torch.exporter.exporter_utils import read_ply_mesh
    from nerfstudio_thermal_torch.exporter.texture_utils import export_textured_mesh
    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup

    vertices, faces = read_ply_mesh(Path(opts["input_mesh_filename"]))
    target = opts["target_num_faces"]
    vertices, faces = _decimate(vertices, faces, None if target in (None, "none") else int(target))

    _, trainer = eval_setup(Path(opts["load_config"]), device=device)
    out_dir = Path(opts["output_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    out = export_textured_mesh(
        trainer.pipeline.model, vertices, faces, out_dir, px_per_uv_triangle=int(opts["px_per_uv_triangle"]),
    )
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
