"""Texture baking: unwrap a mesh into a per-face UV atlas, bake the field's
colour into a texture image, and write OBJ + MTL + PNG
(counterpart of nerfstudio_thermal_tpu/exporter/texture_utils.py).

Two triangles share each atlas square; every texel maps to a barycentric
point on its face, whose colour is rendered by a short ray toward the
surface from a small offset along the face normal. The atlas, the texel
mapping and the OBJ writer are numpy (copies of the JAX package's); the
rays render through the model's chunked path on its device; the PNG is
written with the port's own writer (the card's machine has no Pillow).
"""

import math
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from nerfstudio_thermal_torch.cameras.rays import RayBundle
from nerfstudio_thermal_torch.utils.writer import write_png


def unwrap_mesh_per_face(
    num_faces: int, px_per_triangle: int = 8, padding: int = 2
) -> Tuple[np.ndarray, int, int, int]:
    """Per-face square packing: faces f and f+1 share square f//2 (upper-left
    / lower-right triangle). Returns (texture_coordinates [F, 3, 2] in [0,1],
    tex_w, tex_h, px_per_square)."""
    if num_faces == 0:
        raise ValueError("cannot unwrap an empty mesh (0 faces)")
    num_squares = math.ceil(num_faces / 2)
    sq_w = math.ceil(math.sqrt(num_squares))
    sq_h = math.ceil(num_squares / sq_w)
    P = px_per_triangle + padding
    tex_w, tex_h = sq_w * P, sq_h * P

    f = np.arange(num_faces)
    s = f // 2
    sx, sy = s % sq_w, s // sq_w
    x0, y0 = sx * P, sy * P
    e = px_per_triangle  # triangle leg length in px
    # upper-left triangle corners (px): (0,0), (e,0), (0,e)
    ul = np.array([[0.5, 0.5], [e - 0.5, 0.5], [0.5, e - 0.5]])
    # lower-right triangle corners: (e,e), (0,e), (e,0) - mirrored
    lr = np.array([[e - 0.5, e - 0.5], [0.5, e - 0.5], [e - 0.5, 0.5]])
    corners = np.where((f % 2 == 0)[:, None, None], ul[None], lr[None])
    px_coords = corners + np.stack([x0, y0], -1)[:, None, :]
    uv = px_coords / np.array([tex_w, tex_h])
    return uv.astype(np.float32), tex_w, tex_h, P


def _texel_to_face(tex_w, tex_h, P, px_per_triangle, num_faces):
    """For every texel: (face index or -1, barycentric coords [3])."""
    xs, ys = np.meshgrid(np.arange(tex_w), np.arange(tex_h), indexing="xy")
    sq_w = tex_w // P
    sx, sy = xs // P, ys // P
    sq = sy * sq_w + sx
    lx, ly = (xs % P) + 0.5, (ys % P) + 0.5
    e = px_per_triangle
    upper = (lx + ly) <= e
    face = sq * 2 + np.where(upper, 0, 1)
    # barycentric wrt the triangle corner layout in unwrap_mesh_per_face
    # upper-left: A=(0.5,0.5) B=(e-.5,.5) C=(.5,e-.5)
    # lower-right: A=(e-.5,e-.5) B=(.5,e-.5) C=(e-.5,.5)
    span = max(e - 1.0, 1e-6)
    bu = np.where(upper, (lx - 0.5) / span, (e - 0.5 - lx) / span)
    bv = np.where(upper, (ly - 0.5) / span, (e - 0.5 - ly) / span)
    bu, bv = np.clip(bu, 0, 1), np.clip(bv, 0, 1)
    scale = np.maximum(bu + bv, 1.0)
    bu, bv = bu / scale, bv / scale
    bary = np.stack([1 - bu - bv, bu, bv], axis=-1)
    valid = face < num_faces
    return np.where(valid, face, -1), bary


def bake_texture(
    model,
    vertices: np.ndarray,
    faces: np.ndarray,
    px_per_triangle: int = 8,
    offset: float = 0.02,
    rgb_output_name: str = "rgb",
) -> Tuple[np.ndarray, np.ndarray]:
    """Render the field colour at every texel's surface point on the
    model's device. Returns (texture [H, W, 3] float,
    texture_coordinates [F, 3, 2])."""
    uv, tex_w, tex_h, P = unwrap_mesh_per_face(len(faces), px_per_triangle)
    face_idx, bary = _texel_to_face(tex_w, tex_h, P, px_per_triangle, len(faces))

    flat_face = face_idx.reshape(-1)
    flat_bary = bary.reshape(-1, 3)
    sel = np.nonzero(flat_face >= 0)[0]
    fsel = flat_face[sel]
    tri = vertices[faces[fsel]]  # [M, 3, 3]
    pts = np.einsum("mc,mcd->md", flat_bary[sel], tri)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    origins = pts + n * offset
    directions = -n
    device = model.device
    bundle = RayBundle(
        origins=torch.as_tensor(origins, dtype=torch.float32, device=device),
        directions=torch.as_tensor(directions, dtype=torch.float32, device=device),
        pixel_area=torch.full((len(origins), 1), 1e-6, dtype=torch.float32, device=device),
        camera_indices=torch.zeros((len(origins), 1), dtype=torch.long, device=device),
    )
    rgb = model.render_ray_bundle_chunked(bundle)[rgb_output_name].float().cpu().numpy()
    if rgb.shape[-1] == 1:
        rgb = np.repeat(rgb, 3, -1)

    texture = np.zeros((tex_h, tex_w, 3), np.float32)
    texture.reshape(-1, 3)[sel] = rgb[..., :3]
    return texture, uv


def write_obj(
    path: Path,
    vertices: np.ndarray,
    faces: np.ndarray,
    texture_coordinates: Optional[np.ndarray] = None,  # [F, 3, 2]
    mtl_name: Optional[str] = None,
):
    """Wavefront OBJ with per-face UVs."""
    path = Path(path)
    lines = []
    if mtl_name:
        lines.append(f"mtllib {mtl_name}")
        lines.append("usemtl material_0")
    for v in vertices:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    if texture_coordinates is not None:
        for tc in texture_coordinates.reshape(-1, 2):
            # OBJ vt has origin at bottom-left
            lines.append(f"vt {tc[0]:.6f} {1.0 - tc[1]:.6f}")
        for i, f in enumerate(faces):
            t = 3 * i
            lines.append(f"f {f[0]+1}/{t+1} {f[1]+1}/{t+2} {f[2]+1}/{t+3}")
    else:
        for f in faces:
            lines.append(f"f {f[0]+1} {f[1]+1} {f[2]+1}")
    path.write_text("\n".join(lines) + "\n")


def export_textured_mesh(
    model,
    vertices: np.ndarray,
    faces: np.ndarray,
    output_dir: Path,
    px_per_uv_triangle: int = 8,
    rgb_output_name: str = "rgb",
    mesh_name: str = "mesh",
) -> Path:
    """Bake and write mesh.obj + mesh.mtl + texture.png."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    texture, uv = bake_texture(
        model, vertices, faces, px_per_triangle=px_per_uv_triangle, rgb_output_name=rgb_output_name,
    )
    write_png(output_dir / "texture.png", (np.clip(texture, 0, 1) * 255).astype(np.uint8))
    (output_dir / f"{mesh_name}.mtl").write_text(
        "newmtl material_0\nKa 1.0 1.0 1.0\nKd 1.0 1.0 1.0\n"
        "Ks 0.0 0.0 0.0\nmap_Kd texture.png\n"
    )
    obj_path = output_dir / f"{mesh_name}.obj"
    write_obj(obj_path, vertices, faces, uv, mtl_name=f"{mesh_name}.mtl")
    return obj_path
