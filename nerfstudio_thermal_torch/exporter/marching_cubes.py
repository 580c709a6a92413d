"""Isosurface extraction (marching cubes, tetrahedral variant) and SDF grid
evaluation (a copy of nerfstudio_thermal_tpu/exporter/marching_cubes.py,
which imports no JAX; the port keeps its own).

Each cell is split into the 6 Kuhn tetrahedra (one per permutation of the
axes). The Kuhn split puts the same diagonal on the shared face of adjacent
cells, so the extracted surface is watertight; per tetrahedron there are
only 16 sign cases, which are generated (not transcribed) below. Everything
is vectorized numpy, with no per-cell Python loop, and vertices are
deduplicated by their grid-edge key so shared vertices are exact, not
epsilon-merged. The isosurface is classic marching cubes' up to the
in-cell triangulation (slightly more, smaller triangles). The extraction
runs on the host; `evaluate_sdf_grid` builds each slab's points on the host
(float32 linspace, rounded from float64) and hands exactly those points to
the field's callable, which evaluates them on the model's device.
"""

from itertools import permutations
from typing import Callable, Optional, Tuple

import numpy as np


def _corner_id(c) -> int:
    return int(c[0]) + 2 * int(c[1]) + 4 * int(c[2])


_CORNERS = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)])

# Kuhn decomposition: for each axis permutation, the path 0 -> +e_a -> +e_b
# -> +e_c visits 4 cube corners forming one tetrahedron.
_TETS = []
for _perm in permutations(range(3)):
    _v = np.zeros(3, int)
    _path = [_corner_id(_v)]
    for _axis in _perm:
        _v = _v + np.eye(3, dtype=int)[_axis]
        _path.append(_corner_id(_v))
    _TETS.append(_path)
_TETS = np.array(_TETS)  # [6, 4] cube-corner ids


def _tet_case_triangles(case: int):
    """Triangles for one of the 16 inside/outside sign cases of a tetrahedron,
    as lists of edges (pairs of local tet-corner indices 0..3). Generated, not
    table-transcribed: 1 inside corner -> 1 triangle, 2 -> quad -> 2
    triangles, 3 -> 1 triangle."""
    inside = [i for i in range(4) if case >> i & 1]
    outside = [i for i in range(4) if not case >> i & 1]
    if len(inside) == 1:
        a = inside[0]
        return [[(a, outside[0]), (a, outside[1]), (a, outside[2])]]
    if len(inside) == 3:
        a = outside[0]
        return [[(inside[0], a), (inside[1], a), (inside[2], a)]]
    if len(inside) == 2:
        a, b = inside
        c, d = outside
        # crossing polygon cycle: edges ac - ad - bd - bc (consecutive pairs
        # share a tet face, so this is a simple quad)
        e = [(a, c), (a, d), (b, d), (b, c)]
        return [[e[0], e[1], e[2]], [e[0], e[2], e[3]]]
    return []


_TET_TRIS = {case: _tet_case_triangles(case) for case in range(16)}


def marching_cubes(
    grid: np.ndarray,  # [X, Y, Z] scalar field
    level: float = 0.0,
    origin: Optional[np.ndarray] = None,  # [3] world coords of voxel (0,0,0)
    spacing: Optional[np.ndarray] = None,  # [3] voxel size
    gradient_direction: str = "descent",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract the `level` isosurface of a dense scalar grid.

    Returns (vertices [V, 3], faces [F, 3] int32, normals [V, 3]).
    Vertices are in world coordinates when origin/spacing are given, else in
    index coordinates. `gradient_direction='descent'` orients normals toward
    decreasing field values (outward for occupancy/density grids);
    'ascent' flips them (outward for signed distance fields).
    """
    grid = np.asarray(grid, np.float32)
    X, Y, Z = grid.shape
    if X < 2 or Y < 2 or Z < 2:
        raise ValueError("grid must be at least 2 voxels per axis")
    flat = grid.reshape(-1)

    # linear index of every cell's (0,0,0) corner
    ix, iy, iz = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    cell_base = ((ix * Y + iy) * Z + iz).reshape(-1)  # [C]
    corner_off = (_CORNERS[:, 0] * Y + _CORNERS[:, 1]) * Z + _CORNERS[:, 2]  # [8]

    edge_keys = []  # [M, 2] global corner linear ids (lo, hi) per tri vertex
    tri_rows = []  # number of triangles accumulates implicitly (M = 3 * T)

    for tet in _TETS:
        gidx = cell_base[:, None] + corner_off[tet][None, :]  # [C, 4]
        vals = flat[gidx]  # [C, 4]
        inside = vals < level
        case = (
            inside[:, 0].astype(np.int8)
            | (inside[:, 1] << 1)
            | (inside[:, 2] << 2)
            | (inside[:, 3] << 3)
        )
        for c in range(1, 15):
            tris = _TET_TRIS[c]
            if not tris:
                continue
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            g = gidx[sel]  # [S, 4]
            for tri in tris:
                ek = np.stack(
                    [np.stack([g[:, i], g[:, j]], axis=-1) for (i, j) in tri],
                    axis=1,
                )  # [S, 3, 2]
                edge_keys.append(ek.reshape(-1, 2))

    if not edge_keys:
        return (
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32),
            np.zeros((0, 3), np.float32),
        )

    ek = np.concatenate(edge_keys, axis=0)  # [3T, 2]
    lo = np.minimum(ek[:, 0], ek[:, 1]).astype(np.int64)
    hi = np.maximum(ek[:, 0], ek[:, 1]).astype(np.int64)
    key = lo * (X * Y * Z) + hi
    uniq, inv = np.unique(key, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)

    ulo = (uniq // (X * Y * Z)).astype(np.int64)
    uhi = (uniq % (X * Y * Z)).astype(np.int64)
    v0, v1 = flat[ulo], flat[uhi]
    denom = v1 - v0
    t = np.where(np.abs(denom) > 1e-12, (level - v0) / np.where(denom == 0, 1, denom), 0.5)
    t = np.clip(t, 0.0, 1.0)

    def unravel(lin):
        x = lin // (Y * Z)
        r = lin % (Y * Z)
        return np.stack([x, r // Z, r % Z], axis=-1).astype(np.float32)

    p0, p1 = unravel(ulo), unravel(uhi)
    verts_idx = p0 + t[:, None] * (p1 - p0)  # index coords

    # normals: trilinear-interpolated grid gradient at each vertex
    gx, gy, gz = np.gradient(grid)
    normals = np.stack(
        [_trilinear(g, verts_idx) for g in (gx, gy, gz)], axis=-1
    )
    if gradient_direction == "descent":
        normals = -normals
    nrm = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = normals / np.maximum(nrm, 1e-12)

    # orient faces consistently with the vertex normals
    fv = verts_idx[faces]
    face_n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    vert_n = normals[faces].mean(axis=1)
    flip = np.sum(face_n * vert_n, axis=-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    verts = verts_idx
    if spacing is not None:
        verts = verts * np.asarray(spacing, np.float32)[None]
        normals = normals / np.maximum(np.asarray(spacing, np.float32)[None], 1e-12)
        nrm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.maximum(nrm, 1e-12)
    if origin is not None:
        verts = verts + np.asarray(origin, np.float32)[None]
    return verts.astype(np.float32), faces, normals.astype(np.float32)


def _trilinear(vol: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Trilinear sample of vol [X,Y,Z] at fractional index coords pts [N,3]."""
    X, Y, Z = vol.shape
    p = np.clip(pts, 0, np.array([X - 1, Y - 1, Z - 1]) - 1e-6)
    i0 = np.floor(p).astype(np.int64)
    f = p - i0
    i1 = np.minimum(i0 + 1, np.array([X - 1, Y - 1, Z - 1]))
    out = np.zeros(pts.shape[0], vol.dtype)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                idx = (
                    np.where(dx, i1[:, 0], i0[:, 0]),
                    np.where(dy, i1[:, 1], i0[:, 1]),
                    np.where(dz, i1[:, 2], i0[:, 2]),
                )
                out += w * vol[idx]
    return out


def evaluate_sdf_grid(
    sdf: Callable[[np.ndarray], np.ndarray],
    resolution: int,
    bounding_box_min: Tuple[float, float, float],
    bounding_box_max: Tuple[float, float, float],
    max_points_per_eval: int = 262144,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate sdf(points [N,3]) -> [N] over a dense grid, in z-slabs so the
    device never sees more than max_points_per_eval points at once (the
    reference's crop pyramid, `marching_cubes.py:137-230`, serves the same
    memory purpose). Returns (grid [R,R,R], origin [3], spacing [3])."""
    bb_min = np.asarray(bounding_box_min, np.float32)
    bb_max = np.asarray(bounding_box_max, np.float32)
    xs = np.linspace(bb_min[0], bb_max[0], resolution, dtype=np.float32)
    ys = np.linspace(bb_min[1], bb_max[1], resolution, dtype=np.float32)
    zs = np.linspace(bb_min[2], bb_max[2], resolution, dtype=np.float32)
    grid = np.empty((resolution, resolution, resolution), np.float32)
    slab = max(1, max_points_per_eval // (resolution * resolution))
    for x0 in range(0, resolution, slab):
        x1 = min(x0 + slab, resolution)
        gx, gy, gz = np.meshgrid(xs[x0:x1], ys, zs, indexing="ij")
        pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        grid[x0:x1] = np.asarray(sdf(pts)).reshape(x1 - x0, resolution, resolution)
    spacing = (bb_max - bb_min) / max(resolution - 1, 1)
    return grid, bb_min, spacing


def generate_mesh_with_multires_marching_cubes(
    geometry_callable_field: Callable[[np.ndarray], np.ndarray],
    resolution: int = 256,
    bounding_box_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0),
    bounding_box_max: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    isosurface_threshold: float = 0.0,
):
    """Mesh the `isosurface_threshold` level set of an SDF-like callable
    (reference `exporter/marching_cubes.py:137-254`; the reference requires
    resolution % 512 == 0 for its crop pyramid — here any even resolution
    works, slab evaluation bounds memory instead).

    Returns (vertices, faces, normals) with SDF-outward normals."""
    grid, origin, spacing = evaluate_sdf_grid(
        geometry_callable_field, resolution, bounding_box_min, bounding_box_max
    )
    return marching_cubes(
        grid,
        level=isosurface_threshold,
        origin=origin,
        spacing=spacing,
        gradient_direction="ascent",  # SDF: gradient points outward
    )
