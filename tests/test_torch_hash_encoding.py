"""The port's hash-grid encoding and hash fields against the JAX package, on the CPU.

The plain PyTorch versions (ops/encodings.py: the forward, the table
gradient and the position gradient; the CPU path of the autograd node in
ops/cuda/hash_encoding.py) are held against the three JAX routes of the
same function, each fed the same numpy inputs:
- `ops.encodings.hash_encode`, the spec (XLA gather and scatter): forward
  atol 1e-6, gradients normalised by their largest entry within 1e-5. The
  same f32 products and sums in the same order: measured exact.
- `ops.pallas.hash_gather.hash_encode_dg` (row 7 of the kernel table), in
  interpret mode as tests/ops/test_hash_gather_dg.py runs it, with that
  file's tolerances: forward 1e-6, d_table normalised 4e-3 (the hybrid
  rounds each g * w to bf16 before its scatter; the port keeps f32), d_pos
  normalised 1e-5.
- `ops.pallas.hash_encoding.hash_encode_pallas` (rows 8-10), interpret
  mode, T <= 4096: forward 1e-6, gradients normalised 1e-5 (one-hot
  matmuls sum the same terms in another order).
With a bf16 compute dtype the outputs are compared with an added relative
2^-8: an f32 value one ulp apart can round to the neighbouring bf16 value.

The modules (HashEncoding, MLPWithHashEncoding, HashMLPDensityField with
and without `use_linear`, the hash NerfactoField) get the JAX modules'
parameters through `jax_params` and are compared at F32 = 1e-5 and, for
bf16 MLPs, BF16 = 2e-2 (one bf16 rounding flip per layer moves an output by
about a bf16 step), as in tests/test_torch_modules.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.cameras import rays as jrays
from nerfstudio_thermal_tpu.fields import density_fields as jdf
from nerfstudio_thermal_tpu.fields import nerfacto_field as jnf
from nerfstudio_thermal_tpu.ops import encodings as jenc
from nerfstudio_thermal_tpu.ops import mlp as jmlp
from nerfstudio_thermal_tpu.ops.pallas.hash_encoding import hash_encode_pallas
from nerfstudio_thermal_tpu.ops.pallas.hash_gather import hash_encode_dg

from nerfstudio_thermal_torch.cameras import rays as trays
from nerfstudio_thermal_torch.fields import density_fields as tdf
from nerfstudio_thermal_torch.fields import nerfacto_field as tnf
from nerfstudio_thermal_torch.ops import encodings as tenc
from nerfstudio_thermal_torch.ops import mlp as tmlp
from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th
from nerfstudio_thermal_torch.utils import jax_params

torch.set_num_threads(1)

F32 = 1e-5
BF16 = 2e-2
BF16_STEP = 2.0**-8
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def hash_inputs(seed, num_levels, log2_t, batch_shape, min_res, max_res):
    """Table, positions (some exactly on grid coordinates of every level,
    some zeroed as the fields' selector zeroes them), scalings and an
    output cotangent."""
    rng = np.random.default_rng(seed)
    t = 2**log2_t
    table = (rng.normal(size=(num_levels * t, 2)) * 1e-2).astype(np.float32)
    scal = jenc.hash_grid_scalings(num_levels, min_res, max_res)
    pos = rng.uniform(0, 1, (int(np.prod(batch_shape)), 3)).astype(np.float32)
    k = len(pos) // 8
    pos[:k] = np.floor(pos[:k] * min_res) / min_res  # floor == ceil at level 0 (and where min_res divides)
    pos[k : 2 * k] = 0.0
    pos[2 * k, 1] = 1.0 - 2.0**-24  # just below the box's upper face
    g = rng.normal(size=(len(pos), num_levels * 2)).astype(np.float32)
    return table, pos.reshape(*batch_shape, 3), scal, t, g.reshape(*batch_shape, num_levels * 2)


def jax_route(fn, table, pos, scal, t, g, dtype):
    out, vjp = jax.vjp(lambda tb, p: fn(tb, p, jnp.asarray(scal), t, dtype), jnp.asarray(table), jnp.asarray(pos))
    d_table, d_pos = vjp(jnp.asarray(g).astype(out.dtype))
    return np.asarray(out, np.float32), np.asarray(d_table), np.asarray(d_pos)


def port_route(table, pos, scal, t, g, dtype):
    tt = torch.tensor(table, requires_grad=True)
    tp = torch.tensor(pos, requires_grad=True)
    before = (th.hash_encode_fwd.launches, th.hash_encode_bwd_table.launches, th.hash_encode_bwd_pos.launches)
    out = th.hash_encode(tt, tp, torch.tensor(scal), t, dtype)
    out.backward(torch.tensor(g).to(out.dtype))
    after = (th.hash_encode_fwd.launches, th.hash_encode_bwd_table.launches, th.hash_encode_bwd_pos.launches)
    assert after == before  # the CPU path launches nothing
    assert out.dtype == dtype and out.shape == (*pos.shape[:-1], 2 * len(scal))
    return out.detach().float().numpy(), tt.grad.numpy(), tp.grad.numpy()


def normalised_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check(route, dtype_name, table, pos, scal, t, g, fwd_tol, table_tol, pos_tol):
    jdt, tdt = DTYPES[dtype_name]
    want = jax_route(route, table, pos, scal, t, g, jdt)
    got = port_route(table, pos, scal, t, g, tdt)
    rtol = BF16_STEP if dtype_name == "bfloat16" else 0.0
    np.testing.assert_allclose(got[0], want[0], atol=fwd_tol, rtol=rtol)
    assert normalised_err(got[1], want[1]) <= table_tol, normalised_err(got[1], want[1])
    assert normalised_err(got[2], want[2]) <= pos_tol, normalised_err(got[2], want[2])
    assert np.isfinite(got[1]).all() and np.isfinite(got[2]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels,log2_t,batch,res", [(3, 10, (7, 11), (8, 128)), (4, 8, (300,), (4, 64))])
def test_plain_matches_hash_encode(dtype, levels, log2_t, batch, res):
    """The spec route; [B, S, 3] and [N, 3] positions."""
    check(jenc.hash_encode, dtype, *hash_inputs(0, levels, log2_t, batch, *res), 1e-6, 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_hash_encode_dg(dtype):
    """Row 7's route (XLA row gather, Pallas MXU scatter), T = 2^10."""
    check(hash_encode_dg, dtype, *hash_inputs(1, 3, 10, (600,), 8, 128), 1e-6, 4e-3, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [(130,), (5, 12)])
def test_plain_matches_hash_encode_pallas(dtype, batch):
    """Rows 8-10's route (one-hot matmuls), T = 2^9 <= 4096."""
    check(hash_encode_pallas, dtype, *hash_inputs(2, 4, 9, batch, 4, 64), 1e-6, 1e-5, 1e-5)


def test_spatial_hash_and_scalings():
    """The int64 hash keeps uint32's low bits, negative and large
    coordinates included; the per-level resolutions are JAX's."""
    rng = np.random.default_rng(3)
    coords = rng.integers(-70000, 70000, (500, 3)).astype(np.int32)
    coords[0] = [2**31 - 1, -(2**31), 0]
    for t in (2**9, 2**17, 2**19):
        want = np.asarray(jenc.spatial_hash(jnp.asarray(coords), t))
        np.testing.assert_array_equal(tenc.spatial_hash(torch.as_tensor(coords), t).numpy(), want)
    for args in ((16, 16, 2048), (5, 16, 128), (5, 16, 256), (1, 16, 16), (3, 4, 32)):
        np.testing.assert_array_equal(tenc.hash_grid_scalings(*args), jenc.hash_grid_scalings(*args))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_hash_encoding_module(use_pallas):
    """HashEncoding with the JAX module's table: its one output matches the
    JAX module's for both values of use_pallas (the JAX module takes its
    one-hot kernel for use_pallas at T <= 4096, XLA otherwise); a seeded
    init is U(-1e-3, 1e-3) and repeatable."""
    kw = dict(num_levels=3, min_res=4, max_res=32, log2_hashmap_size=10)
    pos = np.random.default_rng(4).uniform(0, 1, (6, 7, 3)).astype(np.float32)
    jmod = jenc.HashEncoding(use_pallas=use_pallas, **kw)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(pos))["params"]
    tmod = tenc.HashEncoding(**kw)
    jax_params.load_module(tmod, jax.tree.map(np.asarray, params), "encoding")
    assert tmod.out_dim == 6
    np.testing.assert_allclose(tmod(torch.as_tensor(pos)).detach().numpy(),
                               np.asarray(jmod.apply({"params": params}, jnp.asarray(pos))), atol=1e-6)
    a, b = tenc.HashEncoding(**kw), tenc.HashEncoding(**kw)
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    table = a.hash_table.detach()
    assert torch.equal(table, b.hash_table.detach()) and table.dtype == torch.float32
    assert 9e-4 < float(table.abs().max()) <= 1e-3 and abs(float(table.mean())) < 1e-4


def _scaled_tables(params, factor=300.0):
    """JAX params with every hash table scaled up from its +-1e-3 init, so
    that the outputs vary over the inputs."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * factor if path[-1].key == "hash_table" else x, params
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_with_hash_encoding(dtype):
    jdt, tdt = DTYPES[dtype]
    kw = dict(num_levels=3, min_res=4, max_res=64, log2_hashmap_size=9, num_layers=2, layer_width=16, out_dim=5)
    pos = np.random.default_rng(6).uniform(0, 1, (40, 3)).astype(np.float32)
    jm = jmlp.MLPWithHashEncoding(compute_dtype=jdt, **kw)
    params = _scaled_tables(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(pos))["params"])
    tm = tmlp.MLPWithHashEncoding(compute_dtype=tdt, **kw)
    jax_params.load_module(tm, jax.tree.map(np.asarray, params), "mlp_base")
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(pos))
    got = tm(torch.as_tensor(pos))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_linear", [False, True])
def test_hash_density_field(dtype, use_linear):
    """Densities, and in f32 the gradients of every parameter and of the
    positions, of HashMLPDensityField against the JAX field."""
    jdt, tdt = DTYPES[dtype]
    kw = dict(num_layers=2, hidden_dim=8, use_linear=use_linear, num_levels=3, max_res=32, log2_hashmap_size=9)
    pos = np.random.default_rng(7).uniform(-3, 3, (6, 5, 3)).astype(np.float32)
    jfield = jdf.HashMLPDensityField(aabb=AABB, compute_dtype=jdt, **kw)
    params = _scaled_tables(jax.jit(jfield.init)(jax.random.PRNGKey(2), jnp.asarray(pos))["params"])
    tfield = tdf.HashMLPDensityField(AABB, compute_dtype=tdt, **kw)
    jax_params.load_module(tfield, jax.tree.map(np.asarray, params), "proposal")
    assert set(jax_params.export_module(tfield)) == set(params)

    tp = torch.tensor(pos, requires_grad=True)
    got = tfield(tp)
    want = jax.jit(jfield.apply)({"params": params}, jnp.asarray(pos))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)
    if dtype != "float32":
        return
    got.sum().backward()
    loss = lambda p, x: jnp.sum(jfield.apply({"params": p}, x))  # noqa: E731
    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(pos))
    got_p = jax_params.export_module(tfield, grads=True)
    for k, w in jax.tree_util.tree_leaves_with_path(want_p):
        g = got_p
        for part in k:
            g = g[part.key]
        assert normalised_err(g, np.asarray(w)) <= 1e-4, (k, normalised_err(g, np.asarray(w)))
    assert normalised_err(tp.grad.numpy(), np.asarray(want_x)) <= 1e-4


def _ray_samples(seed, r=10, s=6):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.05, 5.0, (r, s + 1)), -1).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    vals = dict(origins=rng.uniform(-0.5, 0.5, (r, 3)).astype(np.float32),
                directions=d / np.linalg.norm(d, axis=-1, keepdims=True),
                pixel_area=np.ones((r, 1), np.float32), camera_indices=rng.integers(0, 3, (r, 1)).astype(np.int32),
                spacing_starts=np.zeros((r, s, 1), np.float32), spacing_ends=np.ones((r, s, 1), np.float32),
                s_near=np.zeros((r, 1), np.float32), s_far=np.ones((r, 1), np.float32))
    js = jrays.RaySamples(starts=jnp.asarray(starts[:, :-1, None]), ends=jnp.asarray(starts[:, 1:, None]),
                          **{k: jnp.asarray(v) for k, v in vals.items()})
    ts = trays.RaySamples(starts=torch.as_tensor(starts[:, :-1, None]), ends=torch.as_tensor(starts[:, 1:, None]),
                          **{k: torch.as_tensor(v) for k, v in vals.items()})
    return js, ts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
def test_hash_nerfacto_field(dtype, train):
    """The field_encoding="hash" field (the base of thermal-nerfacto): density
    and colour against the JAX field, in training (per-camera appearance)
    and eval (averaged appearance)."""
    jdt, tdt = DTYPES[dtype]
    kw = dict(num_images=3, hidden_dim=16, num_levels=3, base_res=4, max_res=32, log2_hashmap_size=9,
              hidden_dim_color=16, appearance_embedding_dim=4, use_average_appearance_embedding=True,
              num_channels=3, field_encoding="hash")
    jfield = jnf.ThermalNerfactoField(aabb=AABB, compute_dtype=jdt, **kw)
    js, ts = _ray_samples(8)
    params = jax.jit(lambda k, s: jfield.init(k, s, train=True))(jax.random.PRNGKey(3), js)["params"]
    params = _scaled_tables(params)
    tfield = tnf.ThermalNerfactoField(AABB, compute_dtype=tdt, **kw)
    jax_params.load_module(tfield, jax.tree.map(np.asarray, params), "fields")
    assert set(jax_params.export_module(tfield)) == set(params) == {"mlp_base", "mlp_head", "embedding_appearance"}
    heads = (jnf.FieldHeadNames.DENSITY, jnf.FieldHeadNames.RGB)
    want = jax.jit(lambda p, s: [jfield.apply({"params": p}, s, train=train)[h] for h in heads])(params, js)
    got = tfield(ts, train=train)
    tol = 1e-4 if dtype == "float32" else BF16
    for head, w in zip(heads, want):
        g = got[getattr(tnf.FieldHeadNames, head.name)]
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32), atol=tol, rtol=tol)


def test_kernel_path_has_no_fallback():
    """A tensor that is neither on the CPU nor on CUDA is refused, and the
    kernel wrappers refuse what the kernels do not take instead of
    computing anything else."""
    table, pos, scal = torch.zeros(2 * 256, 2), torch.zeros(4, 3), torch.ones(2)
    with pytest.raises(ValueError, match="unsupported device"):
        th.hash_encode(table.to("meta"), pos.to("meta"), scal.to("meta"), 256)
    with pytest.raises(ValueError, match="unsupported device"):
        th.hash_encode_fwd(table, pos, scal, 256, torch.float32)
    with pytest.raises(ValueError, match="power of 2"):
        th._log2(300)


# The kernels' tile geometry (csrc/hash_encoding.cu): a block owns a tile of
# consecutive points (the forward FWD_TILE, the table gradient BWD_TILE: 32 *
# kFwdGroups and 32 * kBwdGroups), its warps' lanes on 32 consecutive points
# at one level; a staged [tile, 2L] tile keeps one (point, level) pair of
# features per slot, rows padded to tile_stride(L) = L | 1 pairs, moved to
# and from device memory 16 bytes a thread (16 / pair bytes pairs), the
# remainder pair by pair.
FWD_TILE, BWD_TILE, WARP = 256, 32, 32


def ray_inputs(seed, num_levels, log2_t, rays, samples, min_res, max_res):
    """Table, positions, scalings, T and cotangent like the model's: rays
    of `samples` points sorted by depth along chords of the unit box,
    ray-major; every 4th point repeats its predecessor, the first ray lies
    on the box's corners {0, 1}^3 (integer coordinates at every level, where
    floor = ceil), the second ray's points are zeroed as the fields'
    selector zeroes them."""
    rng = np.random.default_rng(seed)
    t = 2**log2_t
    table = (rng.normal(size=(num_levels * t, 2)) * 1e-2).astype(np.float32)
    scal = jenc.hash_grid_scalings(num_levels, min_res, max_res)
    a, b = rng.uniform(0, 1, (rays, 1, 3)), rng.uniform(0, 1, (rays, 1, 3))
    depth = np.sort(rng.uniform(0, 1, (rays, samples, 1)), axis=1)
    pos = (a + depth * (b - a)).astype(np.float32)
    pos[:, 3::4] = pos[:, 2::4][:, : pos[:, 3::4].shape[1]]
    pos[0] = rng.integers(0, 2, (samples, 3))
    pos[1] = 0.0
    pos = pos.reshape(-1, 3)
    g = rng.normal(size=(len(pos), num_levels * 2)).astype(np.float32)
    return table, pos, scal, t, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels,log2_t,rays,samples,res", [(3, 10, 6, 48, (8, 128)), (2, 9, 3, 64, (16, 64))])
def test_plain_matches_hash_encode_on_ray_points(dtype, levels, log2_t, rays, samples, res):
    """The plain forward and both plain gradients against the spec on
    ray-coherent, duplicate-heavy points (the model's kind), tolerances as
    for uniform points."""
    table, pos, scal, t, g = ray_inputs(9, levels, log2_t, rays, samples, *res)
    check(jenc.hash_encode, dtype, table, pos, scal, t, g, 1e-6, 1e-5, 1e-5)


def _tree_sum(values):
    """The sum of one group's values, ordered by lane, as the kernel's
    sum_peers forms it: each remaining rank adds the next remaining rank
    above it, then the ranks with the current bit set drop out."""
    vals = list(values)
    alive, bit = list(range(len(vals))), 0
    while len(alive) > 1:
        above = dict(zip(alive[:-1], alive[1:]))
        vals = [vals[r] + vals[above[r]] if r in above else vals[r] for r in range(len(vals))]
        alive = [r for r in alive if not (r >> bit) & 1]
        bit += 1
    return vals[0]


def emulate_tiled_scatter(pos, g, scal, t):
    """The table gradient as the tiled kernel forms it: per tile and warp
    (lane = point), per level unless the warp's g is zero there, per corner
    the lanes that add (g nonzero) grouped by row, one f32 tree sum and one
    add per group. Returns (d_table [L * T, 2] f32, lane contributions,
    adds issued)."""
    num_levels = len(scal)
    hf, hc, wf, wc = tenc._hash_factors(torch.as_tensor(pos), torch.as_tensor(scal), t)
    d = np.zeros((num_levels * t, 2), np.float32)
    lanes_added = atomics = 0
    for w0 in range(0, len(pos), WARP):  # tiles are whole warps: kTile is a multiple of 32
        lanes = np.arange(w0, min(w0 + WARP, len(pos)))
        for lv in range(num_levels):
            gv = g[lanes, 2 * lv : 2 * lv + 2].astype(np.float32)
            adds = (gv != 0).any(axis=1)
            if not adds.any():
                continue
            for bits in tenc._CORNER_BITS:
                row = tenc._corner_index([h[lv : lv + 1, lanes] for h in hf], [h[lv : lv + 1, lanes] for h in hc],
                                         bits, torch.zeros(1, 1, dtype=torch.int64))[0].numpy()
                wx, wy, wz = (w[lv, lanes].numpy() for w in tenc._corner_weights(wf, wc, bits))
                v = gv * ((wx * wy) * wz)[:, None]
                for r in np.unique(row[adds]):
                    members = np.flatnonzero(adds & (row == r))
                    d[lv * t + r] += _tree_sum(list(v[members]))
                    lanes_added += len(members)
                    atomics += 1
    return d, lanes_added, atomics


SCATTER_KINDS = ["rays", "one_cell", "tile_plus_one", "zero_tiles", "integer"]


def _scatter_case(kind):
    """Small inputs of the kinds the tiled kernels find hard (the card tests'
    kinds, made with numpy): depth-sorted rays, every point in one cell of
    the finest level, N one past a tile multiple, g zero over whole tiles
    and over one warp at every other level, points on integer coordinates
    at every level."""
    rng = np.random.default_rng(SCATTER_KINDS.index(kind) + 20)
    levels, log2_t, lo, hi = 3, 9, 4, 16  # resolutions 4, 8, 16
    scal = jenc.hash_grid_scalings(levels, lo, hi)
    n = 129 if kind == "tile_plus_one" else 384  # one past a multiple of 32 and of 128
    if kind == "one_cell":
        pos = (np.array([0.301, 0.603, 0.207]) + rng.uniform(0, 1e-4, (n, 3))).astype(np.float32)
    elif kind == "integer":
        pos = (rng.integers(0, lo + 1, (n, 3)) / lo).astype(np.float32)  # every resolution a multiple of 4
        assert all(int(s) % lo == 0 for s in scal)
    else:
        r = -(-n // 48)
        a, b = rng.uniform(0, 1, (r, 1, 3)), rng.uniform(0, 1, (r, 1, 3))
        pos = (a + np.sort(rng.uniform(0, 1, (r, 48, 1)), axis=1) * (b - a)).reshape(-1, 3)[:n].astype(np.float32)
    g = rng.normal(size=(n, 2 * levels)).astype(np.float32)
    if kind == "zero_tiles":
        g[128:256] = 0.0
        g[256 : 256 + WARP, 0::4] = 0.0
        g[256 : 256 + WARP, 1::4] = 0.0
    return pos, g, scal, 2**log2_t


@pytest.mark.parametrize("kind", SCATTER_KINDS)
def test_tiled_scatter_emulation_matches_plain(kind):
    """An emulation of the table-gradient kernel's aggregation (one add per
    warp, corner and distinct row) equals the plain scatter within f32
    rounding of a reordered sum (relative L2 1e-6), and on ray-coherent
    points issues fewer adds than lanes."""
    pos, g, scal, t = _scatter_case(kind)
    want = tenc.hash_encode_bwd_table_plain(torch.as_tensor(pos), torch.as_tensor(g), torch.as_tensor(scal), t, 2)
    got, lanes_added, atomics = emulate_tiled_scatter(pos, g, scal, t)
    want = want.numpy().astype(np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-6, rel
    assert atomics < lanes_added  # equal rows in a warp were summed before their add
    if kind == "one_cell":
        assert atomics * WARP == lanes_added  # every lane of a warp on the same 8 rows


def emulate_tiled_pos(table, pos, g, scal, t, groups, phase):
    """The position gradient as the tiled kernel forms it: per tile of 32 G
    points, the levels `phase` at a time; per (group, level) item of a
    phase (lane = point), d_off of the lane's point at that level (corners
    in order 0..7, every product and sum rounded to f32) times the level's
    scaling into the phase's [levels][3][32 G] terms; then one thread per
    point adds the phase's levels in order to its running sums. Returns
    d_pos [N, 3] f32 and the number of items."""
    num_levels, n, tile = len(scal), len(pos), 32 * groups
    hf, hc, wf, wc = tenc._hash_factors(torch.as_tensor(pos), torch.as_tensor(scal), t)
    offset = tenc._level_offset(num_levels, t, "cpu")
    table = torch.as_tensor(table)
    d_pos = np.zeros((n, 3), np.float32)
    items = 0
    for n0 in range(0, n, tile):
        rows = min(tile, n - n0)
        acc = np.zeros((rows, 3), np.float32)
        for l0 in range(0, num_levels, phase):
            levels = min(phase, num_levels - l0)
            terms = np.full((levels, 3, tile), np.nan, np.float32)
            for item in range(groups * levels):
                lv, grp = l0 + item // groups, item % groups
                lanes = n0 + grp * WARP + np.arange(WARP)
                lanes = torch.as_tensor(lanes[lanes < n0 + rows])
                if len(lanes) == 0:
                    continue
                items += 1
                gv = torch.as_tensor(g[lanes.numpy(), 2 * lv : 2 * lv + 2])
                d_off = [torch.zeros(len(lanes)) for _ in range(3)]
                for bits in tenc._CORNER_BITS:
                    idx = tenc._corner_index([h[lv, lanes] for h in hf], [h[lv, lanes] for h in hc], bits,
                                             offset[lv])
                    rows_c = table[idx]
                    gdf = gv[:, 0] * rows_c[:, 0] + gv[:, 1] * rows_c[:, 1]
                    wx, wy, wz = (w[lv, lanes] for w in tenc._corner_weights(wf, wc, bits))
                    sx, sy, sz = (gdf if b else -gdf for b in bits)
                    d_off[0] = d_off[0] + (sx * wy) * wz
                    d_off[1] = d_off[1] + (sy * wx) * wz
                    d_off[2] = d_off[2] + (sz * wx) * wy
                for d in range(3):
                    terms[lv - l0, d, lanes.numpy() - n0] = (d_off[d] * float(scal[lv])).numpy()
            for lv in range(levels):  # one thread per point, levels in order
                acc = (acc + terms[lv, :, :rows].T).astype(np.float32)
        d_pos[n0 : n0 + rows] = acc
    return d_pos, items


POS_KINDS = ["rays", "tile_plus_one", "zero_tile"]


@pytest.mark.parametrize("groups,phase", [(8, 4), (4, 16)])
@pytest.mark.parametrize("levels,log2_t,res", [(16, 10, (16, 512)), (5, 9, (16, 128))])
@pytest.mark.parametrize("kind", POS_KINDS)
def test_tiled_pos_emulation_matches_plain(kind, levels, log2_t, res, groups, phase):
    """An emulation of the position-gradient kernel's tile map (G groups of
    32 points a block, items of one level of 32 points, the levels taken a
    phase at a time through staged terms, a per-point running sum over the
    levels in order; the kernel's shape, G = 8 with phases of 4 levels, and
    G = 4 with one phase) equals the plain position gradient within 1e-6
    relative L2 (the plain version sums the levels in its own order), on
    ray-ordered points, for N one past a tile multiple, and with a whole
    tile of zero g (whose d_pos is exactly zero); every level of every warp
    of points is one item."""
    n_rays = {"rays": 5, "tile_plus_one": 11, "zero_tile": 9}[kind]
    table, pos, scal, t, g = ray_inputs(POS_KINDS.index(kind) + 30, levels, log2_t, n_rays, 48, *res)
    if kind == "tile_plus_one":
        n = 32 * groups * (len(pos) // (32 * groups)) + 1
        pos, g = pos[:n], g[:n]
    if kind == "zero_tile":
        g[256:512] = 0.0
    want = tenc.hash_encode_bwd_pos_plain(torch.as_tensor(table), torch.as_tensor(pos), torch.as_tensor(g),
                                          torch.as_tensor(scal), t).numpy().astype(np.float64)
    got, items = emulate_tiled_pos(table, pos, g, scal, t, groups, phase)
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    assert items == levels * -(-len(pos) // WARP)
    if kind == "zero_tile":
        np.testing.assert_array_equal(got[256:512], 0.0)


def emulate_copy_tile(values, num_levels, pair_bytes, tile):
    """copy_tile_out of csrc/hash_encoding.cu over a whole [N, L] array of
    pairs (given as pair ids), tiles of `tile` points: per tile, the
    block's smem slots filled by lane = point (row * stride + level), then
    read back in 16-byte chunks and a remainder, in device-memory order.
    Also checks that the 32 lanes' slots of one level fall in distinct
    banks. Returns the [N, L] pairs as device memory receives them."""
    n = values.shape[0]
    stride, vec = num_levels | 1, 16 // pair_bytes
    words = pair_bytes // 4
    for lv in range(num_levels):  # bank check: 4-byte words, per phase of 128 bytes
        slots = np.arange(WARP) * stride + lv
        per_phase = 32 // words
        for ph in range(0, WARP, per_phase):
            banks = (slots[ph : ph + per_phase] * words) % 32
            assert len(set(banks.tolist())) == per_phase
    out = np.full(n * num_levels, -1, np.int64)
    for n0 in range(0, n, tile):
        rows = min(tile, n - n0)
        smem = np.full(tile * stride, -2, np.int64)
        for p in range(rows):
            smem[p * stride : p * stride + num_levels] = values[n0 + p]
        pairs, dst = rows * num_levels, out[n0 * num_levels :]
        chunks = pairs // vec
        for i in range(chunks):
            q = i * vec
            r, lv = divmod(q, num_levels)
            for j in range(vec):
                dst[q + j] = smem[r * stride + lv]
                lv += 1
                if lv == num_levels:
                    lv, r = 0, r + 1
        for q in range(chunks * vec, pairs):
            r = q // num_levels
            dst[q] = smem[r * stride + (q - r * num_levels)]
    return out.reshape(n, num_levels)


@pytest.mark.parametrize("pair_bytes", [4, 8], ids=["bf16", "f32"])
@pytest.mark.parametrize("num_levels", [1, 2, 3, 5, 16])
def test_forward_tile_map_reassembles_output(num_levels, pair_bytes):
    """The forward's staged output tile, written out 16 bytes a thread,
    reassembles [N, 2L] exactly, for ragged N; and the table gradient's
    copy_tile_in (the same index map, the other way, on its own tile) hands
    lane p of a tile the pairs of point p."""
    for tile in (FWD_TILE, BWD_TILE):
        for n in (1, 31, 127, 128, 129, 300, 513):
            ids = np.arange(n * num_levels).reshape(n, num_levels)
            np.testing.assert_array_equal(emulate_copy_tile(ids, num_levels, pair_bytes, tile), ids)
    table, pos, scal, t, _ = ray_inputs(10, num_levels, 8, 3, 43, 4, 64)
    want = tenc.hash_encode_plain(torch.as_tensor(table), torch.as_tensor(pos), torch.as_tensor(scal), t).numpy()
    pairs = want.reshape(len(pos), num_levels, 2)
    ids = np.arange(len(pos) * num_levels).reshape(len(pos), num_levels)
    ids = emulate_copy_tile(ids, num_levels, pair_bytes, FWD_TILE)
    np.testing.assert_array_equal(pairs.reshape(-1, 2)[ids.reshape(-1)].reshape(want.shape), want)
