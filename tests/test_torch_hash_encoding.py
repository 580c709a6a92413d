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
