"""The SDF field of neus and neus-facto against the JAX package, on the CPU.

The same JAX-initialised parameters (carried across by `jax_params`, and
back by `export_module` for the gradients) and the same numpy ray samples
go through `nerfstudio_thermal_tpu.fields.sdf_field.SDFField` and the
port's `SDFField`, with and without the hash grid (tiny widths: 4 grid
levels, a 64-wide SDF net of 5 layers, so that the skip at layer 4 runs).

Tolerances, and why (the JAX side jitted, as it trains):
- FIELD: each output's largest absolute error within 5e-4 of its largest
  entry, on the SDF, colours, normals, gradients and alphas. The same f32
  functions, but XLA's fused exp, log and matrix products round their own
  way, and the SDF gradient's sigmoid(100 h) factors scale a rounding of
  h by up to 100; layer 0 is perturbed (below), which makes h steep.
  Measured over 4 seeds, with and without the grid: SDF <= 4.0e-6,
  colours 4.2e-5, gradients 4.0e-5, alphas 1.3e-4, normals 2.1e-4 (eager
  JAX reads <= 5.2e-6 on all of them, at several times the run time);
- GRAD = 2e-4 relative L2 per parameter on the gradients of the eikonal
  term plus the colours' and alphas' means (measured <= 7.1e-5), the loss
  1e-5 relative (3.1e-6);
- WNDense alone: 1e-6; softplus_b100 (the port's -logsigmoid(-100 x) /
  100 against JAX's softplus(100 x) / 100) on a dense grid of [-1, 1]:
  values 1e-8 (measured 3.7e-9), first derivatives 1e-6 (5.4e-7), second
  derivatives 1e-4 absolute, 4e-6 of their peak of 25 (measured 5.0e-5,
  where 1 - sigmoid is a few ulps of 1 and each library rounds it its own
  way).
The geometric initialisation is drawn from the port's own generator, so
it is held to the JAX rule (which entries are zero, the last layer's mean,
the biases, g = the kernel's column norms) and to the JAX init's
statistics, not to its numbers.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.cameras import rays as jrays
from nerfstudio_thermal_tpu.fields import sdf_field as jsdf
from nerfstudio_thermal_tpu.fields.base_field import FieldHeadNames as JHeads

from nerfstudio_thermal_torch.cameras import rays as trays
from nerfstudio_thermal_torch.fields import sdf_field as tsdf
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.utils import jax_params

torch.set_num_threads(1)

FIELD = 5e-4
GRAD = 2e-4
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
HEADS = ("RGB", "SDF", "NORMALS", "GRADIENT", "ALPHA")


def kwargs(grid):
    return dict(num_images=3, num_layers=5, hidden_dim=64, geo_feat_dim=8, num_layers_color=2, hidden_dim_color=16,
                appearance_embedding_dim=4, use_appearance_embedding=True, use_average_appearance_embedding=True,
                use_grid_feature=grid, num_levels=4, log2_hashmap_size=8, max_res=64, beta_init=0.3)


def t(a):
    return torch.as_tensor(np.array(a))


def ray_samples(seed, r=10, s=6):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(r, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = (-1.5 * d + rng.normal(scale=0.2, size=(r, 3))).astype(np.float32)
    edges = np.sort(rng.uniform(0.5, 3.0, (r, s + 1)), -1).astype(np.float32)
    vals = dict(origins=o, directions=d, pixel_area=np.full((r, 1), 1e-4, np.float32),
                camera_indices=rng.integers(0, 3, (r, 1)).astype(np.int32),
                spacing_starts=np.zeros((r, s, 1), np.float32), spacing_ends=np.ones((r, s, 1), np.float32),
                s_near=np.full((r, 1), 0.5, np.float32), s_far=np.full((r, 1), 3.0, np.float32))
    js = jrays.RaySamples(starts=jnp.asarray(edges[:, :-1, None]), ends=jnp.asarray(edges[:, 1:, None]),
                          **{k: jnp.asarray(v) for k, v in vals.items()})
    ts = trays.RaySamples(starts=t(edges[:, :-1, None]), ends=t(edges[:, 1:, None]),
                          **{k: t(v) for k, v in vals.items()})
    return js, ts


_JAX_FIELDS = {}


def jax_field(grid, seed):
    """The JAX field and its initial params, made once per (grid, seed)."""
    if (grid, seed) not in _JAX_FIELDS:
        jfield = jsdf.SDFField(aabb=tuple(map(tuple, AABB.tolist())), **kwargs(grid))
        js, _ = ray_samples(seed)
        params = jax.jit(lambda k, s: jfield.init(k, s, train=True))(jax.random.PRNGKey(seed), js)["params"]
        _JAX_FIELDS[grid, seed] = jfield, params
    return _JAX_FIELDS[grid, seed]


def pair(grid, seed=0):
    jfield, params = jax_field(grid, seed)
    js, ts = ray_samples(seed)
    # the geometric init zeroes layer 0's rows past x (so a first step gives
    # the grid no gradient) and the JAX init's table is U(-1e-3, 1e-3):
    # perturb those rows and scale the table, so that the grid matters
    noise = np.random.default_rng(seed + 10).normal(scale=0.1, size=params["glin0"]["kernel"].shape)
    params = dict(params, glin0=dict(params["glin0"], kernel=params["glin0"]["kernel"] + noise.astype(np.float32)))
    if grid:
        params = dict(params, grid_encoding={"hash_table": params["grid_encoding"]["hash_table"] * 300.0})
    tfield = tsdf.SDFField(AABB, **kwargs(grid))
    jax_params.load_module(tfield, jax.tree.map(np.asarray, params), "fields")
    return jfield, tfield, params, js, ts


def close(got, want, tol=FIELD):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("grid", [False, True], ids=["mlp", "grid"])
def test_sdf_field_outputs_match_jax(grid, train):
    """sdf, gradient, normals, alpha (cos anneal 0.3) and colours at the
    frustum starts; get_sdf and get_sdf_at."""
    jfield, tfield, params, js, ts = pair(grid)
    fn = jax.jit(lambda p, s: {h.name: v for h, v in jfield.apply(
        {"params": p}, s, train=train, return_alphas=True, cos_anneal_ratio=0.3).items()})
    want = fn(params, js)
    with contextlib.nullcontext() if train else torch.no_grad():  # the render path's no_grad
        got = tfield(ts, train=train, return_alphas=True, cos_anneal_ratio=0.3)
    for head in HEADS:
        assert got[getattr(FieldHeadNames, head)].shape == want[head].shape, head
        close(got[getattr(FieldHeadNames, head)], want[head])
        assert got[getattr(FieldHeadNames, head)].requires_grad == train, head  # eval: detached
    close(tfield.get_sdf(ts), jax.jit(lambda p, s: jfield.apply({"params": p}, s, method=jfield.get_sdf))(params, js))
    pts = np.random.default_rng(5).uniform(-2.5, 2.5, (7, 4, 3)).astype(np.float32)  # inside and outside the box
    close(tfield.get_sdf_at(t(pts)), jax.jit(lambda p, x: jfield.apply({"params": p}, x, method=jfield.get_sdf_at))(
        params, jnp.asarray(pts)))
    assert float(tfield.get_inv_s().detach()) == pytest.approx(float(np.exp(0.3 * 10.0)), rel=1e-6)


@pytest.mark.parametrize("grid", [False, True], ids=["mlp", "grid"])
def test_eikonal_gradients_match_jax(grid):
    """Every parameter's gradient of the eikonal loss plus the colours'
    mean, through the SDF gradient's own gradient (create_graph in the
    port, jax.grad of jax.grad in JAX)."""
    jfield, tfield, params, js, ts = pair(grid, seed=1)

    def loss_fn(p):
        out = jfield.apply({"params": p}, js, train=True, return_alphas=True, cos_anneal_ratio=0.5)
        eik = jnp.mean((jnp.linalg.norm(out[JHeads.GRADIENT], axis=-1) - 1.0) ** 2)
        return eik + jnp.mean(out[JHeads.RGB]) + jnp.mean(out[JHeads.ALPHA])

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = tfield(ts, train=True, return_alphas=True, cos_anneal_ratio=0.5)
    eik = torch.mean((torch.linalg.vector_norm(out[FieldHeadNames.GRADIENT], dim=-1) - 1.0) ** 2)
    loss = eik + torch.mean(out[FieldHeadNames.RGB]) + torch.mean(out[FieldHeadNames.ALPHA])
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    got, want = flat(jax_params.export_module(tfield, grads=True)), flat(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for k in want:
        err = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
        assert err <= GRAD, (k, err)
    if grid:
        assert np.abs(want["grid_encoding/hash_table"]).max() > 0


def test_geometric_init_follows_the_jax_rule():
    """Which entries the init zeroes, the last layer's mean sqrt(pi / fan_in)
    negated (inside_outside), its bias, zero biases elsewhere, g = the
    kernel's column norms (w = v), and the hidden layers' std sqrt(2 /
    fan_out) as in the JAX init's draw; the resulting SDF is that of a
    sphere around the origin (here inside_outside: larger inside)."""
    kw = dict(kwargs(True), bias=0.5)
    tfield = tsdf.SDFField(AABB, **kw)
    tfield.reset_parameters(torch.Generator().manual_seed(3))
    jfield = jsdf.SDFField(aabb=tuple(map(tuple, AABB.tolist())), **kw)
    js, _ = ray_samples(0)
    jparams = jax.jit(lambda k, s: jfield.init(k, s, train=True))(jax.random.PRNGKey(3), js)["params"]
    jparams = jax.tree.map(np.asarray, jparams)
    n = len(tfield.geo_layers)
    in_dim = tfield.geo_in_dim
    for i, lin in enumerate(tfield.geo_layers):
        k, jk = lin.kernel.detach().numpy(), jparams[f"glin{i}"]["kernel"]
        assert k.shape == jk.shape
        np.testing.assert_array_equal(k == 0, jk == 0)
        np.testing.assert_allclose(lin.g.detach().numpy(), np.linalg.norm(k, axis=0), rtol=1e-6)
        b = lin.bias.detach().numpy()
        if i == n - 1:
            mean = -math.sqrt(math.pi) / math.sqrt(k.shape[0])
            assert abs(k.mean() - mean) < 1e-5 and k.std() < 2e-4
            assert np.all(b == 0.5) and np.all(jparams[f"glin{i}"]["bias"] == 0.5)
        else:
            assert not b.any()
            live = k[k != 0]
            assert abs(live.std() / (math.sqrt(2) / math.sqrt(k.shape[1])) - 1) < 0.1
        if i == 0:
            assert not k[3:].any()
        if i == 4:
            assert not k[-(in_dim - 3):].any() and k[:-(in_dim - 3)].any()
    pts = torch.tensor([[0.0, 0.0, 0.05], [0.0, 0.6, 0.0], [1.2, 0.0, 0.0]])
    sdf = tfield.get_sdf_at(pts)[:, 0].detach()
    assert sdf[0] > sdf[1] > sdf[2]


@pytest.mark.parametrize("weight_norm", [True, False])
def test_wn_dense_matches_jax(weight_norm):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(20, 7)).astype(np.float32)
    jm = jsdf.WNDense(5, use_weight_norm=weight_norm)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["g"] = params["g"] * 1.7 if weight_norm else None  # g away from the kernel's norms
    tm = tsdf.WNDense(7, 5, use_weight_norm=weight_norm)
    with torch.no_grad():
        tm.kernel.copy_(t(params["kernel"]))
        tm.bias.copy_(t(params["bias"]) + 0.1)
        if weight_norm:
            tm.g.copy_(t(params["g"]))
    params["bias"] = params["bias"] + 0.1
    if not weight_norm:
        params.pop("g")
    want = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(tm(t(x)).detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert ("g" in dict(tm.named_parameters())) == weight_norm


def test_softplus_b100_matches_jax():
    x = np.concatenate([np.linspace(-1, 1, 20001), [0.0, 0.19, 0.21, 0.5, -0.5, 5.0, -5.0]]).astype(np.float32)
    xt = t(x).requires_grad_()
    y = tsdf.softplus_b100(xt)
    (d1,) = torch.autograd.grad(y.sum(), xt, create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), xt)
    jf, xs = jsdf.softplus_b100, jnp.asarray(x)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jf(xs)), rtol=0, atol=1e-8)
    np.testing.assert_allclose(d1.detach().numpy(), np.asarray(jax.vmap(jax.grad(jf))(xs)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jax.vmap(jax.grad(jax.grad(jf)))(xs)), rtol=0, atol=1e-4)
    assert np.isfinite(d2.numpy()).all() and float(d2.max()) == pytest.approx(25.0, rel=1e-6)
    assert float(d1[len(x) - 7]) == 0.5  # at 0, as JAX's logaddexp
