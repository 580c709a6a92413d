"""The port's fused ray-march and whole-field functions and modules against the JAX package, on the CPU.

On the CPU the port's `fused_ray_mlp` / `fused_field_mlp` autograd nodes
run their plain PyTorch versions in both directions; the JAX side runs the
Pallas kernels `fused_ray_mlp` / `fused_field_mlp` in interpret mode,
jitted, with a small block size so that each call walks a few grid steps.
Both get the same numpy inputs: rays from inside the scene box with
samples out to 6 (outside the unit ball), one sample at 1e8 (its
contraction reaches the box's edge: selector 0) and two rays with tied
x / y components (o = 0, d = (a, +-a, b)), where the inf-norm's gradient
goes to every tied component.

Tolerances (those of tests/test_torch_fused_mlp.py and
tests/test_torch_fused_mlp_bwd.py):
- outputs: f32 1e-4 absolute plus relative (the same exact f32 products
  and sums in another order; sin/cos of arguments up to ~2 pi 8);
  bf16 2e-2 (a different summation order can flip one bf16 rounding,
  which moves later layers by about one bf16 step);
- gradients, per tensor, relative L2 ||got - want|| / ||want||: f32 1e-4
  (another summation order over the points and samples), bf16 3e-2 (one
  flipped rounding of dh or of a relu mask moves a layer's dW by about
  2^-8 relative).
The module tests also carry the JAX params into the port and export them
back: the tree must come out equal, key for key.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.cameras import rays as jrays
from nerfstudio_thermal_tpu.fields import density_fields as jdf
from nerfstudio_thermal_tpu.fields import nerfacto_field as jnf
from nerfstudio_thermal_tpu.ops.pallas import fused_mlp as jfm

from nerfstudio_thermal_torch.cameras import rays as trays
from nerfstudio_thermal_torch.fields import density_fields as tdf
from nerfstudio_thermal_torch.fields import nerfacto_field as tnf
from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr
from nerfstudio_thermal_torch.ops.encodings import sh_encoding
from nerfstudio_thermal_torch.utils import jax_params
from tests.test_torch_fused_mlp import TORCH_DTYPE, make_case

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
BLOCK = 64  # JAX block size: a few interpret-mode grid steps per call
AABB = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def make_rays(seed, r, s):
    """origins, unit dirs [r, 3] and midpoints [r * s, 1] (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.8, 0.8, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ts = np.sort(rng.uniform(0.05, 6.0, (r, s)), -1).astype(np.float32)
    ts[0, -1] = 1e8
    o[1:3] = 0.0
    d[1] = [0.6, 0.6, 0.52915025]
    d[2] = [0.6, -0.6, 0.52915025]
    return o, d, ts.reshape(-1, 1)


def tt(a, grad=False):
    return torch.tensor(np.asarray(a)).requires_grad_(grad)


def check_grads(named, dtype):
    for name, got, want in named:
        got = got.detach().float().numpy()
        assert got.shape == tuple(np.shape(want)), name
        assert np.isfinite(got).all(), name
        assert rel_l2(got, want) <= BWD_TOL[dtype], (name, rel_l2(got, want))


RAY_CASES = {
    # name: (hidden widths, out_dim, skips, freq_encoding, samples per ray)
    "cross_density": ((32, 32, 32), 8, (2,), (4, 0.0, 3.0, True), 4),
    "proposal": ((16, 16), 1, (), (3, 0.0, 2.0, True), 6),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RAY_CASES))
def test_fused_ray_mlp_and_vjp_match_jax(case, dtype):
    widths, out_dim, skips, enc, s = RAY_CASES[case]
    _, ws, bs = make_case(0, 3, widths, out_dim, skips, enc, n=1)
    o, d, ts = make_rays(1, 20, s)

    @jax.jit
    def f(o_, d_, t_, w_, b_):
        return jfm.fused_ray_mlp(o_, d_, t_, w_, b_, s, "relu", None, BLOCK, True, skips, enc, dtype, True)

    out, vjp = jax.vjp(f, *map(jnp.asarray, (o, d, ts)), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    g = np.random.default_rng(2).normal(size=out.shape).astype(np.float32)
    want_o, want_d, want_t, want_dw, want_db = vjp(jnp.asarray(g).astype(out.dtype))

    ot, dt, tst = tt(o, True), tt(d, True), tt(ts, True)
    wt, bt = [tt(w, True) for w in ws], [tt(b, True) for b in bs]
    counts = lambda: (fr.fused_ray_mlp.launches, fr.fused_ray_mlp_bwd.launches,  # noqa: E731
                      sum(fr.fused_ray_mlp_bwd.stack_launches.values()))
    before = counts()
    got = fr.fused_ray_mlp(ot, dt, tst, wt, bt, s, None, skips, enc, TORCH_DTYPE[dtype])
    got.backward(torch.as_tensor(g).to(got.dtype))
    assert counts() == before  # the CPU launches nothing
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (20 * s, out_dim + 1)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(out, np.float32), atol=TOL[dtype], rtol=TOL[dtype])
    assert 0 < float(got[:, -1].detach().float().sum()) < 20 * s  # the far sample's selector is 0
    named = [("d_o", ot.grad, want_o), ("d_d", dt.grad, want_d), ("d_t", tst.grad, want_t)]
    named += [(f"dW{i}", a.grad, b) for i, (a, b) in enumerate(zip(wt, want_dw))]
    named += [(f"db{i}", a.grad, b) for i, (a, b) in enumerate(zip(bt, want_db))]
    check_grads(named, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ray_vjp_without_input_grads_matches_jax(dtype):
    """need_input_grads=False (proposal fields without camera gradients):
    dW and db as JAX computes them; the rays get no gradient, and the
    node takes the same branch when they do not ask for one."""
    widths, out_dim, skips, enc, s = RAY_CASES["proposal"]
    _, ws, bs = make_case(3, 3, widths, out_dim, skips, enc, n=1)
    o, d, ts = make_rays(4, 20, s)

    @jax.jit
    def f(w_, b_):
        return jfm.fused_ray_mlp(*map(jnp.asarray, (o, d, ts)), w_, b_, s, "relu", None, BLOCK, True, skips, enc,
                                 dtype, False)

    out, vjp = jax.vjp(f, tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    g = np.random.default_rng(5).normal(size=out.shape).astype(np.float32)
    want_dw, want_db = vjp(jnp.asarray(g).astype(out.dtype))
    for input_grads, rays_grad in ((False, True), (True, False)):
        ot, dt, tst = tt(o, rays_grad), tt(d, rays_grad), tt(ts, rays_grad)
        wt, bt = [tt(w, True) for w in ws], [tt(b, True) for b in bs]
        got = fr.fused_ray_mlp(ot, dt, tst, wt, bt, s, None, skips, enc, TORCH_DTYPE[dtype], input_grads)
        got.backward(torch.as_tensor(g).to(got.dtype))
        assert ot.grad is None and dt.grad is None and tst.grad is None
        named = [(f"dW{i}", a.grad, b) for i, (a, b) in enumerate(zip(wt, want_dw))]
        named += [(f"db{i}", a.grad, b) for i, (a, b) in enumerate(zip(bt, want_db))]
        check_grads(named, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [3, 1])
def test_fused_field_mlp_and_vjp_match_jax(channels, dtype):
    """The whole field (base stack, SH4, embedding, colour head), forward
    and VJP: d_o, d_d (through the positions and the SH chain), d_t, d_emb
    and every dW and db of both stacks."""
    s, e, skips, enc = 4, 4, (2,), (4, 0.0, 3.0, True)
    _, bw, bb = make_case(5, 3, (32, 32, 32), 16, skips, enc, n=1)
    _, hw, hb = make_case(6, 16 + 15 + e, (16, 16), channels, (), None, n=1)
    o, d, ts = make_rays(7, 20, s)
    emb = np.random.default_rng(8).normal(size=(20, e)).astype(np.float32)

    @jax.jit
    def f(o_, d_, t_, e_, bw_, bb_, hw_, hb_):
        return jfm.fused_field_mlp(o_, d_, t_, e_, bw_, bb_, hw_, hb_, s, BLOCK, True, skips, enc, dtype)

    stacks = [tuple(map(jnp.asarray, z)) for z in (bw, bb, hw, hb)]
    out, vjp = jax.vjp(f, *map(jnp.asarray, (o, d, ts, emb)), *stacks)
    g = np.random.default_rng(9).normal(size=out.shape).astype(np.float32)
    want = vjp(jnp.asarray(g).astype(out.dtype))

    ins = [tt(a, True) for a in (o, d, ts, emb)]
    params = [[tt(a, True) for a in z] for z in (bw, bb, hw, hb)]
    before = fr.fused_field_mlp.launches, fr.fused_field_mlp_bwd.launches
    got = fr.fused_field_mlp(*ins, *params, s, skips, enc, TORCH_DTYPE[dtype])
    got.backward(torch.as_tensor(g).to(got.dtype))
    assert (fr.fused_field_mlp.launches, fr.fused_field_mlp_bwd.launches) == before
    assert got.shape == (20 * s, channels + 2)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(out, np.float32), atol=TOL[dtype], rtol=TOL[dtype])
    named = [(k, a.grad, w) for k, a, w in zip(("d_o", "d_d", "d_t", "d_emb"), ins, want[:4])]
    for tag, got_l, want_l in zip(("dW_base", "db_base", "dW_head", "db_head"), params, want[4:]):
        named += [(f"{tag}{i}", a.grad, w) for i, (a, w) in enumerate(zip(got_l, want_l))]
    check_grads(named, dtype)


def emulate_head_fill(dirs, emb, base, num_samples, rows, cols, dtype):
    """The whole-field head kernels' input assembly (csrc/fused_ray_fwd.cu
    HeadFill) over every tile of `rows` rows (16: a warp of the narrow
    kernel; 64: the f32 kernel's block, a wgmma warpgroup): SH4 once per
    ray the tile's rows reach, rounded to the compute dtype, and each row's
    ray less the tile's first; the base row's columns 1.. into columns 16..,
    its column 0 (the raw density) into the output instead; the row's ray's
    embedding rounded to the compute dtype after them; the SH columns from
    the per-ray buffer; zeros past the row count and past 16 + geo + E.
    Returns (x0 [tiles * rows, cols] f32,
    the head input written [n, 16 + geo + E], the raw density copied
    [n])."""
    n, bw, e = base.shape[0], base.shape[1], emb.shape[1]
    width = 15 + bw + e
    x0 = torch.full((-(-n // rows) * rows, cols), float("nan"))
    head_in, raw = torch.full((n, width), float("nan")), torch.full((n,), float("nan"), dtype=base.dtype)
    for row0 in range(0, n, rows):
        valid = max(0, min(rows, n - row0))
        ray0 = row0 // num_samples
        rays = (row0 + valid - 1) // num_samples - ray0 + 1
        assert rays <= rows  # the kernels' scratch holds `rows` rays
        sh = sh_encoding(dirs[ray0 : ray0 + rays].float(), 4).to(dtype).float()
        ray_of = [(row0 + r) // num_samples - ray0 for r in range(valid)]
        x0[row0 : row0 + rows] = 0.0
        for r in range(valid):
            row = row0 + r
            raw[row] = base[row, 0]
            x0[row, 16 : 15 + bw] = base[row, 1:].float()
            x0[row, 15 + bw : width] = emb[ray0 + ray_of[r]].to(dtype).float()
            x0[row, :16] = sh[ray_of[r]]
            head_in[row] = x0[row, :width]
    return x0, head_in, raw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,num_samples,n_rays", [(16, 32, 3), (16, 5, 7), (64, 48, 3), (64, 1, 70), (64, 5, 27)])
def test_head_input_assembly_matches_plain(rows, num_samples, n_rays, dtype):
    """The kernels' head-input assembly, SH4 once per ray and broadcast to
    the ray's samples, equals the plain _head_input bitwise (x0 and the
    head input it writes), pads with zeros, copies the raw density; for
    tiles that split rays (S not dividing the tile), for one sample per ray
    and for a ragged last tile."""
    cdt = TORCH_DTYPE[dtype]
    rng = np.random.default_rng(rows + num_samples)
    _, dirs, _ = make_rays(13, n_rays, 1)
    emb = torch.tensor(rng.normal(size=(n_rays, 4)).astype(np.float32))
    base = torch.tensor(rng.normal(size=(n_rays * num_samples, 1 + 7)).astype(np.float32)).to(cdt)
    dirs = torch.tensor(dirs)
    x0, head_in, raw = emulate_head_fill(dirs, emb, base, num_samples, rows, 32, cdt)
    want = fr._head_input(dirs, emb, base, num_samples, cdt).float()
    n, width = want.shape
    assert torch.equal(x0[:n, :width], want) and torch.equal(head_in, want)
    assert not bool(x0[:n, width:].any()) and not bool(x0[n:].any())
    assert torch.equal(raw, base[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_input_assembly_matches_jax_field_block(dtype):
    """The head input the port assembles from JAX's own base output equals
    the head input of JAX's `_field_fwd_block` (its SH4 of the directions
    and its embeddings broadcast by the ray matrix, rounded to the compute
    dtype) within the file's output tolerance."""
    s, e, skips, enc = 4, 4, (2,), (4, 0.0, 3.0, True)
    _, bw, bb = make_case(5, 3, (32, 32, 32), 16, skips, enc, n=1)
    _, hw, hb = make_case(6, 16 + 15 + e, (16, 16), 3, (), None, n=1)
    o, d, ts = make_rays(7, 20, s)
    emb = np.random.default_rng(8).normal(size=(20, e)).astype(np.float32)
    cdt = jnp.dtype(dtype)
    bw_c, bb_c = jfm._field_cast(list(map(jnp.asarray, bw)), list(map(jnp.asarray, bb)), cdt)
    hw_c, hb_c = jfm._field_cast(list(map(jnp.asarray, hw)), list(map(jnp.asarray, hb)), cdt)
    *_, saved = jfm._field_fwd_block(*map(jnp.asarray, (o, d, ts, emb)), bw_c, bb_c, hw_c, hb_c, s, skips, enc,
                                     cdt, save=True)
    base = torch.tensor(np.asarray(saved[9][-1], np.float32)).to(TORCH_DTYPE[dtype])
    want = np.asarray(saved[12], np.float32)
    _, head_in, _ = emulate_head_fill(torch.tensor(d), torch.tensor(emb), base, s, 16, want.shape[1], TORCH_DTYPE[dtype])
    np.testing.assert_allclose(head_in.numpy(), want, atol=TOL[dtype], rtol=TOL[dtype])


def test_contraction_backward_at_ties_matches_jax():
    """`contract_bwd` is JAX's `_contract_bwd` written out: at tied
    inf-norm components every tied component gets the gradient (autograd
    through torch.amax would give it to one), inside the unit ball g passes
    unchanged, and the selector passes none."""
    o = np.zeros((4, 3), np.float32)
    d = np.array([[0.6, 0.6, 0.5], [0.6, -0.6, 0.5], [0.5, 0.5, 0.5], [1.0, 0.25, -0.5]], np.float32)
    ts = np.array([[3.0], [0.5], [4.0], [2.0]], np.float32)  # outside, inside, outside (3-way tie), outside
    dx = np.random.default_rng(10).normal(size=(4, 3)).astype(np.float32)
    c = fr.contract(tt(o), tt(d), tt(ts), 1)
    got = fr.contract_bwd(tt(dx), c).numpy()
    pos, _, _ = jfm._posgen_fwd(jnp.asarray(o), jnp.asarray(d), jnp.asarray(ts), 1)
    x, sel, mag, safe = jfm._contract_fwd(pos)
    want = np.asarray(jfm._contract_bwd(jnp.asarray(dx), pos, sel, mag, safe))
    np.testing.assert_allclose(c.x.numpy(), np.asarray(x), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1], dx[1] * 0.25)  # inside the unit ball
    # autograd through amax splits a tie: it differs from the written-out VJP
    pos_t = torch.tensor(np.asarray(pos)).requires_grad_(True)
    mag_t = torch.amax(pos_t.abs(), -1, keepdim=True)
    ((2.0 - 1.0 / mag_t) * (pos_t / mag_t) + 2.0).mul(0.25).backward(tt(dx))
    assert not np.allclose(pos_t.grad.numpy()[0], got[0], rtol=1e-4)


def test_sh4_and_its_vjp_match_jax():
    """SH4 of the plain versions is `_sh4_2d`; the written-out VJP matches
    jax.vjp of it and float64 autograd."""
    d = make_rays(11, 16, 1)[1]
    g = np.random.default_rng(12).normal(size=(16, 16)).astype(np.float32)
    sh, vjp = jax.vjp(jfm._sh4_2d, jnp.asarray(d))
    np.testing.assert_array_equal(sh_encoding(tt(d), 4).numpy(), np.asarray(sh))
    got = fr.sh4_vjp(tt(d), tt(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-5, atol=1e-5)
    d64 = torch.tensor(d, dtype=torch.float64).requires_grad_(True)
    sh_encoding(d64, 4).backward(torch.tensor(g, dtype=torch.float64))
    np.testing.assert_allclose(got, d64.grad.numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- modules


def ray_samples(seed, r=10, s=5):
    """The same samples as JAX and port RaySamples, with one far sample."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.05, 5.0, (r, s + 1)), -1).astype(np.float32)
    starts[0, -1] = 2e8
    vals = dict(origins=rng.uniform(-0.5, 0.5, (r, 3)).astype(np.float32), directions=make_rays(seed, r, 1)[1],
                pixel_area=np.ones((r, 1), np.float32), camera_indices=rng.integers(0, 3, (r, 1)).astype(np.int32),
                spacing_starts=np.zeros((r, s, 1), np.float32), spacing_ends=np.ones((r, s, 1), np.float32),
                s_near=np.zeros((r, 1), np.float32), s_far=np.ones((r, 1), np.float32))
    bins = dict(starts=starts[:, :-1, None], ends=starts[:, 1:, None])
    js = jrays.RaySamples(**{k: jnp.asarray(v) for k, v in {**bins, **vals}.items()})
    ts = trays.RaySamples(**{k: torch.tensor(v) for k, v in {**bins, **vals}.items()})
    return js, ts


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


def carry_both_ways(port_module, params):
    """Load the JAX params into the port module and export them back: the
    same tree, key for key and value for value."""
    tree = jax.tree.map(np.asarray, params)
    jax_params.load_module(port_module, tree, "test")
    back, want = flat(jax_params.export_module(port_module)), flat(tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def grads_match(port_module, jax_grads, dtype):
    got, want = flat(jax_params.export_module(port_module, grads=True)), flat(jax.tree.map(np.asarray, jax_grads))
    assert set(got) == set(want)
    check_grads([(k, torch.tensor(got[k]), want[k]) for k in sorted(want)], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_density_field_fused_raymarch_matches_jax(dtype):
    """MLPDensityField(fused_raymarch=True) with and without input
    gradients: densities and every parameter's gradient of a density loss;
    the JAX module creates the flat `Dense_{i}_kernel` layout, and the
    port exports it."""
    for input_grads in (True, False):
        kw = dict(num_layers=3, hidden_dim=16, num_frequencies=3, use_pallas=True, fused_raymarch=True,
                  fused_raymarch_input_grads=input_grads)
        jfield = jdf.MLPDensityField(aabb=AABB, compute_dtype=jnp.dtype(dtype), **kw)
        js, ts = ray_samples(13)
        params = jax.jit(lambda k, s: jfield.init(k, ray_samples=s))(jax.random.PRNGKey(1), js)["params"]
        assert "Dense_0_kernel" in params["mlp"]
        tfield = tdf.MLPDensityField(AABB, compute_dtype=TORCH_DTYPE[dtype], **kw)
        assert tfield.fuses_rays()
        carry_both_ways(tfield, params)

        def loss(p, s):
            dens = jfield.apply({"params": p}, ray_samples=s)
            return jnp.sum(dens * jnp.linspace(0.1, 1.0, dens.size).reshape(dens.shape)), dens

        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, js)
        got = tfield(ray_samples=ts)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL[dtype], rtol=TOL[dtype])
        (got * torch.linspace(0.1, 1.0, got.numel()).reshape(got.shape)).sum().backward()
        grads_match(tfield, jgrads, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused_field", [False, True])
def test_nerfacto_field_fused_matches_jax(fused_field, dtype):
    """The freq NerfactoField with fused_raymarch (and fused_field): its
    full forward in training (the camera's embedding) and in eval (the
    table's mean), get_density_from_rays, and every parameter's gradient
    of a loss on colour and density in training."""
    kw = dict(num_images=3, hidden_dim_color=16, appearance_embedding_dim=4,
              use_average_appearance_embedding=True, num_channels=3, use_pallas=True,
              field_encoding="freq", freq_num_frequencies=4, freq_num_layers=4, freq_hidden_dim=128,
              freq_final_init_scale=0.5, fused_raymarch=True, fused_field=fused_field)
    jfield = jnf.ThermalNerfactoField(aabb=AABB, compute_dtype=jnp.dtype(dtype), **kw)
    js, ts = ray_samples(14)
    params = jax.jit(lambda k, s: jfield.init(k, s, train=True))(jax.random.PRNGKey(2), js)["params"]
    assert ("Dense_0_kernel" in params["mlp_head"]) == fused_field
    tfield = tnf.ThermalNerfactoField(AABB, compute_dtype=TORCH_DTYPE[dtype], **kw)
    assert tfield._fused_field_ok() == fused_field
    carry_both_ways(tfield, params)
    heads = (jnf.FieldHeadNames.DENSITY, jnf.FieldHeadNames.RGB)

    def loss(p, s):
        out = jfield.apply({"params": p}, s, train=True)
        return jnp.sum(out[heads[1]] * 0.7) + jnp.sum(out[heads[0]] * 0.05), [out[h] for h in heads]

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, js)
    got = tfield(ts, train=True)
    for head, w in zip((FieldHeadNames.DENSITY, FieldHeadNames.RGB), want):
        np.testing.assert_allclose(got[head].detach().numpy(), np.asarray(w), atol=TOL[dtype], rtol=TOL[dtype])
    ((got[FieldHeadNames.RGB] * 0.7).sum() + (got[FieldHeadNames.DENSITY] * 0.05).sum()).backward()
    grads_match(tfield, jgrads, dtype)

    want_eval = jax.jit(lambda p, s: [jfield.apply({"params": p}, s, train=False)[h] for h in heads])(params, js)
    want_dens = jax.jit(lambda p, s: jfield.apply({"params": p}, s, method=jfield.get_density_from_rays))(params, js)
    with torch.no_grad():
        got_eval = tfield(ts, train=False)
        got_dens = tfield.get_density_from_rays(ts)
    for head, w in zip((FieldHeadNames.DENSITY, FieldHeadNames.RGB), want_eval):
        np.testing.assert_allclose(got_eval[head].numpy(), np.asarray(w), atol=TOL[dtype], rtol=TOL[dtype])
    for g_, w in zip(got_dens, want_dens):
        np.testing.assert_allclose(g_.float().numpy(), np.asarray(w, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


def test_fused_knobs_fall_back_where_jax_does():
    """Configurations the kernels do not take run the unfused path, as the
    JAX modules do: a freq field without use_pallas, a field without an
    appearance embedding (fused_field only), a proposal field without the
    contraction. Each computes what the same module without the knobs
    computes."""
    js, ts = ray_samples(15)
    gen = torch.Generator().manual_seed(0)
    kw = dict(num_images=3, hidden_dim_color=16, field_encoding="freq", freq_num_frequencies=4,
              freq_num_layers=4, freq_hidden_dim=128)
    for extra in (dict(use_pallas=False, appearance_embedding_dim=4), dict(use_pallas=True, appearance_embedding_dim=0)):
        plain = tnf.NerfactoField(AABB, **kw, **extra)
        plain.reset_parameters(gen)
        fused = tnf.NerfactoField(AABB, **kw, **extra, fused_raymarch=True, fused_field=True)
        fused.load_state_dict(plain.state_dict())
        assert not fused._fused_field_ok()
        with torch.no_grad():
            a, b = plain(ts, train=False), fused(ts, train=False)
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-5, atol=1e-6)
    plain = tdf.MLPDensityField(AABB, use_spatial_distortion=False, use_pallas=True)
    plain.reset_parameters(gen)
    fused = tdf.MLPDensityField(AABB, use_spatial_distortion=False, use_pallas=True, fused_raymarch=True)
    fused.load_state_dict(plain.state_dict())
    assert not fused.fuses_rays()
    with torch.no_grad():
        torch.testing.assert_close(fused(ray_samples=ts), plain(ray_samples=ts))
