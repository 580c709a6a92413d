"""The hash grid's second derivative (the position gradient's VJP) against the JAX package, on the CPU.

An SDF field's eikonal loss differentiates the SDF's spatial gradient, so
through a hash grid it differentiates the position gradient d_pos of
`hash_encode`. JAX gets that derivative by differentiating
`_hash_encode_bwd` (jnp). The port computes d_pos in a node of its own,
`_HashEncodeBwdPos` (ops/cuda/hash_encoding.py), whose backward on the CPU
is `hash_encode_bwd_pos_vjp_plain` (ops/encodings.py), the explicit formula
that the CUDA kernel `hash_encode_bwd_pos_vjp` is held to on the card.

Checked three ways, for each of the three outputs (dg, d_table, d_pos2),
each alone and all together:
- against `jax.vjp` of `_hash_encode_bwd`'s d_positions;
- against torch autograd of `hash_encode_bwd_pos_plain`;
- through the whole node: `torch.autograd.grad(create_graph=True)`
  through `hash_encode` and a small softplus MLP, an eikonal loss, then
  backward, against `jax.grad` of the same loss of `jax.grad` of the SDF,
  with and without the table's and the positions' gradients.
Tolerance: each output's largest absolute error within 1e-5 of its
largest entry (SCALED). The VJP alone: the same f32 products in other
orders (XLA and autograd order the corner sums and the scatter's adds
their own way), measured <= 1.6e-7 of the largest entry. Through the
eikonal loss, whose MLP is softplus(100 x) / 100 (each package's softplus
rounds its own way, and the second derivative scales that by 100):
measured <= 3.5e-6. The eikonal loss itself: 1e-6 relative (measured
1.1e-7).

The first-order pass must not form the table gradient: under
`torch.autograd.grad` of the positions alone the table scatter does not
run (the port's counterpart of JAX's `jax.grad(sdf_sum)(x)`, whose program
never forms d_table).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfstudio_thermal_tpu.ops import encodings as jenc

from nerfstudio_thermal_torch.ops import encodings as tenc
from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th

torch.set_num_threads(1)

SCALED = 1e-5
LOSS_TOL = 1e-6
SHAPES = [(4, 8, 50, 4, 64), (16, 6, 37, 16, 2048), (5, 10, 64, 16, 256)]  # L, log2 T, N, min res, max res
OUTPUTS = {"all": (True, True, True), "dg": (True, False, False), "d_table": (False, True, False),
           "d_pos2": (False, False, True)}


def inputs(seed, levels, log2_t, n, lo, hi):
    rng = np.random.default_rng(seed)
    t = 2**log2_t
    table = (rng.normal(size=(levels * t, 2)) * 0.5).astype(np.float32)
    pos = rng.uniform(0.02, 0.98, (n, 3)).astype(np.float32)
    g = rng.normal(size=(n, 2 * levels)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    scal = jenc.hash_grid_scalings(levels, lo, hi)
    return table, pos, g, v, scal, t


def assert_scaled(got, want, name, tol=SCALED):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (name, err)


def t(a):
    return torch.tensor(np.asarray(a))


def graph_nodes(tensor, depth: int = 4) -> set:
    """The names of the autograd nodes within `depth` steps of a tensor's
    grad_fn."""
    names, frontier = set(), [tensor.grad_fn]
    for _ in range(depth):
        frontier = [f for f in frontier if f is not None]
        names.update(type(f).__name__ for f in frontier)
        frontier = [nxt for f in frontier for nxt, _ in f.next_functions]
    return names


@functools.partial(jax.jit, static_argnums=5)
def _jax_vjp(table, pos, g, v, scal, size):
    def d_pos(tb, p, gg):
        return jenc._hash_encode_bwd(size, jnp.float32, (tb, p, scal), gg)[1]

    _, vjp = jax.vjp(d_pos, table, pos, g)
    return vjp(v)


def jax_vjp(table, pos, g, v, scal, size):
    d_table, d_pos2, dg = _jax_vjp(*map(jnp.asarray, (table, pos, g, v, scal)), size)
    return {"dg": np.asarray(dg), "d_table": np.asarray(d_table), "d_pos2": np.asarray(d_pos2)}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"L{s[0]}_T2^{s[1]}_N{s[2]}")
@pytest.mark.parametrize("outputs", list(OUTPUTS), ids=str)
def test_vjp_plain_matches_jax(shape, outputs):
    table, pos, g, v, scal, size = inputs(0, *shape)
    want = jax_vjp(table, pos, g, v, scal, size)
    need = dict(zip(("need_g", "need_table", "need_pos"), OUTPUTS[outputs]))
    got = dict(zip(("dg", "d_table", "d_pos2"),
                   tenc.hash_encode_bwd_pos_vjp_plain(t(table), t(pos), t(g), t(v), t(scal), size, **need)))
    for name, flag in zip(("dg", "d_table", "d_pos2"), OUTPUTS[outputs]):
        if not flag:
            assert got[name] is None, name
            continue
        assert got[name].dtype == torch.float32
        assert_scaled(got[name].numpy(), want[name], name)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: f"L{s[0]}_T2^{s[1]}_N{s[2]}")
def test_vjp_plain_matches_torch_autograd(shape):
    """The explicit formula against autograd of the plain position
    gradient (which is made of differentiable torch ops)."""
    table, pos, g, v, scal, size = inputs(1, *shape)
    tb, p, gg = (t(a).requires_grad_() for a in (table, pos, g))
    d_pos = tenc.hash_encode_bwd_pos_plain(tb, p, gg, t(scal), size)
    want = torch.autograd.grad((d_pos * t(v)).sum(), (gg, tb, p))
    got = tenc.hash_encode_bwd_pos_vjp_plain(t(table), t(pos), t(g), t(v), t(scal), size)
    for name, a, b in zip(("dg", "d_table", "d_pos2"), got, want):
        assert_scaled(a.numpy(), b.numpy(), name)


def test_vjp_plain_on_grid_coordinates():
    """Points on grid coordinates (floor == ceil: one row twice, weights 1
    and 0) and at 0, as the SDF field's contraction never gives but a
    selector-zeroed point does: the formula still matches JAX."""
    table, pos, g, v, scal, size = inputs(2, 4, 8, 48, 4, 64)
    pos[:16] = np.floor(pos[:16] * 4) / 4
    pos[16:24] = 0.0
    want = jax_vjp(table, pos, g, v, scal, size)
    got = tenc.hash_encode_bwd_pos_vjp_plain(t(table), t(pos), t(g), t(v), t(scal), size)
    for name, a in zip(("dg", "d_table", "d_pos2"), got):
        assert_scaled(a.numpy(), want[name], name)


# ---- the whole node: an eikonal loss through hash_encode ----------------------


def sdf_params(seed, levels, width=16):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(2 * levels + 3, width)) / np.sqrt(2 * levels + 3)).astype(np.float32),
            "b1": (rng.normal(size=(width,)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(width, 1)) / np.sqrt(width)).astype(np.float32)}


def _softplus_jax(x):
    return jax.nn.softplus(100.0 * x) / 100.0


@functools.partial(jax.jit, static_argnums=4)
def _jax_eikonal(table, x, params, scal, size):
    def sdf_sum(tb, xx, p):
        enc = jenc.hash_encode(tb, xx, scal, size)
        h = _softplus_jax(jnp.concatenate([enc, xx], -1) @ p["w1"] + p["b1"])
        return jnp.sum(h @ p["w2"])

    def loss(tb, xx, p):
        grad = jax.grad(sdf_sum, argnums=1)(tb, xx, p)
        return jnp.mean((jnp.linalg.norm(grad, axis=-1) - 1.0) ** 2)

    return jax.value_and_grad(loss, argnums=(0, 1, 2))(table, x, params)


def jax_eikonal(table, x, params, scal, size):
    """The eikonal loss of sdf(x) = softplus_b100([enc(x), x] W1 + b1) W2,
    with enc = hash_encode(table, x), and its gradients."""
    value, grads = _jax_eikonal(jnp.asarray(table), jnp.asarray(x), jax.tree.map(jnp.asarray, params),
                                jnp.asarray(scal), size)
    return float(value), grads


def torch_eikonal(table, x, params, scal, size, table_grad=True, pos_grad=True):
    tb = t(table).requires_grad_(table_grad)
    xx = t(x).requires_grad_()
    p = {k: t(v).requires_grad_() for k, v in params.items()}
    enc = th.hash_encode(tb, xx, t(scal), size)
    h = torch.nn.functional.softplus(100.0 * (torch.cat([enc, xx], -1) @ p["w1"] + p["b1"])) / 100.0
    sdf = h @ p["w2"]
    (grad,) = torch.autograd.grad(sdf.sum(), xx, create_graph=True)
    assert "_HashEncodeBwdPosBackward" in graph_nodes(grad)
    loss = torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2)
    wrt = ([tb] if table_grad else []) + ([xx] if pos_grad else []) + list(p.values())
    grads = torch.autograd.grad(loss, wrt)
    out = {}
    if table_grad:
        out["table"] = grads[0]
    if pos_grad:
        out["x"] = grads[int(table_grad)]
    out.update(zip(p, grads[-len(p):]))
    return float(loss.detach()), out


@pytest.mark.parametrize("table_grad, pos_grad", [(True, True), (True, False), (False, True)],
                         ids=["table+pos", "table", "pos"])
@pytest.mark.parametrize("shape", [(4, 8, 50, 4, 64), (16, 9, 40, 16, 2048)], ids=["L4_T2^8", "L16_T2^9"])
def test_eikonal_through_hash_encode_matches_jax(shape, table_grad, pos_grad):
    """The node's graph under create_graph=True, then backward: the loss,
    the table's, the positions' and the MLP's gradients as JAX's."""
    levels, log2_t, n, lo, hi = shape
    table, x, _, _, scal, size = inputs(3, levels, log2_t, n, lo, hi)
    params = sdf_params(4, levels)
    want_loss, (jt, jx, jp) = jax_eikonal(table, x, params, scal, size)
    got_loss, got = torch_eikonal(table, x, params, scal, size, table_grad, pos_grad)
    assert abs(got_loss - want_loss) <= LOSS_TOL * abs(want_loss), (got_loss, want_loss)
    if table_grad:
        assert np.abs(np.asarray(jt)).max() > 0  # the eikonal loss reaches the table
        assert_scaled(got["table"].numpy(), jt, "table")
    if pos_grad:
        assert_scaled(got["x"].numpy(), jx, "x")
    for k in params:
        assert_scaled(got[k].numpy(), jp[k], k)


def test_position_gradient_keeps_its_graph_on_the_cpu():
    """d_pos from hash_encode under create_graph=True comes out of the new
    node, and the node's backward is the explicit formula, not autograd of
    the plain position gradient."""
    table, x, g, _, scal, size = inputs(5, 4, 8, 20, 4, 64)
    tb, xx = t(table).requires_grad_(), t(x).requires_grad_()
    enc = th.hash_encode(tb, xx, t(scal), size)
    (d_pos,) = torch.autograd.grad(enc, xx, grad_outputs=t(g), create_graph=True)
    assert "_HashEncodeBwdPosBackward" in graph_nodes(d_pos)
    (d_pos,) = torch.autograd.grad(th.hash_encode(tb, xx, t(scal), size), xx, grad_outputs=t(g))
    assert d_pos.grad_fn is None


def test_first_order_pass_forms_no_table_gradient(monkeypatch):
    """Under autograd.grad of the positions alone the table scatter does
    not run; the loss's backward then runs it once and the VJP once."""
    calls = {"table": 0, "pos": 0, "vjp": 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tenc, "hash_encode_bwd_table_plain", counted("table", tenc.hash_encode_bwd_table_plain))
    monkeypatch.setattr(tenc, "hash_encode_bwd_pos_plain", counted("pos", tenc.hash_encode_bwd_pos_plain))
    monkeypatch.setattr(tenc, "hash_encode_bwd_pos_vjp_plain", counted("vjp", tenc.hash_encode_bwd_pos_vjp_plain))
    table, x, _, _, scal, size = inputs(6, 4, 8, 30, 4, 64)
    params = sdf_params(7, 4)
    tb = torch.nn.Parameter(t(table))
    xx = t(x).requires_grad_()
    p = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    enc = th.hash_encode(tb, xx, t(scal), size)
    h = torch.nn.functional.softplus(100.0 * (torch.cat([enc, xx], -1) @ p["w1"] + p["b1"])) / 100.0
    sdf = h @ p["w2"]
    (grad,) = torch.autograd.grad(sdf.sum(), xx, create_graph=True)
    assert calls == {"table": 0, "pos": 1, "vjp": 0}
    loss = torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2) + sdf.mean()
    loss.backward()
    assert calls["table"] == 1 and calls["vjp"] == 1
    assert tb.grad is not None and float(tb.grad.abs().max()) > 0
