"""The port's fused-MLP backward against the JAX package, on the CPU.

`fused_mlp_bwd_plain` (the plain version of the backward kernel, which the
CPU path of the port's `fused_mlp` autograd node runs) is held against
`jax.vjp` of the JAX package's Pallas `fused_mlp` in interpret mode, with
the same seed-made numpy inputs and cotangent, over the forward test's five
cases in f32 and bf16.

Tolerance per tensor (dx, every dW, every db): the relative L2 error
||got - want|| / ||want|| must be at most 1e-4 in f32 (exact products,
another summation order over N) and 3e-2 in bf16 (one flipped bf16
rounding of dh or of a relu mask at a tie moves a layer's dW by about 2^-8
relative); every value must be finite.

The emulation test reads the packed W^T and the padded dW/db layouts the
way the CUDA kernel does, so a layout fault shows without a card. The
narrow-schedule test runs the one-pass kernel's schedule (persistent CTAs
with static strided 128-point tiles, 16-row warps, per-CTA dW/db, slabs
summed in CTA order) at the proposal and colour-head widths, ragged N
included; it matches the plain backward within the f32 reorder tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp

from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
from tests.test_torch_fused_mlp import CASES, TORCH_DTYPE, _unpack_bf16, make_case

torch.set_num_threads(1)

BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case, dtype):
    in_dim, widths, out_dim, skips, enc, out_act = CASES[case]
    x, ws, bs = make_case(0, in_dim, widths, out_dim, skips, enc, n=300)
    g = np.random.default_rng(1).normal(size=(300, out_dim)).astype(np.float32)

    def f(x_, w_, b_):
        return jax_fused_mlp(x_, w_, b_, "relu", out_act, 128, True, skips, enc, dtype)

    out, vjp = jax.vjp(f, jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    want_dx, want_dw, want_db = vjp(jnp.asarray(g).astype(out.dtype))

    # through the port's autograd node (CPU: the plain backward)
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = [torch.as_tensor(w).requires_grad_(True) for w in ws]
    bt = [torch.as_tensor(b).requires_grad_(True) for b in bs]
    before = fm.fused_mlp_bwd.launches
    y = fm.fused_mlp(xt, wt, bt, "relu", out_act, skips, enc, TORCH_DTYPE[dtype])
    y.backward(torch.as_tensor(g).to(y.dtype))
    assert fm.fused_mlp_bwd.launches == before  # the CPU path launches nothing
    pairs = [("dx", xt.grad, want_dx)]
    pairs += [(f"dW{i}", a.grad, b) for i, (a, b) in enumerate(zip(wt, want_dw))]
    pairs += [(f"db{i}", a.grad, b) for i, (a, b) in enumerate(zip(bt, want_db))]
    for name, got, want in pairs:
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape), name
        assert np.isfinite(got.numpy()).all(), name
        assert rel_l2(got.numpy(), want) <= BWD_TOL[dtype], (name, rel_l2(got.numpy(), want))


def _emulate_bwd(x, g, ws, bs, skips, enc, out_act, dtype):
    """The backward kernel's data flow on the CPU: padded x0 and hidden
    buffers, the walk reading each layer's packed W^T, dW and db written in
    the padded layout, then unpacked by the wrapper's `unpack_grads`."""
    n, in_dim = x.shape
    enc_dim = fm.encoding_dim(in_dim, enc)
    packed = fm.prepare(in_dim, ws, bs, out_act, skips, enc, dtype, transposed=True)
    w, b, wt, desc = packed.weights, packed.biases, packed.weights_t, packed.desc
    in_pad = desc[2]
    layer = lambda li: desc[9 + 5 * li : 14 + 5 * li]  # noqa: E731
    unpack = _unpack_bf16 if dtype == torch.bfloat16 else (lambda flat, k, m: flat.reshape(k, m))
    x0 = fm.encode(x, enc) if enc is not None else x
    x0 = torch.nn.functional.pad(x0, (0, in_pad - enc_dim)).to(dtype)
    acts, h, final_pre = [], None, None
    for li in range(len(ws)):
        k_pad, n_pad, skip, w_off, b_off = layer(li)
        wl = unpack(w[w_off : w_off + k_pad * n_pad], k_pad, n_pad)
        inp = x0 if li == 0 else (torch.cat([x0, h], -1) if skip else h)
        pre = inp.float() @ wl.float() + b[b_off : b_off + n_pad]
        final_pre = pre
        h = fm._apply_act(pre, "relu" if li < len(ws) - 1 else out_act).to(dtype)
        acts.append(h)
    dw = torch.zeros(w.numel())
    db = torch.zeros(b.numel())
    out_pad = layer(len(ws) - 1)[1]
    dh = torch.nn.functional.pad(g.to(dtype).float(), (0, out_pad - g.shape[1]))
    if out_act == "sigmoid":
        y = torch.sigmoid(final_pre)
        dh = dh * y * (1.0 - y)
    dx0 = torch.zeros(n, in_pad)
    for li in reversed(range(len(ws))):
        k_pad, n_pad, skip, w_off, b_off = layer(li)
        if li < len(ws) - 1:
            dh = dh * (acts[li].float() > 0)
        db[b_off : b_off + n_pad] = dh.sum(0)
        dhc = dh.to(dtype).float()
        x_in = x0 if li == 0 else (torch.cat([x0, acts[li - 1]], -1) if skip else acts[li - 1])
        assert x_in.shape[1] == k_pad
        dw[w_off : w_off + k_pad * n_pad] = (x_in.float().t() @ dhc).reshape(-1)
        wtl = unpack(wt[w_off : w_off + k_pad * n_pad], n_pad, k_pad)
        dh_in = dhc @ wtl.float()
        if li == 0 or skip:
            dx0 = dx0 + dh_in[:, :in_pad]
        dh = dh_in[:, in_pad:] if skip else dh_in
    dws, dbs = fm.unpack_grads(dw, db, desc, [tuple(t.shape) for t in ws])
    dx = fm._encode_bwd(x, dx0[:, :enc_dim], enc) if enc is not None else dx0[:, :enc_dim].to(dtype).float()
    return dx, dws, dbs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["enc_skip", "no_enc_sigmoid"])
def test_packing_emulation_of_backward_matches_plain(case, dtype):
    """Packed W^T, padded dW rows [x0 | pad | h | pad] and the unpacking
    reproduce the plain backward exactly (same operations, padded)."""
    in_dim, widths, out_dim, skips, enc, out_act = CASES[case]
    x, ws, bs = make_case(2, in_dim, widths, out_dim, skips, enc, n=41)
    x, ws, bs = torch.as_tensor(x), list(map(torch.as_tensor, ws)), list(map(torch.as_tensor, bs))
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(41, out_dim)).astype(np.float32))
    want_dx, want_dws, want_dbs = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, enc, dtype)
    dx, dws, dbs = _emulate_bwd(x, g, ws, bs, skips, enc, out_act, dtype)
    np.testing.assert_allclose(dx.numpy(), want_dx.float().numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(dws + dbs, want_dws + want_dbs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


NARROW_CASES = {
    # name: (in_dim, hidden widths, out_dim, freq_encoding, out_act, n, grid)
    "proposal_f5": (3, (64, 64), 1, (5, 0.0, 4.0, True), None, 300, 2),
    "proposal_f7_ragged": (3, (64, 64), 1, (7, 0.0, 6.0, True), None, 517, 3),
    "head_sigmoid": (63, (64, 64), 3, None, "sigmoid", 129, 4),
    "one_point": (3, (64, 64), 1, (5, 0.0, 4.0, True), None, 1, 1),
}


def _emulate_narrow(x, g, ws, bs, enc, out_act, dtype, grid, need_dx=True, tile=128, warps=8):
    """The one-pass kernel's schedule on the CPU: CTA c takes tiles c,
    c + grid, ...; per tile the recompute and walk of `_emulate_bwd` on 128
    padded rows (zero input and g past N), db as the 16-row warp sums added
    in warp order, dW += x_in^T dhc; each CTA keeps one dW/db slab, and the
    slabs are summed in CTA order."""
    n, in_dim = x.shape
    enc_dim = fm.encoding_dim(in_dim, enc)
    packed = fm.prepare(in_dim, ws, bs, out_act, (), enc, dtype, transposed=True)
    w, b, wt, desc = packed.weights, packed.biases, packed.weights_t, packed.desc
    in_pad = desc[2]
    layer = lambda li: desc[9 + 5 * li : 14 + 5 * li]  # noqa: E731
    unpack = _unpack_bf16 if dtype == torch.bfloat16 else (lambda flat, k, m: flat.reshape(k, m))
    wl = [unpack(w[layer(li)[3] : layer(li)[3] + layer(li)[0] * layer(li)[1]], *layer(li)[:2]).float()
          for li in range(len(ws))]
    wtl = [unpack(wt[layer(li)[3] : layer(li)[3] + layer(li)[0] * layer(li)[1]], layer(li)[1], layer(li)[0]).float()
           for li in range(len(ws))]
    tiles = -(-n // tile)
    x0_all = fm.encode(x, enc) if enc is not None else x
    x0_all = torch.nn.functional.pad(x0_all, (0, in_pad - enc_dim)).to(dtype)
    out_pad = layer(len(ws) - 1)[1]
    g_all = torch.nn.functional.pad(g.to(dtype).float(), (0, out_pad - g.shape[1]))
    dx0_all = torch.zeros(tiles * tile, in_pad)
    dw_slabs = torch.zeros(grid, w.numel())
    db_slabs = torch.zeros(grid, b.numel())
    for cta in range(grid):
        for t in range(cta, tiles, grid):
            rows = slice(t * tile, min((t + 1) * tile, n))
            m = rows.stop - rows.start
            x0 = torch.zeros(tile, in_pad, dtype=dtype)
            x0[:m] = x0_all[rows]
            acts, h, pre = [], x0, None
            for li in range(len(ws)):
                k_pad, n_pad, _, w_off, b_off = layer(li)
                pre = h.float() @ wl[li] + b[b_off : b_off + n_pad]
                h = fm._apply_act(pre, "relu" if li < len(ws) - 1 else out_act).to(dtype)
                acts.append(h)
            dh = torch.zeros(tile, out_pad)
            dh[:m] = g_all[rows]
            if out_act == "sigmoid":
                y = torch.sigmoid(pre)
                dh = dh * y * (1.0 - y)
            for li in reversed(range(len(ws))):
                k_pad, n_pad, _, w_off, b_off = layer(li)
                if li < len(ws) - 1:
                    dh = dh * (acts[li].float() > 0)
                warp_sums = dh.reshape(warps, tile // warps, n_pad).sum(1)
                tile_db = torch.zeros(n_pad)
                for k in range(warps):
                    tile_db = tile_db + warp_sums[k]
                db_slabs[cta, b_off : b_off + n_pad] += tile_db
                dhc = dh.to(dtype).float()
                x_in = x0 if li == 0 else acts[li - 1]
                dw_slabs[cta, w_off : w_off + k_pad * n_pad] += (x_in.float().t() @ dhc).reshape(-1)
                if li > 0 or need_dx:
                    dh = dhc @ wtl[li]
            if need_dx:
                dx0_all[t * tile : (t + 1) * tile] = dh
    dw, db = torch.zeros(w.numel()), torch.zeros(b.numel())
    for cta in range(grid):
        dw, db = dw + dw_slabs[cta], db + db_slabs[cta]
    dws, dbs = fm.unpack_grads(dw, db, desc, [tuple(t.shape) for t in ws])
    if not need_dx:
        return None, dws, dbs
    dx0 = dx0_all[:n, :enc_dim]
    dx = fm._encode_bwd(x, dx0, enc) if enc is not None else dx0.to(dtype).float()
    return dx, dws, dbs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(NARROW_CASES))
def test_narrow_schedule_emulation_matches_plain(case, dtype):
    """Static tiles per CTA, per-CTA dW/db partials and the fixed-order
    slab sum give the plain backward's dx, dW and db (f32 reorder
    tolerance), for ragged N and fewer points than one tile too."""
    in_dim, widths, out_dim, enc, out_act, n, grid = NARROW_CASES[case]
    x, ws, bs = make_case(5, in_dim, widths, out_dim, (), enc, n=n)
    x, ws, bs = torch.as_tensor(x), list(map(torch.as_tensor, ws)), list(map(torch.as_tensor, bs))
    g = torch.as_tensor(np.random.default_rng(6).normal(size=(n, out_dim)).astype(np.float32))
    want_dx, want_dws, want_dbs = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, (), enc, dtype)
    dx, dws, dbs = _emulate_narrow(x, g, ws, bs, enc, out_act, dtype, grid)
    np.testing.assert_allclose(dx.numpy(), want_dx.float().numpy(), rtol=1e-5, atol=1e-6)
    for a, b in zip(dws + dbs, want_dws + want_dbs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    # without input gradients (the proposals): the same dW and db
    _, dws2, dbs2 = _emulate_narrow(x, g, ws, bs, enc, out_act, dtype, grid, need_dx=False)
    for a, b in zip(dws2 + dbs2, dws + dbs):
        assert torch.equal(a, b)


def test_transposed_pack_is_the_transpose():
    """Unpacking a layer's packed W^T gives the padded W, transposed, with
    both skip segments in place."""
    x, ws, bs = make_case(4, 3, (40, 24, 24), 6, (2,), (4, 0.0, 3.0, True), n=2)
    ws = [torch.as_tensor(w) for w in ws]
    bs = [torch.as_tensor(b) for b in bs]
    for dtype in (torch.float32, torch.bfloat16):
        packed = fm.prepare(3, ws, bs, None, (2,), (4, 0.0, 3.0, True), dtype, transposed=True)
        w, wt, desc, in_pad = packed.weights, packed.weights_t, packed.desc, packed.desc[2]
        unpack = _unpack_bf16 if dtype == torch.bfloat16 else (lambda flat, k, m: flat.reshape(k, m))
        for li in range(len(ws)):
            k_pad, n_pad, skip, w_off, _ = desc[9 + 5 * li : 14 + 5 * li]
            wl = unpack(w[w_off : w_off + k_pad * n_pad], k_pad, n_pad)
            wtl = unpack(wt[w_off : w_off + k_pad * n_pad], n_pad, k_pad)
            assert torch.equal(wtl, wl.t())
        # the skip layer's rows: x0 at [0, 27), h at [in_pad, in_pad + 24)
        k_pad, n_pad, skip, w_off, _ = desc[9 + 10 : 14 + 10]
        wl = unpack(w[w_off : w_off + k_pad * n_pad], k_pad, n_pad).float()
        assert skip == 1 and in_pad == 32 and k_pad == 32 + 32
        np.testing.assert_array_equal(wl[:27, :24].numpy(), ws[2][:27].to(dtype).float().numpy())
        np.testing.assert_array_equal(wl[32:56, :24].numpy(), ws[2][27:].to(dtype).float().numpy())
        assert float(wl[27:32].abs().sum()) == 0.0 and float(wl[56:].abs().sum()) == 0.0
