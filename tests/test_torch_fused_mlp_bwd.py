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
The f32 schedule test runs the exact-f32 walk and dW stage (128-point
blocks, W / W^T slices, relu-mask words, the register tiles' db order, dW
splits and slab sums) against the plain f32 backward at ragged N.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp

from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
from tests import torch_fused_mlp_plan as plan_rule
from tests.test_torch_fused_mlp import CASES, TORCH_DTYPE, _unpack_bf16, f32_tile_owners, make_case

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


NERF_STACKS = {
    # the frequency NeRF's base stacks: vanilla-nerf's 63-wide and mipnerf's
    # 99-wide encoded input, 8 x 256 with the skip at 4, the last layer 256
    "vanilla-nerf": (63, (256,) * 8, (4,)),
    "mipnerf": (99, (256,) * 8, (4,)),
}


@pytest.mark.parametrize("name", sorted(NERF_STACKS))
def test_nerf_base_stacks_fit_the_backward(name):
    """The bf16 walk keeps the last layer's f32 pre-activation only for a
    sigmoid head: without it the NeRF stacks' 256-wide output fits (bf16
    227,328 bytes at the 112-wide input), with it they would not;
    thermal-nerfacto-tpu's base stack (16 wide out) fits either way. The
    f32 walk keeps none (a sigmoid head's dh is formed in the registers of
    the recomputed product), so its shared memory is the same either way
    and fits (231,168 bytes at the 112-wide input). The rule's copy, held
    to the library on the card (tests/test_torch_cuda_kernels.py)."""
    in_dim, dims, skips = NERF_STACKS[name]
    prev, ws = in_dim, []
    for i, d in enumerate(dims):
        ws.append(torch.zeros(prev + (in_dim if i in skips else 0), d))
        prev = d
    bs = [torch.zeros(d) for d in dims]
    for dtype in (torch.bfloat16, torch.float32):
        desc = fm.prepare(in_dim, ws, bs, None, skips, None, dtype).desc
        assert desc[2] == (64 if in_dim == 63 else 112) and desc[9 + 5 * 7 + 1] == 256
        bf16 = dtype == torch.bfloat16
        assert plan_rule.walk_smem(desc, bf16) <= plan_rule.SMEM_LIMIT, dtype
        with_sigmoid = plan_rule.walk_smem([*desc[:8], 1, *desc[9:]], bf16)
        if bf16:
            assert with_sigmoid > plan_rule.SMEM_LIMIT
        else:
            assert with_sigmoid == plan_rule.walk_smem(desc, bf16)
    base = [torch.zeros(i, o) for i, o in [(63, 256)] + [(256, 256)] * 3 + [(319, 256)] + [(256, 256)] * 2 + [(256, 16)]]
    desc = fm.prepare(63, base, [torch.zeros(w.shape[1]) for w in base], None, (4,), None, torch.bfloat16).desc
    assert plan_rule.walk_smem([*desc[:8], 1, *desc[9:]], True) <= plan_rule.SMEM_LIMIT


def _f32_db_partial(v, ncols):
    """A walk block's db partial as walk32_dh sums it: each thread its
    register tile's points in order, then a warp's 4 thread rows by the
    butterfly ((ty0 + ty1) + (ty2 + ty3)), then the warps in order."""
    tm, _, _, _, points, _ = f32_tile_owners(ncols)
    gy = plan_rule.F32_ROWS // tm
    per_ty = torch.zeros(gy, v.shape[1])
    for ty in range(gy):
        for i in range(tm):
            per_ty[ty] += v[ty * 4 + (i & 3) + (i >> 2) * 64]
    quads = per_ty.reshape(gy // 4, 4, -1)
    warp = (quads[:, 0] + quads[:, 1]) + (quads[:, 2] + quads[:, 3])
    total = torch.zeros(v.shape[1])
    for k in range(gy // 4):
        total += warp[k]
    return total


def _f32_mask_roundtrip(act, ncols):
    """The walk's relu-mask words: bit i * TN + j of thread t holds
    activation (point(t, i), column(t, j)) > 0 (walk32_forward), read back
    for the same register tile (walk32_h_pass). Returns the mask [128,
    ncols] the read gives."""
    tm, tn, _, _, points, cols = f32_tile_owners(ncols)
    words = np.zeros((plan_rule.F32_THREADS, 2), np.uint64)
    a = act.numpy()
    for i in range(tm):
        for j in range(tn):
            bit = i * tn + j
            c = cols[:, j]
            on = (c < ncols) & (a[points[:, i], np.minimum(c, ncols - 1)] > 0)
            words[:, bit >> 5] |= on.astype(np.uint64) << np.uint64(bit & 31)
    mask = np.zeros((plan_rule.F32_ROWS, ncols), bool)
    for i in range(tm):
        for j in range(tn):
            bit = i * tn + j
            c = cols[:, j]
            keep = c < ncols
            mask[points[keep, i], c[keep]] = (words[keep, bit >> 5] >> np.uint64(bit & 31)) & np.uint64(1) == 1
    return torch.as_tensor(mask)


def _emulate_f32_bwd(x, g, ws, bs, skips, enc, out_act, num_sms=132):
    """The f32 backward's schedule (csrc/fused_mlp_bwd.cu): per 128-point
    walk block the forward recompute into the workspace (x0, activations,
    relu-mask words), the last layer's dh, then per layer from the last the
    x0 columns of dh W^T added to dx0 (layer 0, skip layers) and its h
    columns masked into the previous layer's dh, with the weights' and
    W^T's slices as the ring receives them (F32WalkSeq), every product in
    its column passes of at most 256 and a pass past 256 that still reads
    h kept in the spill rows until the last; db partials per block and
    pass in the kernel's order, summed in groups of 64 then in order; dW
    per split of the points (the plan's), each summed over its points in
    order, the slabs then in order; dx by the encoding backward."""
    from tests.test_torch_fused_mlp import f32_copy_spill, f32_encode_tile, f32_operand, f32_product, f32_store

    n, in_dim = x.shape
    packed = fm.prepare(in_dim, ws, bs, out_act, skips, enc, torch.float32, transposed=True)
    desc, w, wt, b = packed.desc, packed.weights, packed.weights_t, packed.biases
    plan = plan_rule.f32_bwd_plan(desc, n, num_sms)
    nl, in_pad, enc_dim = desc[0], desc[2], desc[3]
    lay = [desc[9 + 5 * li : 14 + 5 * li] for li in range(nl)]
    rows, R = plan["rows"], plan_rule.F32_ROWS
    x0_ws = torch.zeros(rows, in_pad)
    act_ws = [torch.zeros(rows, lay[li][1]) for li in range(nl)]
    dh_ws = [torch.zeros(rows, lay[li][1]) for li in range(nl)]
    db_slabs = torch.zeros(plan["walk_blocks"], b.numel())
    dx0_all = torch.zeros(rows, in_pad)
    g_pad = torch.zeros(rows, lay[-1][1])
    g_pad[:n, : g.shape[1]] = g
    wid = max(desc[6], lay[-1][1])
    for blk in range(plan["walk_blocks"]):
        r = slice(blk * R, (blk + 1) * R)
        x0 = f32_encode_tile(x, packed, blk * R)
        x0_ws[r] = x0.t()
        h = torch.full((wid, R), float("nan"))
        spill = torch.full((plan_rule.f32_spill_rows(wid), R), float("nan"))
        masks = []
        for li in range(nl - (0 if out_act == "sigmoid" else 1)):
            k_pad, n_pad, skip, w_off, b_off = lay[li]
            k0 = in_pad if li == 0 or skip else 0
            pre = torch.zeros(R, n_pad)
            mask = torch.zeros(R, n_pad, dtype=torch.bool)
            for c0, nc in plan_rule.f32_pass_cols(n_pad):
                acc = f32_product(torch.cat([x0[:k0], h[: k_pad - k0]]), f32_operand(w, w_off, n_pad, c0, nc, k_pad))
                acc = acc + b[b_off + c0 : b_off + c0 + nc]
                if li < nl - 1:
                    acc = torch.relu(acc)
                    mask[:, c0 : c0 + nc] = _f32_mask_roundtrip(acc, nc)
                    f32_store(h, spill, c0, acc.t(), k0 < k_pad)
                pre[:, c0 : c0 + nc] = acc
            if li < nl - 1:
                act_ws[li][r] = pre
                masks.append(mask)
                if k0 < k_pad:
                    f32_copy_spill(h, spill, n_pad)
        li = nl - 1
        k_pad, n_pad, skip, _, b_off = lay[li]
        reads_h = out_act == "sigmoid" and (in_pad if li == 0 or skip else 0) < k_pad
        v = g_pad[r].clone()
        if out_act == "sigmoid":
            y = torch.sigmoid(pre)
            v = v * y * (1.0 - y)
        for c0, nc in plan_rule.f32_pass_cols(n_pad):
            db_slabs[blk, b_off + c0 : b_off + c0 + nc] = _f32_db_partial(v[:, c0 : c0 + nc], nc)
            f32_store(h, spill, c0, v[:, c0 : c0 + nc].t(), reads_h)
        if reads_h:
            f32_copy_spill(h, spill, n_pad)
        dh_ws[li][r] = v
        dx0 = torch.zeros(R, in_pad)
        for li in reversed(range(nl)):
            k_pad, n_pad, skip, w_off, b_off = lay[li]
            if li == 0 or skip:
                for c0, nc in plan_rule.f32_pass_cols(in_pad):
                    dx0[:, c0 : c0 + nc] += f32_product(h[:n_pad], f32_operand(wt, w_off, k_pad, c0, nc, n_pad))
            if li > 0:
                h0 = in_pad if skip else 0
                prev = lay[li - 1]
                dh = torch.zeros(R, prev[1])
                for c0, nc in plan_rule.f32_pass_cols(prev[1]):
                    v = f32_product(h[:n_pad], f32_operand(wt, w_off, k_pad, h0 + c0, nc, n_pad))
                    v = v * masks[li - 1][:, c0 : c0 + nc]
                    db_slabs[blk, prev[4] + c0 : prev[4] + c0 + nc] = _f32_db_partial(v, nc)
                    f32_store(h, spill, c0, v.t(), True)
                    dh[:, c0 : c0 + nc] = v
                f32_copy_spill(h, spill, prev[1])
                dh_ws[li - 1][r] = dh
        dx0_all[r] = dx0
    # dW: every element summed over a split's points in order, the slabs in order
    dw = torch.zeros(w.numel())
    for s in range(plan["splits"]):
        slab = torch.zeros(w.numel())
        for p in range(s * plan["rows_per_split"], min((s + 1) * plan["rows_per_split"], rows)):
            for li in range(nl):
                k_pad, n_pad, skip, w_off, _ = lay[li]
                if li == 0:
                    x_in = x0_ws[p]
                elif skip:
                    x_in = torch.cat([x0_ws[p], act_ws[li - 1][p]])
                else:
                    x_in = act_ws[li - 1][p]
                slab[w_off : w_off + k_pad * n_pad] += (x_in[:, None] * dh_ws[li][p][None, :]).reshape(-1)
        dw += slab
    groups = [torch.zeros(b.numel()) for _ in range(-(-plan["walk_blocks"] // plan_rule.SUM_GROUP))]
    for blk in range(plan["walk_blocks"]):
        groups[blk // plan_rule.SUM_GROUP] += db_slabs[blk]
    db = torch.zeros(b.numel())
    for part in groups:
        db += part
    dws, dbs = fm.unpack_grads(dw, db, desc, [tuple(t.shape) for t in ws])
    dx0 = dx0_all[:n, :enc_dim]
    dx = fm._encode_bwd(x, dx0, enc) if enc is not None else dx0
    return dx, dws, dbs


@pytest.mark.parametrize("n", [1, 77, 300])
@pytest.mark.parametrize("name", ["wide_skip_enc", "head_sigmoid", "pass_272", "pass_spill_skip", "pass_wide_input"])
def test_f32_backward_emulation_matches_plain(name, n):
    """The f32 backward's walk blocks, register-tile db order and mask
    words, W / W^T slices, column passes and spill rows, dW splits and
    fixed-order slab sums give the
    plain f32 backward's dx, dW and db, for ragged N; the dW tasks of the
    plan's tiles (128 rows x the layer's register-tile width) cover every
    dW element once."""
    from tests.test_torch_fused_mlp import F32_EMULATION_STACKS, _stack

    spec = F32_EMULATION_STACKS[name]
    in_dim, _, skips, enc, out_act = spec
    x, ws, bs = _stack(spec, seed=9, n=n)
    g = torch.as_tensor(np.random.default_rng(10).normal(size=(n, spec[1][-1])).astype(np.float32))
    want_dx, want_dws, want_dbs = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, enc, torch.float32)
    dx, dws, dbs = _emulate_f32_bwd(x, g, ws, bs, skips, enc, out_act)
    # the same f32 terms in other orders (the plain version's matmuls and
    # sums): relative L2 1e-5 per tensor; dx passes through the encoding
    # backward, whose sums over frequencies cancel, so an element by element
    # bound would not be one
    for a, b in zip([dx] + dws + dbs, [want_dx] + want_dws + want_dbs):
        assert a.shape == b.shape
        assert rel_l2(a, b) <= 1e-5
    desc = fm.prepare(in_dim, ws, bs, out_act, skips, enc, torch.float32).desc
    covered = 0
    for k_pad, n_pad, *_ in plan_rule.layers(desc):
        tm, tn = plan_rule.F32_DW_ROWS, plan_rule.f32_tile_width(n_pad)
        tiles = [(m0, n0) for m0 in range(0, k_pad, tm) for n0 in range(0, n_pad, tn)]
        covered += sum(min(tm, k_pad - m0) * min(tn, n_pad - n0) for m0, n0 in tiles)
    assert covered == sum(k * m for k, m, *_ in plan_rule.layers(desc))
