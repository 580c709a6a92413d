"""The port's fused-MLP module against the JAX package's Pallas fused_mlp.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests
do. Both get the same numpy inputs and parameters.

Tolerances:
- f32 compute: atol = rtol = 1e-4. Both sides do exact f32 products and
  sums, in another order; sin/cos of arguments up to ~2*pi*8 add ~1e-6.
- bf16 compute: atol = rtol = 2e-2. Every layer rounds to bf16 (relative
  step 2^-8 ~ 4e-3); a different summation order can flip one rounding,
  and a flip moves later layers by about one bf16 step.

The packing tests emulate, on the CPU, how the CUDA kernels read the packed
weights, so a layout fault shows here and not only on the card: the
mma-fragment order (the narrow forward and the backward), the narrow
forward's data flow (16-row warp tiles, each layer's rounded accumulators
as the next layer's A), and the wgmma path's swizzled K-slices, unpacked by
an independent reading of the byte layout. These hold exactly (1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp

from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
from tests import torch_fused_mlp_plan as plan_rule

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_case(seed, in_dim, widths, out_dim, skips, freq_encoding, n):
    rng = np.random.default_rng(seed)
    enc_dim = fm.encoding_dim(in_dim, freq_encoding)
    ws, bs = [], []
    prev = enc_dim
    dims = list(widths) + [out_dim]
    for i, dout in enumerate(dims):
        din = prev + (enc_dim if (i in skips and i != 0) else 0)
        ws.append((rng.normal(size=(din, dout)) / np.sqrt(din)).astype(np.float32))
        bs.append((rng.normal(size=(dout,)) * 0.1).astype(np.float32))
        prev = dout
    x = rng.uniform(0.0, 1.0, size=(n, in_dim)).astype(np.float32)
    return x, ws, bs


CASES = {
    # name: (in_dim, hidden widths, out_dim, skips, freq_encoding, out_act)
    "enc_skip": (3, (32, 32, 32, 32), 8, (2,), (4, 0.0, 3.0, True), None),
    "enc_noskip_sigmoid": (3, (32, 32, 32), 5, (), (3, 0.0, 2.0, True), "sigmoid"),
    "enc_no_input": (3, (16, 16), 4, (1,), (2, 0.0, 1.0, False), None),
    "no_enc_skip": (12, (32, 32, 32), 8, (2,), None, None),
    "no_enc_sigmoid": (12, (32, 32), 3, (), None, "sigmoid"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_fused_mlp(case, dtype):
    in_dim, widths, out_dim, skips, enc, out_act = CASES[case]
    x, ws, bs = make_case(0, in_dim, widths, out_dim, skips, enc, n=300)
    want = jax_fused_mlp(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        "relu", out_act, 128, True, skips, enc, dtype,
    )
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(
        torch.as_tensor(x), [torch.as_tensor(w) for w in ws], [torch.as_tensor(b) for b in bs],
        "relu", out_act, skips, enc, TORCH_DTYPE[dtype],
    )
    assert fm.fused_mlp.launches == before  # the CPU path launches nothing
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (300, out_dim)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype], rtol=TOL[dtype]
    )


def test_frequencies_and_encoding_layout():
    enc = (4, 0.0, 3.0, True)
    f = fm.frequencies(enc, "cpu")
    np.testing.assert_allclose(f.numpy(), 2 * np.pi * 2.0 ** np.arange(4), rtol=1e-6)
    x = torch.tensor([[0.1, 0.2, 0.3]])
    e = fm.encode(x, enc)
    assert e.shape == (1, 27)
    # [sin(d*F + k) ..., cos(d*F + k) ..., x]
    np.testing.assert_allclose(e[0, 1 * 4 + 2].item(), np.sin(np.float32(0.2) * f[2].item()), rtol=1e-5)
    np.testing.assert_allclose(e[0, 12 + 2 * 4 + 3].item(), np.cos(np.float32(0.3) * f[3].item()), rtol=1e-5)
    np.testing.assert_allclose(e[0, 24:].numpy(), [0.1, 0.2, 0.3])


def _unpack_bf16(flat, k_pad, n_pad):
    """Inverse of the fragment packing, written from the PTX fragment
    layout of mma.m16n8k16 (B, .col): lane = 4 * groupID + threadID_in_group;
    b0,b1 at k = 2 * tig + (0, 1), b2,b3 at k = 2 * tig + 8 + (0, 1),
    n = groupID; a 16-byte lane load holds n-tile 2p then 2p + 1."""
    w = torch.zeros(k_pad, n_pad, dtype=flat.dtype)
    vals = flat.reshape(k_pad // 16, n_pad // 16, 32, 8)
    for kt in range(k_pad // 16):
        for p in range(n_pad // 16):
            for lane in range(32):
                g, tig = lane // 4, lane % 4
                for j in range(8):
                    half, r = divmod(j, 4)
                    k = kt * 16 + 2 * tig + (r % 2) + 8 * (r // 2)
                    n = (2 * p + half) * 8 + g
                    w[k, n] = vals[kt, p, lane, j]
    return w


def _emulate_kernel(x, ws, bs, skips, enc, out_act, dtype):
    """The kernel's data flow on the CPU: padded x0 tile, padded hidden
    buffers, each layer reading its K segments [x0 | h] from the packed
    weights."""
    n, in_dim = x.shape
    enc_dim = fm.encoding_dim(in_dim, enc)
    w, b, desc, in_pad, hid_pad = fm.pack(ws, bs, skips, enc_dim, dtype)
    x0 = fm.encode(x, enc) if enc is not None else x
    x0 = torch.nn.functional.pad(x0, (0, in_pad - enc_dim)).to(dtype)
    h = None
    for li in range(len(ws)):
        k_pad, n_pad, skip, w_off, b_off = desc[5 * li : 5 * li + 5]
        flat = w[w_off : w_off + k_pad * n_pad]
        wl = _unpack_bf16(flat, k_pad, n_pad) if dtype == torch.bfloat16 else flat.reshape(k_pad, n_pad)
        inp = x0 if li == 0 else (torch.cat([x0, h], -1) if skip else h)
        assert inp.shape[1] == k_pad
        pre = inp.float() @ wl.float() + b[b_off : b_off + n_pad]
        last = li == len(ws) - 1
        act = out_act if last else "relu"
        h = fm._apply_act(pre, act).to(dtype)
        assert last or h.shape[1] <= hid_pad
    return h[:, : ws[-1].shape[1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packing_emulation_matches_plain(dtype):
    skips, enc = (2,), (4, 0.0, 3.0, True)
    x, ws, bs = make_case(1, 3, (40, 24, 24), 6, skips, enc, n=37)
    x, ws, bs = torch.as_tensor(x), list(map(torch.as_tensor, ws)), list(map(torch.as_tensor, bs))
    want = fm.fused_mlp_plain(x, ws, bs, "relu", "sigmoid", skips, enc, dtype)
    got = _emulate_kernel(x, ws, bs, skips, enc, "sigmoid", dtype)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=1e-6, rtol=1e-6)


def test_base_field_shapes_fit_the_kernel():
    """The main path's base MLP (63 -> 8 x 256, skip at 4 -> 16) packs to
    K 64 / 320 and fits the kernels' shared memory (the path rule's copy,
    held to the kernel library on the card)."""
    dims = [(63, 256), (256, 256), (256, 256), (256, 256), (319, 256), (256, 256), (256, 256), (256, 16)]
    ws = [torch.zeros(i, o) for i, o in dims]
    bs = [torch.zeros(o) for _, o in dims]
    w, b, desc, in_pad, hid_pad = fm.pack(ws, bs, (4,), 63, torch.bfloat16)
    assert (in_pad, hid_pad) == (64, 256)
    assert [desc[5 * i] for i in range(8)] == [64, 256, 256, 256, 320, 256, 256, 256]
    full = fm.prepare(63, ws, bs, None, (4,), None, torch.bfloat16).desc
    assert plan_rule.wg_smem(full) <= plan_rule.SMEM_LIMIT and plan_rule.forward_path(full, True) == "wgmma"
    assert plan_rule.f32_smem(full) <= plan_rule.SMEM_LIMIT and plan_rule.forward_path(full, False) == "f32"


def test_cuda_path_has_no_fallback(monkeypatch):
    """A tensor that is neither on the CPU nor on CUDA is refused in both
    directions, and the backward kernel's wrapper refuses weights packed
    without their transposes instead of computing anything else."""
    x = torch.zeros(4, 3, device="meta")
    w, b = [torch.zeros(27, 4, device="meta")], [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError):
        fm.fused_mlp(x, w, b)
    with pytest.raises(ValueError):
        fm.fused_mlp_bwd(x, torch.zeros(4, 4, device="meta"), w, b)
    packed = fm.prepare(3, [torch.zeros(27, 4)], [torch.zeros(4)], None, (), (4, 0.0, 3.0, True), torch.bfloat16)
    with pytest.raises(ValueError, match="transposed"):
        fm.launch_bwd(torch.zeros(4, 3), torch.zeros(4, 4, dtype=torch.bfloat16), packed)


# The main path's stacks: (in_dim, layer widths incl. output, skips, freq_encoding, out_act)
PROPOSAL_F5 = (3, (64, 64, 1), (), (5, 0.0, 4.0, True), None)
PROPOSAL_F7 = (3, (64, 64, 1), (), (7, 0.0, 6.0, True), None)
COLOUR_HEAD = (63, (64, 64, 3), (), None, "sigmoid")
BASE_8X256 = (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None)
# the frequency NeRF's base stacks, on inputs encoded outside the kernel
# (vanilla-nerf 63 wide, mipnerf's integrated encoding 99): two x0 atoms at 99
NERF_BASE = (63, (256,) * 8, (4,), None, None)
MIPNERF_BASE = (99, (256,) * 8, (4,), None, None)


def _stack(spec, seed=0, n=37):
    in_dim, dims, skips, enc, out_act = spec
    x, ws, bs = make_case(seed, in_dim, dims[:-1], dims[-1], skips, enc, n)
    return torch.as_tensor(x), list(map(torch.as_tensor, ws)), list(map(torch.as_tensor, bs))


def _emulate_narrow(x, packed, out_act):
    """The narrow forward's data flow on the CPU: 128-point tiles, each
    warp's 16 rows on their own; the encoding from one product per
    (dimension, frequency) giving the sin and the cos column; each layer's
    A from the mma-fragment weights, bias and relu in f32 on the
    accumulator, rounded to bf16 as the next layer's A."""
    n, in_dim = x.shape
    nl, _, in_pad, enc_dim, nf_per, include = packed.desc[:6]
    f = packed.freqs
    out = []
    for row0 in range(0, n, 128):
        for r0 in range(row0, min(row0 + 128, n), 16):
            xr = x[r0 : r0 + 16]
            x0 = torch.zeros(xr.shape[0], in_pad)
            if nf_per:
                pre = (xr[:, :, None] * f).reshape(xr.shape[0], -1)  # column d * F + k
                nf = pre.shape[1]
                x0[:, :nf], x0[:, nf : 2 * nf] = torch.sin(pre), torch.cos(pre)
                if include:
                    x0[:, 2 * nf : enc_dim] = xr
            else:
                x0[:, :in_dim] = xr
            a = x0.to(torch.bfloat16)
            for li in range(nl):
                k_pad, n_pad, skip, w_off, b_off = packed.desc[9 + 5 * li : 14 + 5 * li]
                assert not skip and a.shape[1] == k_pad
                wl = _unpack_bf16(packed.weights[w_off : w_off + k_pad * n_pad], k_pad, n_pad)
                acc = a.float() @ wl.float() + packed.biases[b_off : b_off + n_pad]
                if li < nl - 1:
                    a = torch.relu(acc).to(torch.bfloat16)
                else:
                    a = fm._apply_act(acc, out_act).to(torch.bfloat16)
            out.append(a[:, : packed.out_dim])
    return torch.cat(out)


@pytest.mark.parametrize("spec,n", [(PROPOSAL_F5, 300), (PROPOSAL_F7, 130), (COLOUR_HEAD, 77), (COLOUR_HEAD, 1)])
def test_narrow_forward_emulation_matches_plain(spec, n):
    x, ws, bs = _stack(spec, seed=3, n=n)
    in_dim, _, skips, enc, out_act = spec
    packed = fm.prepare(in_dim, ws, bs, out_act, skips, enc, torch.bfloat16)
    assert plan_rule.forward_path(packed.desc, True) == "narrow" and packed.weights_wg is None
    want = fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, enc, torch.bfloat16)
    got = _emulate_narrow(x, packed, out_act)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=1e-6, rtol=1e-6)


def _unpack_wgmma_slice(flat, nw):
    """One K-slice of the wgmma order back to [64 k, nw], read from the
    byte layout: column n's 64 k values are a 128-byte row at n * 128, its
    16-byte chunk c (k = 8 c .. 8 c + 7) at byte 16 (c XOR n % 8)."""
    raw = flat.reshape(-1)
    m = torch.zeros(64, nw, dtype=flat.dtype)
    for n in range(nw):
        for k in range(64):
            byte = n * 128 + 16 * ((k // 8) ^ (n % 8)) + 2 * (k % 8)
            m[k, n] = raw[byte // 2]
    return m


@pytest.mark.parametrize("spec", [BASE_8X256, (3, (40, 24, 24, 6), (2,), (4, 0.0, 3.0, True), "sigmoid"),
                                  (32, (128, 128, 128, 16), (2,), None, None), MIPNERF_BASE])
def test_wgmma_layout_unpacks_to_the_weights(spec):
    """Every layer's slices in the wgmma order hold exactly its padded
    [x0 rows | h rows] weights: x0's rows first (layer 0 and the skip
    layers), then the previous layer's, zero beyond the true widths; the
    plan's offsets and the array's length agree."""
    in_dim, dims, skips, enc, out_act = spec
    _, ws, bs = _stack(spec)
    packed = fm.prepare(in_dim, ws, bs, out_act, skips, enc, torch.bfloat16)
    assert plan_rule.forward_path(packed.desc, True) == "wgmma"
    plan, total = plan_rule.wgmma_plan(packed.desc)
    enc_dim, in_pad = packed.desc[3], packed.desc[2]
    mats, flags, _ = fm._pad_layers(ws, skips, enc_dim, torch.bfloat16)
    weights_wg = fm._pack_wgmma(mats, flags, in_pad, plan, total)
    assert weights_wg.numel() == total
    prev_w = None
    for li, ((nw, slices_x0, slices_h, off), w) in enumerate(zip(plan, ws)):
        k_pad, n_pad, skip = packed.desc[9 + 5 * li : 12 + 5 * li]
        assert nw >= n_pad and nw in plan_rule.WGMMA_WIDTHS and (nw >= 64 or li == len(ws) - 1)
        assert slices_x0 == (-(-in_pad // 64) if li == 0 or skip else 0)
        assert slices_h == (0 if li == 0 else prev_w // 64)
        rows = []
        for _ in range(slices_x0 + slices_h):
            rows.append(_unpack_wgmma_slice(weights_wg[off : off + 64 * nw], nw))
            off += 64 * nw
        # expected: the true weights placed at their padded rows and columns
        want = []
        x0_part = w[:enc_dim] if (li == 0 or skip) else None
        h_part = w[enc_dim:] if skip else (w if li > 0 else None)
        for part, slices in ((x0_part, slices_x0), (h_part, slices_h)):
            if slices:
                m = torch.zeros(64 * slices, nw)
                m[: part.shape[0], : part.shape[1]] = part
                want.append(m.to(torch.bfloat16))
        assert torch.equal(torch.cat(rows), torch.cat(want)), li
        prev_w = nw
    assert off == total


def test_forward_path_rule():
    """The proposal stacks and the colour head take the narrow one-pass
    kernel, the 8 x 256 stacks (with or without the skip, the NeRF stacks
    with their pre-encoded 63- or 99-wide input) the wgmma kernel,
    f32 compute the f32 kernel; a stack wider than 256 has no bf16 kernel.
    The rule's copy, held to the kernel library on the card
    (test_torch_cuda_kernels.py test_forward_plan_matches_the_library)."""
    for spec, path in ((PROPOSAL_F5, "narrow"), (PROPOSAL_F7, "narrow"), (COLOUR_HEAD, "narrow"),
                       (BASE_8X256, "wgmma"), ((3, (256,) * 7 + (16,), (), (10, 0.0, 9.0, True), None), "wgmma"),
                       ((3, (64, 64, 64, 16), (2,), (4, 0.0, 3.0, True), None), "wgmma"),
                       (NERF_BASE, "wgmma"), (MIPNERF_BASE, "wgmma")):
        in_dim, _, skips, enc, out_act = spec
        _, ws, bs = _stack(spec)
        desc = fm.prepare(in_dim, ws, bs, out_act, skips, enc, torch.bfloat16).desc
        assert plan_rule.forward_path(desc, True) == path, spec
        assert plan_rule.forward_path(desc, False) == "f32"
    _, ws, bs = _stack((3, (272, 16), (), (4, 0.0, 3.0, True), None))
    desc = fm.prepare(3, ws, bs, None, (), (4, 0.0, 3.0, True), torch.bfloat16).desc
    assert plan_rule.forward_path(desc, True) is None and plan_rule.forward_path(desc, False) == "f32"
