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

The packing tests emulate, on the CPU, how the CUDA kernel reads the packed
weights, so a layout fault shows here and not only on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerfstudio_thermal_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp

from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

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
    K 64 / 320 and fits the kernel's shared memory."""
    dims = [(63, 256), (256, 256), (256, 256), (256, 256), (319, 256), (256, 256), (256, 256), (256, 16)]
    ws = [torch.zeros(i, o) for i, o in dims]
    bs = [torch.zeros(o) for _, o in dims]
    w, b, desc, in_pad, hid_pad = fm.pack(ws, bs, (4,), 63, torch.bfloat16)
    assert (in_pad, hid_pad) == (64, 256)
    assert [desc[5 * i] for i in range(8)] == [64, 256, 256, 256, 320, 256, 256, 256]
    assert fm.smem_bytes(in_pad, hid_pad, torch.bfloat16) <= fm.SMEM_LIMIT
    assert fm.smem_bytes(in_pad, hid_pad, torch.float32) <= fm.SMEM_LIMIT


def test_cuda_path_has_no_fallback(monkeypatch):
    """A tensor that is neither on the CPU nor on CUDA is refused, and the
    kernel's backward raises instead of returning gradients."""
    x = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError):
        fm.fused_mlp(x, [torch.zeros(27, 4, device="meta")], [torch.zeros(4, device="meta")])
    with pytest.raises(NotImplementedError):
        fm._FusedMLPForward.backward(None, torch.zeros(1))
