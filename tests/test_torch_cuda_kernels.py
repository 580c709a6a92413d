"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; without them every test skips
with a reason. The module imports torch only (no JAX), so it runs on a
machine with a card and no JAX installation:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Fused MLP (also on the frequency NeRF's base stacks: 63- and 99-wide
pre-encoded inputs, 8 x 256 with the last layer 256), tolerances as in
tests/test_torch_fused_mlp.py: f32 1e-4 (same
exact products and sums in another order), bf16 2e-2 (one flipped bf16
rounding moves later layers by about one bf16 step). The backward is held
per tensor by the relative L2 error ||got - want|| / ||want||: at most 1e-4
in f32 (exact products, another summation order over N) and 3e-2 in bf16
(one flipped bf16 rounding of dh or of a relu mask at a tie moves a
layer's dW by about 2^-8 relative), and every value must be finite. Both
forward paths of bf16 (the one-pass narrow kernel of a 64-wide stack, the
wgmma kernel of an 8 x 256 one) and both backward paths (the one-pass
kernel, the walk / dW / sums) give bitwise-equal results over two
launches.

Hash grid, as chip_smoke.py holds it: forward within 1e-6 absolute (the
same f32 products and sums in the same order), plus one bf16 step for a
bf16 output; table gradient relative L2 1e-4 (a warp's equal rows summed in
a shuffle tree, then atomics in a run-dependent order); position gradient
relative L2 1e-5 (the sum over levels in another order). Besides uniform
points, the cases hold the points the tiled kernels find hard: ray-major
depth-sorted samples, every point in one cell, N one past a tile multiple,
whole tiles with g = 0, and points on integer coordinates at every level.

The fused MLP also runs on the density TV loss's 35,000 raw points
(mostly zeroed) with the TV loss's cotangent; the hash kernels also on
nerfacto-big's and nerfacto-huge's grids (2^21 rows a level, up to 8192)
and on the huge model's 7-level proposal grid.

Fused ray-march and whole-field kernels, with the fused MLP's tolerances:
outputs 2e-2 (bf16) / 1e-4 (f32) absolute plus relative, every gradient
(d_o, d_d, d_t, d_emb, every dW and db) relative L2 3e-2 / 1e-4. The rays
include samples far outside the unit ball, samples that leave the box
(selector 0) and samples with tied inf-norm components. The whole field
runs with C = 3, 1 and 4 colour channels (the shared density mode's RGBT
head). The head input the
whole-field forward writes for its backward equals the plain version's of
the same base output bitwise, and the output is bitwise the same without
it. The position gradient of the hash grid is bitwise the same from run to
run.

The hash position gradient's VJP (the SDF grid's second derivative) is
held against its plain version for every output set: dg bitwise and
within relative L2 1e-5 (it sums the corners in the same order), d_pos2
1e-5 (the levels in another order), d_table 1e-4 (row 7's atomics), at N
off the 256-point tile, at neus-facto's exact call, on rays with g zero
on some levels and points, on grid coordinates and for a misaligned g; dg
and d_pos2 are bitwise the same from run to run; an eikonal loss through
hash_encode on the card gives the CPU's gradients (relative L2 1e-4), with the launches that the first-order
pass (no table scatter) and the backward imply.
"""

import numpy as np
import pytest
import torch

from nerfstudio_thermal_torch.configs.method_configs import get_method_config
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
from nerfstudio_thermal_torch.ops import encodings as enc
from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr
from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th
from tests import torch_fused_mlp_plan as plan_rule

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(gen, dims, skips, enc_dim, device):
    ws, bs, prev = [], [], enc_dim
    for i, dout in enumerate(dims):
        din = prev + (enc_dim if (i in skips and i != 0) else 0)
        ws.append((torch.randn(din, dout, generator=gen) / din**0.5).to(device))
        bs.append((torch.randn(dout, generator=gen) * 0.1).to(device))
        prev = dout
    return ws, bs


CASES = [
    # (in_dim, layer widths incl. output, skips, freq_encoding, out_act, dtype, n)
    (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None, torch.bfloat16, 65536),
    (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None, torch.float32, 8192),
    (3, (128,) * 3 + (3,), (), (6, 0.0, 5.0, True), "sigmoid", torch.bfloat16, 10000),
    (32, (128,) * 3 + (16,), (2,), None, None, torch.bfloat16, 4099),
    (3, (256,) * 7 + (16,), (), (10, 0.0, 9.0, True), None, torch.bfloat16, 12345),
    # 64-wide stacks (the backward's one-pass kernel): the proposals, with a
    # ragged N and fewer points than one tile, and the colour head, at N = 1 too
    (3, (64, 64, 1), (), (5, 0.0, 4.0, True), None, torch.bfloat16, 100_003),
    (3, (64, 64, 1), (), (7, 0.0, 6.0, True), None, torch.bfloat16, 100),
    (63, (64, 64, 3), (), None, "sigmoid", torch.bfloat16, 65536),
    (63, (64, 64, 3), (), None, "sigmoid", torch.bfloat16, 1),
    # the frequency NeRF's base stacks on pre-encoded inputs (vanilla-nerf
    # 63 wide, mipnerf 99: two x0 atoms), the last layer 256 wide
    (63, (256,) * 8, (4,), None, None, torch.bfloat16, 65536),
    (99, (256,) * 8, (4,), None, None, torch.bfloat16, 20001),
    (63, (256,) * 8, (4,), None, None, torch.float32, 4096),
    (99, (256,) * 8, (4,), None, None, torch.float32, 3001),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain(cuda, case):
    in_dim, dims, skips, enc, out_act, dtype, n = CASES[case]
    gen = torch.Generator().manual_seed(case)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), cuda)
    x = torch.rand(n, in_dim, generator=gen).to(cuda)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(x, ws, bs, "relu", out_act, skips, enc, dtype)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    want = fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, enc, dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), atol=tol, rtol=tol
    )


FWD_PATH_CASES = [
    # (in_dim, layer widths incl. output, skips, freq_encoding, out_act, n, path): the
    # main path's stacks at its shapes (row 1 / the cross densities, the two
    # proposal stacks, the colour head) and at a ragged N
    (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None, 1 << 20, "wgmma"),
    (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None, 777_777, "wgmma"),
    (3, (64, 64, 1), (), (5, 0.0, 4.0, True), None, 4_194_304, "narrow"),
    (3, (64, 64, 1), (), (7, 0.0, 6.0, True), None, 1_572_864, "narrow"),
    (3, (64, 64, 1), (), (5, 0.0, 4.0, True), None, 100_003, "narrow"),
    (63, (64, 64, 3), (), None, "sigmoid", 1 << 20, "narrow"),
    (63, (64, 64, 3), (), None, "sigmoid", 1, "narrow"),
]


@pytest.mark.parametrize("case", range(len(FWD_PATH_CASES)))
def test_forward_paths_match_plain(cuda, case):
    """Each bf16 forward path on the stacks the rule sends to it: the path
    that launched, the plain version's values, and the same bits from a
    second launch (the narrow kernel's persistent CTAs and the wgmma
    kernel's tiles depend only on the grid)."""
    in_dim, dims, skips, enc, out_act, n, path = FWD_PATH_CASES[case]
    gen = torch.Generator().manual_seed(400 + case)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), cuda)
    x = torch.rand(n, in_dim, generator=gen).to(cuda)
    packed = fm.prepare(in_dim, ws, bs, out_act, skips, enc, torch.bfloat16)
    assert packed.fwd_path == path and (packed.weights_wg is not None) == (path == "wgmma")
    before = fm.fused_mlp.path_launches[path]
    first = fm.launch(x, packed)
    second = fm.launch(x, packed)
    torch.cuda.synchronize()
    assert fm.fused_mlp.path_launches[path] == before + 2
    assert torch.equal(first, second)
    want = fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, enc, torch.bfloat16)
    _close(first, want, torch.bfloat16)


PLAN_CASES = [
    # (in_dim, layer widths incl. output, skips, freq_encoding, out_act): the
    # main path's stacks, a narrow stack with a skip, a ragged skip stack,
    # a 128-wide one, and stacks too wide for the bf16 kernels (272) and for
    # the f32 kernel too (512)
    (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None),
    (3, (64, 64, 1), (), (5, 0.0, 4.0, True), None),
    (3, (64, 64, 1), (), (7, 0.0, 6.0, True), None),
    (63, (64, 64, 3), (), None, "sigmoid"),
    (3, (64, 64, 64, 16), (2,), (4, 0.0, 3.0, True), None),
    (3, (40, 24, 24, 6), (2,), (4, 0.0, 3.0, True), "sigmoid"),
    (32, (128, 128, 128, 16), (2,), None, None),
    (3, (272, 16), (), (4, 0.0, 3.0, True), None),
    (3, (512, 16), (), (4, 0.0, 3.0, True), None),
    (63, (256,) * 8, (4,), None, None),
    (99, (256,) * 8, (4,), None, None),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_forward_plan_matches_the_library(cuda, case):
    """The CPU tests' copy of the forward's path rule and wgmma plan
    (tests/torch_fused_mlp_plan.py) gives what the kernel library decides,
    for both compute dtypes; a stack no kernel takes raises in prepare."""
    in_dim, dims, skips, enc, out_act = PLAN_CASES[case]
    gen = torch.Generator().manual_seed(600 + case)
    for dtype in (torch.bfloat16, torch.float32):
        ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), torch.device("cpu"))
        desc = fm.prepare(in_dim, ws, bs, out_act, skips, enc, dtype).desc
        want = plan_rule.forward_path(desc, dtype == torch.bfloat16)
        if want is None:
            with pytest.raises(ValueError, match="no .* forward kernel"):
                fm.forward_plan(desc, dtype)
            with pytest.raises(ValueError, match="no .* forward kernel"):
                fm.prepare(in_dim, [w.to(cuda) for w in ws], [b.to(cuda) for b in bs], out_act, skips, enc, dtype)
            continue
        path, plan, total = fm.forward_plan(desc, dtype)
        assert path == want, (dtype, path, want)
        if path == "wgmma":
            want_plan, want_total = plan_rule.wgmma_plan(desc)
            assert (plan, total) == (want_plan, want_total)
        else:
            assert (plan, total) == ([], 0)


@pytest.mark.parametrize("case", [0, 3, 9, 10, 11, 12])
def test_walk_smem_matches_the_library(cuda, case):
    """The CPU tests' copy of the backward walk's shared memory
    (tests/torch_fused_mlp_plan.py walk_smem) gives what the library plans,
    in both compute dtypes, with and without a sigmoid head; the NeRF
    stacks' walk fits without one."""
    import ctypes

    in_dim, dims, skips, enc, _, _, _ = CASES[case]
    gen = torch.Generator().manual_seed(700 + case)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), torch.device("cpu"))
    lib = fm.load_library("bwd")
    for dtype in (torch.bfloat16, torch.float32):
        for out_act in (None, "sigmoid"):
            desc = fm.prepare(in_dim, ws, bs, out_act, skips, enc, dtype).desc
            out = (ctypes.c_longlong * 4)()
            c_desc = (ctypes.c_int * len(desc))(*desc)
            assert lib.fused_mlp_bwd_sizes(c_desc, len(desc), 4096, int(dtype == torch.bfloat16), 0, out) == 0
            if not out[3]:  # the walk (not the one-pass kernel)
                assert out[2] == plan_rule.walk_smem(desc, dtype == torch.bfloat16), (dtype, out_act)
            if case >= 9 and out_act is None:
                assert out[2] <= fm.SMEM_LIMIT


BWD_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


def _rel_l2(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_backward_kernel_matches_plain(cuda, case):
    in_dim, dims, skips, enc, out_act, dtype, n = CASES[case]
    gen = torch.Generator().manual_seed(100 + case)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), cuda)
    x = torch.rand(n, in_dim, generator=gen).to(cuda)
    g = torch.randn(n, dims[-1], generator=gen).to(cuda).to(dtype)
    before = fm.fused_mlp_bwd.launches
    dx, dws, dbs = fm.fused_mlp_bwd(x, g, ws, bs, "relu", out_act, skips, enc, dtype)
    torch.cuda.synchronize()
    assert fm.fused_mlp_bwd.launches == before + 1
    want_dx, want_dws, want_dbs = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, enc, dtype)
    for name, got, want in [("dx", dx, want_dx)] + [
        (f"{k}{i}", a, b) for k, ga, wa in (("dW", dws, want_dws), ("db", dbs, want_dbs))
        for i, (a, b) in enumerate(zip(ga, wa))
    ]:
        assert got.shape == want.shape, name
        assert bool(torch.isfinite(got).all()), name
        assert _rel_l2(got, want) <= BWD_TOL[dtype], (name, _rel_l2(got, want))


@pytest.mark.parametrize("n", [1, 100_003])
@pytest.mark.parametrize("name", sorted(plan_rule.F32_STACKS))
def test_f32_kernels_match_plain_and_repeat(cuda, name, n):
    """The exact-f32 forward and backward (csrc/fused_mlp_f32.cuh: register
    tiles on the CUDA cores, no tensor-core instruction) on every f32 stack
    of the registered methods, at one point and at a ragged N: the plain
    versions' values (1e-4, 1e-4 relative L2 a tensor), the f32 path, and
    the same bits from a second launch (each sum over k, over a block's
    points and over the slabs in one fixed order, no atomics)."""
    _check_f32_stack(cuda, plan_rule.F32_STACKS[name][0], 900 + n % 97 + len(name), n)


@pytest.mark.parametrize("n", [1, 100_003])
@pytest.mark.parametrize("name", sorted(plan_rule.F32_PASS_STACKS))
def test_f32_column_passes_match_plain_and_repeat(cuda, name, n):
    """Stacks with products wider than 256 (column passes, spill rows, a
    272-wide input) on the f32 kernels: the plain versions' values and
    gradients (1e-4) and the same bits from a second launch; the mirror's
    forward path and backward plan are the libraries'."""
    import ctypes

    spec = plan_rule.F32_PASS_STACKS[name]
    desc = _check_f32_stack(cuda, spec, 960 + n % 97 + len(name), n)
    assert fm.forward_plan(desc, torch.float32)[0] == plan_rule.forward_path(desc, False) == "f32"
    out = (ctypes.c_longlong * 4)()
    c_desc = (ctypes.c_int * len(desc))(*desc)
    assert fm.load_library("bwd").fused_mlp_bwd_sizes(c_desc, len(desc), n, 0, 0, out) == 0
    plan = plan_rule.f32_bwd_plan(desc, n, torch.cuda.get_device_properties(0).multi_processor_count)
    assert (out[0], out[1], out[2], out[3]) == (plan["ws_elems"], plan["scratch_floats"],
                                                plan_rule.walk_smem(desc, False), 0)


def _check_f32_stack(cuda, spec, seed, n):
    """One f32 stack at n points: forward and backward against the plain
    versions, two launches bit for bit; returns the descriptor."""
    in_dim, dims, skips, enc, out_act = spec
    gen = torch.Generator().manual_seed(seed)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), cuda)
    x = torch.rand(n, in_dim, generator=gen).to(cuda)
    g = torch.randn(n, dims[-1], generator=gen).to(cuda)
    packed = fm.prepare(in_dim, ws, bs, out_act, skips, enc, torch.float32, transposed=True)
    assert packed.fwd_path == "f32"
    f0 = fm.fused_mlp.path_launches["f32"]
    first, second = fm.launch(x, packed), fm.launch(x, packed)
    grads, again = fm.launch_bwd(x, g, packed), fm.launch_bwd(x, g, packed)
    torch.cuda.synchronize()
    assert fm.fused_mlp.path_launches["f32"] == f0 + 2
    assert torch.equal(first, second) and all(torch.equal(a, b) for a, b in zip(grads, again))
    _close(first, fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, enc, torch.float32), torch.float32)
    dws, dbs = fm.unpack_grads(grads[1], grads[2], packed.desc, packed.shapes)
    w_dx, w_dws, w_dbs = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, enc, torch.float32)
    named = [("dx", grads[0], w_dx)] + [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, w_dws))]
    _grads_close(named + [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, w_dbs))], torch.float32)
    return packed.desc


@pytest.mark.parametrize("name", sorted(plan_rule.F32_STACKS))
def test_f32_backward_plan_matches_the_library(cuda, name):
    """The CPU tests' copy of the f32 backward's plan
    (tests/torch_fused_mlp_plan.py f32_bwd_plan, walk_smem) gives the
    library's workspace, scratch and walk shared memory at the stack's
    main-path points, on this card's SM count."""
    import ctypes

    (in_dim, dims, skips, enc, out_act), n, _ = plan_rule.F32_STACKS[name]
    gen = torch.Generator().manual_seed(950)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), torch.device("cpu"))
    desc = fm.prepare(in_dim, ws, bs, out_act, skips, enc, torch.float32).desc
    out = (ctypes.c_longlong * 4)()
    c_desc = (ctypes.c_int * len(desc))(*desc)
    assert fm.load_library("bwd").fused_mlp_bwd_sizes(c_desc, len(desc), n, 0, 0, out) == 0
    plan = plan_rule.f32_bwd_plan(desc, n, torch.cuda.get_device_properties(0).multi_processor_count)
    assert (out[0], out[1], out[2], out[3]) == (plan["ws_elems"], plan["scratch_floats"],
                                                plan_rule.walk_smem(desc, False), 0)


F32_RAY_CASES = [
    # rows 3-6 at f32 at a ragged N: (kind, layer widths incl. output or C, rays, samples)
    ("ray", (256,) * 7 + (16,), 100_003, 1),
    ("ray", (64, 64, 1), 1, 1),
    ("field", 4, 100_003, 1),
    ("field", 1, 1, 1),
]


@pytest.mark.parametrize("case", range(len(F32_RAY_CASES)))
def test_f32_ray_and_field_kernels_at_ragged_n(cuda, case):
    """Rows 3-6 on the f32 kernels (the ray march's and the whole field's
    fills over csrc/fused_mlp_f32.cuh) at a ragged N and at one point: the
    plain versions' values and gradients (1e-4), and the same bits from a
    second launch."""
    kind, widths, r, s = F32_RAY_CASES[case]
    gen = torch.Generator().manual_seed(980 + case)
    dtype = torch.float32
    o, d, t = _rays(gen, max(r, 3), s, cuda)  # _rays sets rays 0-2 apart
    o, d, t = o[:r], d[:r], t[: r * s]
    if kind == "ray":
        enc, skips = ((10, 0.0, 9.0, True), (4,)) if widths[0] == 256 else ((5, 0.0, 4.0, True), ())
        ws, bs = _params(gen, widths, skips, fm.encoding_dim(3, enc), cuda)
        packed = fm.prepare(3, ws, bs, None, skips, enc, dtype, transposed=True)
        outs = [fr.launch_ray(o, d, t, s, packed) for _ in range(2)]
        want = fr.fused_ray_mlp_plain(o, d, t, ws, bs, s, None, skips, enc, dtype)
        g = torch.randn(r * s, widths[-1] + 1, generator=gen).to(cuda)
        runs = [fr.fused_ray_mlp_bwd(o, d, t, g[:, :-1].contiguous(), s, packed, True) for _ in range(2)]
        torch.cuda.synchronize()
        flat = [[*rn[0], rn[1], rn[2]] for rn in runs]
        dws, dbs = fm.unpack_grads(runs[0][1], runs[0][2], packed.desc, packed.shapes)
        w_o, w_d, w_t, w_dws, w_dbs = fr.fused_ray_mlp_bwd_plain(o, d, t, g, ws, bs, s, None, skips, enc, dtype, True)
        named = [("d_o", flat[0][0], w_o), ("d_d", flat[0][1], w_d), ("d_t", flat[0][2], w_t)]
        named += [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, w_dws))]
        named += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, w_dbs))]
    else:
        enc, skips, e = (10, 0.0, 9.0, True), (4,), 32
        bw, bb = _params(gen, (256,) * 7 + (16,), skips, 63, cuda)
        hw, hb = _params(gen, (64, 64, widths), (), 16 + 15 + e, cuda)
        emb = torch.randn(r, e, generator=gen).to(cuda)
        base = fm.prepare(3, bw, bb, None, skips, enc, dtype, transposed=True)
        head = fm.prepare(63, hw, hb, "sigmoid", (), None, dtype, transposed=True)
        fwd = [fr.launch_field(o, d, t, emb, s, base, head) for _ in range(2)]
        outs = [f[0] for f in fwd]
        want = fr.fused_field_mlp_plain(o, d, t, emb, bw, bb, hw, hb, s, skips, enc, dtype)
        g = torch.randn(r * s, widths + 2, generator=gen).to(cuda)
        runs = [fr.fused_field_mlp_bwd(o, d, t, emb, g, fwd[0][1], s, base, head) for _ in range(2)]
        torch.cuda.synchronize()
        flat = [[*rn[:4], *rn[4]] for rn in runs]
        dbw, dbb = fm.unpack_grads(runs[0][4][0], runs[0][4][1], base.desc, base.shapes)
        dhw, dhb = fm.unpack_grads(runs[0][4][2], runs[0][4][3], head.desc, head.shapes)
        w = fr.fused_field_mlp_bwd_plain(o, d, t, emb, g, bw, bb, hw, hb, s, skips, enc, dtype)
        named = list(zip(("d_o", "d_d", "d_t", "d_emb"), flat[0][:4], w[:4]))
        for tag, got_l, want_l in zip(("dWb", "dbb", "dWh", "dbh"), (dbw, dbb, dhw, dhb), w[4:]):
            named += [(f"{tag}{i}", a, b) for i, (a, b) in enumerate(zip(got_l, want_l))]
    assert torch.equal(outs[0], outs[1]) and all(torch.equal(a, b) for a, b in zip(*flat))
    _close(outs[0], want, dtype)
    _grads_close(named, dtype)


@pytest.mark.parametrize("path", ["narrow", "wide"])
def test_backward_is_deterministic(cuda, path):
    """Two launches on the same inputs give bitwise-equal dx, dW and db, on
    the one-pass kernel (a proposal stack, no workspace) and on the
    three-stage path (8 x 256): fixed tiles per CTA and fixed-order slab
    sums, no atomics."""
    in_dim, dims, skips, enc, out_act, dtype, n = CASES[5] if path == "narrow" else CASES[0]
    gen = torch.Generator().manual_seed(17)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), cuda)
    x = torch.rand(n, in_dim, generator=gen).to(cuda)
    g = torch.randn(n, dims[-1], generator=gen).to(cuda).to(dtype)
    packed = fm.prepare(in_dim, ws, bs, out_act, skips, enc, dtype, transposed=True)
    sizes = fm.bwd_sizes(fm.load_library("bwd"), packed, n, x)
    assert sizes.narrow == (path == "narrow") and (sizes.ws_elems == 0) == sizes.narrow
    first = fm.launch_bwd(x, g, packed)
    second = fm.launch_bwd(x, g, packed)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_autograd_goes_through_both_kernels(cuda):
    """fused_mlp on CUDA tensors: one forward launch, one backward launch,
    and parameter gradients in the parameters' dtype."""
    in_dim, dims, skips, enc, out_act, dtype, n = CASES[2]
    gen = torch.Generator().manual_seed(7)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(in_dim, enc), cuda)
    ws = [w.requires_grad_(True) for w in ws]
    bs = [b.requires_grad_(True) for b in bs]
    x = torch.rand(n, in_dim, generator=gen).to(cuda).requires_grad_(True)
    f0, b0 = fm.fused_mlp.launches, fm.fused_mlp_bwd.launches
    fm.fused_mlp(x, ws, bs, "relu", out_act, skips, enc, dtype).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fm.fused_mlp.launches - f0, fm.fused_mlp_bwd.launches - b0) == (1, 1)
    assert x.grad.dtype == torch.float32 and all(w.grad.dtype == torch.float32 for w in ws)
    assert all(bool(torch.isfinite(t.grad).all()) for t in (x, *ws, *bs))


HASH_CASES = [
    # (levels, log2 T, points, min_res, max_res, kind of points): see _hash_case
    (16, 19, 50_000, 16, 2048, "uniform"),  # the base field's grid
    (5, 17, 100_003, 16, 256, "uniform"),  # a proposal field's grid
    (5, 12, 4_099, 16, 128, "uniform"),  # a table of 4096 rows (the TPU's one-hot route)
    (2, 8, 1, 4, 16, "uniform"),
    # what the tiled kernels (128 points a block, lane = point) make hard
    (16, 19, 1024 * 48, 16, 2048, "rays"),
    (5, 17, 256 * 256, 16, 256, "rays"),
    (16, 19, 4_096, 16, 2048, "one_cell"),
    (5, 17, 128 * 300 + 1, 16, 256, "rays"),  # N one past a tile multiple
    (16, 19, 128 * 64, 16, 2048, "zero_tiles"),
    (16, 19, 3_000, 16, 2048, "integer"),
    (2, 8, 1_000, 4, 16, "integer"),
    # the nerfacto-big / -huge grids: 2^21 rows a level to 4096 and 8192,
    # and the huge second proposal's 7 levels (fewer than 8: the walk)
    (16, 21, 1024 * 48, 16, 8192, "rays"),
    (16, 21, 50_000, 16, 4096, "uniform"),
    (7, 17, 256 * 512 + 1, 16, 2048, "rays"),
]


def _hash_case(case, dtype, seed):
    """Table, positions, scalings, cotangent and T of one case. Kinds of
    points: "uniform", with 1/8 on level-0 grid coordinates and 1/8 zeroed
    as the fields' selector zeroes them; "rays", rays of 48 samples sorted
    by depth along chords of the unit box, ray-major as the model orders
    them; "one_cell", every point in one cell of the finest level, so every
    lane of a warp adds to the same 8 rows at every level; "zero_tiles",
    rays whose g is zero over whole 128-point tiles and, for one warp, at
    every other level; "integer", points on integer grid coordinates at
    every level (coordinates m / s_0 where every resolution is a multiple of
    the first, else 0 or 1), where floor = ceil puts two corners of one
    point on the same row."""
    levels, log2_t, n, lo, hi, kind = HASH_CASES[case]
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(levels * 2**log2_t, 2, generator=gen) * 1e-2
    scal = torch.from_numpy(enc.hash_grid_scalings(levels, lo, hi))
    if kind == "uniform":
        pos = torch.rand(n, 3, generator=gen)
        k = n // 8
        pos[:k] = torch.floor(pos[:k] * lo) / lo  # on level-0 grid coordinates
        pos[k : 2 * k] = 0.0  # zeroed by the fields' selector
    elif kind in ("rays", "zero_tiles"):
        r = -(-n // 48)
        a, b = torch.rand(r, 1, 3, generator=gen), torch.rand(r, 1, 3, generator=gen)
        t = torch.sort(torch.rand(r, 48, 1, generator=gen), dim=1).values
        pos = (a + t * (b - a)).reshape(-1, 3)[:n].contiguous()
    elif kind == "one_cell":
        # up to 2e-5 above one point: in one cell at every level
        pos = torch.tensor([0.3001, 0.6003, 0.2007]) + torch.rand(n, 3, generator=gen) * 2e-5
    else:
        s0 = int(scal[0])
        m = s0 if all(int(s) % s0 == 0 for s in scal) else 1
        pos = torch.randint(0, m + 1, (n, 3), generator=gen).float() / m
    g = torch.randn(n, 2 * levels, generator=gen)
    if kind == "zero_tiles":
        g[128:384] = 0.0  # two whole tiles
        g[512:544, 0::4] = 0.0  # one warp, every other level (both features)
        g[512:544, 1::4] = 0.0
    return table, pos, scal, g.to(dtype), 2**log2_t


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", range(len(HASH_CASES)))
def test_hash_kernels_match_plain(cuda, case, dtype):
    table, pos, scal, g, t = (x.to(cuda) if isinstance(x, torch.Tensor) else x for x in _hash_case(case, dtype, case))
    before = (th.hash_encode_fwd.launches, th.hash_encode_bwd_table.launches, th.hash_encode_bwd_pos.launches)
    out = th.hash_encode_fwd(table, pos, scal, t, dtype)
    d_table = th.hash_encode_bwd_table(pos, g, scal, t)
    d_pos = th.hash_encode_bwd_pos(table, pos, g, scal, t)
    torch.cuda.synchronize()
    after = (th.hash_encode_fwd.launches, th.hash_encode_bwd_table.launches, th.hash_encode_bwd_pos.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    want = enc.hash_encode_plain(table, pos, scal, t, dtype)
    assert out.dtype == dtype and out.shape == want.shape
    step = 2.0**-8 if dtype == torch.bfloat16 else 0.0
    assert bool(((out.float() - want.float()).abs() <= 1e-6 + step * want.float().abs()).all())
    want_table = enc.hash_encode_bwd_table_plain(pos, g, scal, t, 2)
    want_pos = enc.hash_encode_bwd_pos_plain(table, pos, g, scal, t)
    assert bool(torch.isfinite(d_table).all()) and bool(torch.isfinite(d_pos).all())
    assert _rel_l2(d_table, want_table) <= 1e-4, _rel_l2(d_table, want_table)
    assert _rel_l2(d_pos, want_pos) <= 1e-5, _rel_l2(d_pos, want_pos)


def test_hash_table_gradient_of_a_row_slice_cotangent(cuda):
    """A cotangent that is a row slice of a larger tensor (as a torch.cat
    backward hands out) can start off the 16-byte alignment the table
    kernel's tile loads need (here 1 row of 2L = 10 bf16, 20 bytes, in):
    the wrapper copies it, and the result equals the plain version's."""
    table, pos, scal, g, t = (x.to(cuda) if isinstance(x, torch.Tensor) else x
                              for x in _hash_case(1, torch.bfloat16, 1))
    whole = torch.cat([g[:1], g])
    view = whole[1:]
    assert view.is_contiguous() and view.data_ptr() % 16
    d_table = th.hash_encode_bwd_table(pos, view, scal, t)
    torch.cuda.synchronize()
    want = enc.hash_encode_bwd_table_plain(pos, g, scal, t, 2)
    assert _rel_l2(d_table, want) <= 1e-4, _rel_l2(d_table, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [0, 1, 4, 7, 8, 9])
def test_hash_position_gradient_is_deterministic(cuda, case, dtype):
    """The position gradient sums each point's levels in one thread, in
    order, with no atomics: two launches give bitwise-equal d_pos."""
    table, pos, scal, g, t = (x.to(cuda) if isinstance(x, torch.Tensor) else x for x in _hash_case(case, dtype, case))
    first = th.hash_encode_bwd_pos(table, pos, g, scal, t)
    second = th.hash_encode_bwd_pos(table, pos, g, scal, t)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("levels", [24, 120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hash_position_gradient_with_many_levels(cuda, dtype, levels):
    """Many levels: 24 take the tiled kernel; 120 with an f32 g would not
    fit its shared memory and take the per-point walk. Both match the plain
    version (relative L2 1e-5), also for a cotangent that starts off the
    16-byte alignment (the wrapper copies it)."""
    gen = torch.Generator().manual_seed(40 + levels)
    t = 2**10
    table = (torch.randn(levels * t, 2, generator=gen) * 1e-2).to(cuda)
    scal = torch.from_numpy(enc.hash_grid_scalings(levels, 4, 1024)).to(cuda)
    pos = torch.rand(3_001, 3, generator=gen).to(cuda)
    g = torch.randn(3_001 * 2 * levels + 1, generator=gen).to(cuda).to(dtype)[1:].view(3_001, 2 * levels)
    assert g.is_contiguous() and g.data_ptr() % 16
    d_pos = th.hash_encode_bwd_pos(table, pos, g, scal, t)
    torch.cuda.synchronize()
    want = enc.hash_encode_bwd_pos_plain(table, pos, g, scal, t)
    assert _rel_l2(d_pos, want) <= 1e-5, _rel_l2(d_pos, want)


VJP_CASES = [
    # (levels, log2 T, points, min_res, max_res, kind): the SDF grid of
    # neus-facto, a proposal-sized grid, N one past a 256-point tile and
    # below one tile, more levels than the 4-level phases divide evenly,
    # neus-facto's exact call (98,304 points) and a case on rays (lanes that
    # share cells: the combined REDs) whose g is zero on some levels and
    # some points (the skip path)
    (16, 19, 50_001, 16, 2048, "uniform"),
    (5, 17, 100_003, 16, 256, "uniform"),
    (4, 10, 257, 4, 64, "uniform"),
    (2, 8, 37, 4, 16, "uniform"),
    (23, 12, 3_001, 4, 1024, "uniform"),
    (16, 19, 98_304, 16, 2048, "uniform"),
    (16, 19, 20_000, 16, 2048, "rays_zero_g"),
]
VJP_OUTPUTS = {"all": (True, True, True), "dg": (True, False, False), "d_table": (False, True, False),
               "d_pos2": (False, False, True), "dg+d_pos2": (True, False, True), "dg+d_table": (True, True, False),
               "d_table+d_pos2": (False, True, True)}
VJP_TOLS = (1e-5, 1e-4, 1e-5)  # dg, d_table, d_pos2: relative L2


def _vjp_case(case, seed):
    levels, log2_t, n, lo, hi, kind = VJP_CASES[case]
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(levels * 2**log2_t, 2, generator=gen) * 0.5
    scal = torch.from_numpy(enc.hash_grid_scalings(levels, lo, hi))
    pos = torch.rand(n, 3, generator=gen) * 0.96 + 0.02
    g = torch.randn(n, 2 * levels, generator=gen)
    v = torch.randn(n, 3, generator=gen)
    if kind == "rays_zero_g":
        r = -(-n // 48)
        a, b = torch.rand(r, 1, 3, generator=gen), torch.rand(r, 1, 3, generator=gen)
        depth = torch.sort(torch.rand(r, 48, 1, generator=gen), dim=1).values
        pos = (a + depth * (b - a)).reshape(-1, 3)[:n].contiguous()
        g[256:768] = 0.0  # two whole tiles
        g[1024:1056, 0::4] = 0.0  # one warp, every other level (both features)
        g[1024:1056, 1::4] = 0.0
        g[torch.rand(n, 2 * levels, generator=gen) < 0.1] = 0.0  # scattered points and levels
    return table, pos, g, v, scal, 2**log2_t


def _assert_vjp_matches(got, want):
    """dg bitwise, each output within VJP_TOLS, None where not asked for."""
    for name, a, b, tol in zip(("dg", "d_table", "d_pos2"), got, want, VJP_TOLS):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == b.shape and a.dtype == torch.float32 and bool(torch.isfinite(a).all()), name
            assert _rel_l2(a, b) <= tol, (name, _rel_l2(a, b))
            if name == "dg":
                assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.parametrize("outputs", list(VJP_OUTPUTS))
@pytest.mark.parametrize("case", range(len(VJP_CASES)))
def test_hash_vjp_kernel_matches_plain(cuda, case, outputs):
    """The position gradient's VJP kernel against
    hash_encode_bwd_pos_vjp_plain, every output set: dg (the 8 corners
    summed in the same order) bitwise and within relative L2 1e-5, d_pos2
    (the levels in another order) 1e-5, d_table (row 7's atomics) 1e-4; an
    output not asked for is None, and the call launches once."""
    table, pos, g, v, scal, t = (x.to(cuda) if isinstance(x, torch.Tensor) else x for x in _vjp_case(case, case))
    need = dict(zip(("need_g", "need_table", "need_pos"), VJP_OUTPUTS[outputs]))
    before = th.hash_encode_bwd_pos_vjp.launches
    got = th.hash_encode_bwd_pos_vjp(table, pos, g, v, scal, t, **need)
    torch.cuda.synchronize()
    assert th.hash_encode_bwd_pos_vjp.launches - before == 1
    _assert_vjp_matches(got, enc.hash_encode_bwd_pos_vjp_plain(table, pos, g, v, scal, t, **need))


@pytest.mark.parametrize("outputs", [k for k, (dg, _, dp) in VJP_OUTPUTS.items() if dg or dp])
@pytest.mark.parametrize("case", [0, 2, 6])
def test_hash_vjp_dg_and_d_pos2_are_deterministic(cuda, case, outputs):
    """dg and d_pos2 are written per point in a fixed order: two launches
    for every output set that forms either give bitwise-equal results."""
    args = [x.to(cuda) if isinstance(x, torch.Tensor) else x for x in _vjp_case(case, case)]
    need = VJP_OUTPUTS[outputs]
    first, second = th.hash_encode_bwd_pos_vjp(*args, *need), th.hash_encode_bwd_pos_vjp(*args, *need)
    torch.cuda.synchronize()
    for name, a, b, formed in zip(("dg", "d_table", "d_pos2"), first, second, need):
        if formed and name != "d_table":
            assert torch.equal(a, b), name


@pytest.mark.parametrize("outputs", list(VJP_OUTPUTS))
def test_hash_vjp_kernel_on_grid_coordinates(cuda, outputs):
    """Points on grid coordinates (floor == ceil: one row twice, weights 1
    and 0) and at 0, as a selector-zeroed point gives: every output set
    matches the plain version (the CPU's
    test_vjp_plain_on_grid_coordinates holds that against JAX)."""
    gen = torch.Generator().manual_seed(11)
    levels, t, n = 4, 2**10, 3_000
    table = (torch.randn(levels * t, 2, generator=gen) * 0.5).to(cuda)
    scal = torch.from_numpy(enc.hash_grid_scalings(levels, 4, 64)).to(cuda)
    pos = torch.rand(n, 3, generator=gen)
    pos[:1000] = torch.floor(pos[:1000] * 4) / 4
    pos[1000:1500] = 0.0
    pos = pos.to(cuda)
    g, v = torch.randn(n, 2 * levels, generator=gen).to(cuda), torch.randn(n, 3, generator=gen).to(cuda)
    need = VJP_OUTPUTS[outputs]
    got = th.hash_encode_bwd_pos_vjp(table, pos, g, v, scal, t, *need)
    torch.cuda.synchronize()
    _assert_vjp_matches(got, enc.hash_encode_bwd_pos_vjp_plain(table, pos, g, v, scal, t, *need))


def test_hash_vjp_of_a_misaligned_cotangent(cuda):
    """A g that starts off the 16-byte alignment the kernel's tile loads
    need: the wrapper copies it, and every output matches."""
    table, pos, g, v, scal, t = (x.to(cuda) if isinstance(x, torch.Tensor) else x for x in _vjp_case(2, 2))
    view = torch.cat([g.reshape(-1)[:1], g.reshape(-1)])[1:].view_as(g)
    assert view.is_contiguous() and view.data_ptr() % 16
    got = th.hash_encode_bwd_pos_vjp(table, pos, view, v, scal, t)
    torch.cuda.synchronize()
    _assert_vjp_matches(got, enc.hash_encode_bwd_pos_vjp_plain(table, pos, g, v, scal, t))


def _eikonal_on(device, table, x, w1, b1, w2, scal, t):
    """An eikonal loss through hash_encode and a softplus(100 x) / 100
    layer: the node's graph under create_graph, then backward. Returns the
    loss, the gradients of the table, x and the weights, the launches of
    the first-order pass and of the backward (table scatter, position
    gradient, VJP), and the SDF gradient."""
    leaves = [a.to(device).clone().requires_grad_() for a in (table, x, w1, b1, w2)]
    tb, xx, a1, c1, a2 = leaves

    def counts():
        return (th.hash_encode_bwd_table.launches, th.hash_encode_bwd_pos.launches,
                th.hash_encode_bwd_pos_vjp.launches)

    feat = th.hash_encode(tb, xx, scal.to(device), t)
    h = -torch.nn.functional.logsigmoid(-100.0 * (torch.cat([feat, xx], -1) @ a1 + c1)) / 100.0
    sdf = h @ a2
    start = counts()
    (grad,) = torch.autograd.grad(sdf.sum(), xx, create_graph=True)
    middle = counts()
    loss = torch.mean((torch.linalg.vector_norm(grad, dim=-1) - 1.0) ** 2)
    loss.backward()
    end = counts()
    first = tuple(b - a for a, b in zip(start, middle))
    second = tuple(b - a for a, b in zip(middle, end))
    return float(loss.detach()), [p.grad.cpu() for p in leaves], first, second, grad


def test_hash_node_keeps_the_second_derivative_on_the_card(cuda):
    """d_pos from hash_encode under create_graph=True comes out of
    _HashEncodeBwdPos on the card, and an eikonal loss through it gives the
    CPU's gradients (table, positions and weights within relative L2 1e-4:
    the atomics' order, and the kernels' and torch's own roundings through
    softplus' 100x second derivative): none of the table's gradient is
    lost. The first-order pass launches the position gradient and no table
    scatter; the backward launches the VJP, the table scatter and (for
    the positions) the position gradient once each."""
    gen = torch.Generator().manual_seed(5)
    levels, t = 16, 2**19
    table = torch.randn(levels * t, 2, generator=gen) * 0.5
    scal = torch.from_numpy(enc.hash_grid_scalings(levels, 16, 2048))
    x = torch.rand(3_000, 3, generator=gen) * 0.9 + 0.05
    w1 = torch.randn(2 * levels + 3, 32, generator=gen) / 6.0
    b1 = torch.randn(32, generator=gen) * 0.1
    w2 = torch.randn(32, 1, generator=gen) / 6.0
    loss, grads, first, second, grad = _eikonal_on(cuda, table, x, w1, b1, w2, scal, t)
    torch.cuda.synchronize()
    cpu_loss, cpu_grads, _, _, _ = _eikonal_on(torch.device("cpu"), table, x, w1, b1, w2, scal, t)
    names, frontier = set(), [grad.grad_fn]
    for _ in range(4):
        names.update(type(f).__name__ for f in frontier if f is not None)
        frontier = [n for f in frontier if f is not None for n, _ in f.next_functions]
    assert "_HashEncodeBwdPosBackward" in names
    assert first == (0, 1, 0) and second == (1, 1, 1), (first, second)
    assert loss == pytest.approx(cpu_loss, rel=1e-5)
    assert float(grads[0].abs().max()) > 0
    for name, a, b in zip(("table", "x", "w1", "b1", "w2"), grads, cpu_grads):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_l2(a, b) <= 1e-4, (name, _rel_l2(a, b))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_hash_encoding_goes_through_the_kernels(cuda, use_pallas):
    """The hash encodings of a thermal-nerfacto model on the card, a small
    (the TPU's one-hot route) and a large table, for both values of the
    config's use_pallas: one forward launch, one table-gradient launch, and
    a position-gradient launch only when the positions need one."""
    cfg = get_method_config("thermal-nerfacto").model
    cfg.use_pallas, cfg.num_levels, cfg.log2_hashmap_size = use_pallas, 4, 19
    cfg.proposal_net_args_list = [dict(cfg.proposal_net_args_list[0], num_levels=4, log2_hashmap_size=10)] * 2
    model = ThermalNerfactoModel(cfg, [[-1.0] * 3, [1.0] * 3], 2, {"is_thermal": [0, 1]}, device=cuda, seed=3)
    for mod, t in ((model.proposal_networks[0].encoding, 2**10), (model.field.mlp_base.encoding, 2**19)):
        assert mod.hash_table.is_cuda and mod.table_size == t
        for pos_grad in (False, True):
            pos = torch.rand(6, 50, 3, device=cuda).requires_grad_(pos_grad)
            c0 = (th.hash_encode_fwd.launches, th.hash_encode_bwd_table.launches, th.hash_encode_bwd_pos.launches)
            out = mod(pos)
            out.float().square().sum().backward()
            torch.cuda.synchronize()
            c1 = (th.hash_encode_fwd.launches, th.hash_encode_bwd_table.launches, th.hash_encode_bwd_pos.launches)
            assert out.shape == (6, 50, 8) and out.dtype == torch.bfloat16
            assert tuple(b - a for a, b in zip(c0, c1)) == (1, 1, int(pos_grad))
            assert mod.hash_table.grad.dtype == torch.float32 and bool(torch.isfinite(mod.hash_table.grad).all())
            if pos_grad:
                assert pos.grad.shape == pos.shape and bool(torch.isfinite(pos.grad).all())
            mod.hash_table.grad = None


def _rays(gen, r, s, device):
    """Rays from inside the scene box, unit directions, sorted midpoints out
    to 6 (outside the unit ball); one ray's last sample at 1e8 (the
    contraction reaches the box's edge: selector 0); two rays with tied
    x / y components (o = 0, d = (a, +-a, b))."""
    o = torch.rand(r, 3, generator=gen) * 1.6 - 0.8
    d = torch.nn.functional.normalize(torch.randn(r, 3, generator=gen), dim=-1)
    t = torch.sort(torch.rand(r, s, generator=gen) * 6.0 + 0.05, dim=-1).values
    t[0, -1] = 1e8
    o[1:3] = 0.0
    d[1] = torch.tensor([0.6, 0.6, 0.52915025])
    d[2] = torch.tensor([0.6, -0.6, 0.52915025])
    return o.to(device), d.to(device), t.reshape(-1, 1).to(device)


RAY_CASES = [
    # (layer widths incl. output, skips, freq_encoding, dtype, rays, samples)
    ((256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), torch.bfloat16, 512, 32),
    ((256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), torch.float32, 128, 32),
    ((64, 64, 1), (), (5, 0.0, 4.0, True), torch.bfloat16, 300, 128),
    ((64, 64, 1), (), (7, 0.0, 6.0, True), torch.float32, 100, 48),
    ((64, 64, 1), (), (7, 0.0, 6.0, True), torch.bfloat16, 1000, 48),
]


def _close(got, want, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=tol, rtol=tol)


def _grads_close(named, dtype):
    for name, got, want in named:
        assert got.shape == want.shape, name
        assert bool(torch.isfinite(got).all()), name
        assert _rel_l2(got, want) <= BWD_TOL[dtype], (name, _rel_l2(got, want))


@pytest.mark.parametrize("case", range(len(RAY_CASES)))
def test_ray_kernels_match_plain(cuda, case):
    dims, skips, enc, dtype, r, s = RAY_CASES[case]
    gen = torch.Generator().manual_seed(200 + case)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(3, enc), cuda)
    o, d, t = _rays(gen, r, s, cuda)
    packed = fm.prepare(3, ws, bs, None, skips, enc, dtype, transposed=True)
    f0 = fr.fused_ray_mlp.launches
    got = fr.launch_ray(o, d, t, s, packed)
    torch.cuda.synchronize()
    assert fr.fused_ray_mlp.launches == f0 + 1
    want = fr.fused_ray_mlp_plain(o, d, t, ws, bs, s, None, skips, enc, dtype)
    _close(got, want, dtype)
    assert float(got[:, -1].float().sum()) == float(want[:, -1].float().sum()) < r * s  # some selectors are 0
    g = torch.randn(r * s, dims[-1] + 1, generator=gen).to(cuda).to(dtype)
    for need in (True, False):
        bwd_counts = lambda: (fr.fused_ray_mlp_bwd.launches, fr.fused_ray_mlp_bwd.input_grad_launches,  # noqa: E731
                              fr.fused_ray_mlp_bwd.stack_launches[tuple(packed.desc)])
        b0 = bwd_counts()
        (d_o, d_d, d_t), dw, db = fr.fused_ray_mlp_bwd(o, d, t, g[:, :-1].contiguous(), s, packed, need)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(bwd_counts(), b0)] == [1, int(need), 1]
        dws, dbs = fm.unpack_grads(dw, db, packed.desc, packed.shapes)
        w_o, w_d, w_t, w_dws, w_dbs = fr.fused_ray_mlp_bwd_plain(o, d, t, g, ws, bs, s, None, skips, enc, dtype, need)
        named = [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, w_dws))]
        named += [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, w_dbs))]
        if need:
            named += [("d_o", d_o, w_o), ("d_d", d_d, w_d), ("d_t", d_t, w_t)]
        else:
            assert d_o is None and w_o is None
        _grads_close(named, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels", [3, 1, 4])
def test_field_kernels_match_plain(cuda, channels, dtype):
    """C = 3 (RGB), 1 (thermal) and 4 (the shared density mode's RGBT
    head): output rows of C + 2, the head's C columns of g."""
    gen = torch.Generator().manual_seed(300 + channels)
    enc, skips, r, s, e = (10, 0.0, 9.0, True), (4,), 256, 32, 32
    bw, bb = _params(gen, (256,) * 7 + (16,), skips, 63, cuda)
    hw, hb = _params(gen, (64, 64, channels), (), 16 + 15 + e, cuda)
    o, d, t = _rays(gen, r, s, cuda)
    emb = torch.randn(r, e, generator=gen).to(cuda)
    base = fm.prepare(3, bw, bb, None, skips, enc, dtype, transposed=True)
    head = fm.prepare(63, hw, hb, "sigmoid", (), None, dtype, transposed=True)
    f0 = fr.fused_field_mlp.launches
    got, head_in = fr.launch_field(o, d, t, emb, s, base, head)
    torch.cuda.synchronize()
    assert fr.fused_field_mlp.launches == f0 + 1
    _close(got, fr.fused_field_mlp_plain(o, d, t, emb, bw, bb, hw, hb, s, skips, enc, dtype), dtype)
    g = torch.randn(r * s, channels + 2, generator=gen).to(cuda).to(dtype)
    b0 = fr.fused_field_mlp_bwd.launches
    d_o, d_d, d_t, d_emb, (gbw, gbb, ghw, ghb) = fr.fused_field_mlp_bwd(o, d, t, emb, g, head_in, s, base, head)
    torch.cuda.synchronize()
    assert fr.fused_field_mlp_bwd.launches == b0 + 1
    dbw, dbb = fm.unpack_grads(gbw, gbb, base.desc, base.shapes)
    dhw, dhb = fm.unpack_grads(ghw, ghb, head.desc, head.shapes)
    want = fr.fused_field_mlp_bwd_plain(o, d, t, emb, g, bw, bb, hw, hb, s, skips, enc, dtype)
    named = [(k, a, b) for k, a, b in zip(("d_o", "d_d", "d_t", "d_emb"), (d_o, d_d, d_t, d_emb), want[:4])]
    for tag, got_l, want_l in zip(("dWb", "dbb", "dWh", "dbh"), (dbw, dbb, dhw, dhb), want[4:]):
        named += [(f"{tag}{i}", a, b) for i, (a, b) in enumerate(zip(got_l, want_l))]
    _grads_close(named, dtype)


def _field_case(gen, channels, head_widths, dtype, device):
    enc, skips, r, s, e = (10, 0.0, 9.0, True), (4,), 256, 32, 32
    bw, bb = _params(gen, (256,) * 7 + (16,), skips, 63, device)
    hw, hb = _params(gen, (*head_widths, channels), (), 16 + 15 + e, device)
    o, d, t = _rays(gen, r, s, device)
    emb = torch.randn(r, e, generator=gen).to(device)
    return (o, d, t, emb, bw, bb, hw, hb, s), (skips, enc)


@pytest.mark.parametrize("head_widths", [(64, 64), (128, 128)], ids=["narrow_head", "wide_head"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_field_forward_writes_the_head_input_only_when_asked(cuda, dtype, head_widths):
    """The whole-field forward with and without the head input: the same
    output bitwise, no head input back without it, and the one it writes
    equal, bitwise, to the plain _head_input of the same base output (its
    raw density column, its geo columns); each call counts one launch and,
    with the head input, one head-input launch. A 128-wide bf16 head runs
    on the wgmma kernel, which assembles its input the same way."""
    gen = torch.Generator().manual_seed(310)
    (o, d, t, emb, bw, bb, hw, hb, s), (skips, enc) = _field_case(gen, 3, head_widths, dtype, cuda)
    base = fm.prepare(3, bw, bb, None, skips, enc, dtype, transposed=True)
    head = fm.prepare(63, hw, hb, "sigmoid", (), None, dtype, transposed=True)
    assert head.fwd_path == {torch.float32: "f32", torch.bfloat16: "narrow" if head_widths[0] == 64 else "wgmma"}[dtype]
    counts = lambda: (fr.fused_field_mlp.launches, fr.fused_field_mlp.head_input_launches)  # noqa: E731
    c0 = counts()
    out, head_in = fr.launch_field(o, d, t, emb, s, base, head)
    c1 = counts()
    bare, none = fr.launch_field(o, d, t, emb, s, base, head, head_input=False)
    c2 = counts()
    torch.cuda.synchronize()
    assert (c1[0] - c0[0], c1[1] - c0[1], c2[0] - c1[0], c2[1] - c1[1]) == (1, 1, 1, 0)
    assert none is None and torch.equal(bare, out)
    _close(out, fr.fused_field_mlp_plain(o, d, t, emb, bw, bb, hw, hb, s, skips, enc, dtype), dtype)
    geo = 15
    base_k = torch.cat([out[:, 3:4], head_in[:, 16 : 16 + geo].to(dtype)], -1)
    assert torch.equal(head_in, fr._head_input(d, emb, base_k, s, dtype).float())


def test_field_head_input_follows_grad_mode(cuda):
    """fused_field_mlp writes the head input only where a backward can
    follow: not under torch.no_grad (every render chunk), and with grad
    mode on and parameters that need gradients."""
    gen = torch.Generator().manual_seed(320)
    (o, d, t, emb, bw, bb, hw, hb, s), (skips, enc) = _field_case(gen, 1, (64, 64), torch.bfloat16, cuda)
    params = [p.requires_grad_(True) for p in (*bw, *bb, *hw, *hb)]
    nb, nh = len(bw), len(hw)
    bw, bb, hw, hb = params[:nb], params[nb : 2 * nb], params[2 * nb : 2 * nb + nh], params[2 * nb + nh :]
    c0 = fr.fused_field_mlp.launches, fr.fused_field_mlp.head_input_launches
    with torch.no_grad():
        fr.fused_field_mlp(o, d, t, emb, bw, bb, hw, hb, s, skips, enc, torch.bfloat16)
    c1 = fr.fused_field_mlp.launches, fr.fused_field_mlp.head_input_launches
    out = fr.fused_field_mlp(o, d, t, emb, bw, bb, hw, hb, s, skips, enc, torch.bfloat16)
    out.float().sum().backward()
    torch.cuda.synchronize()
    c2 = fr.fused_field_mlp.launches, fr.fused_field_mlp.head_input_launches
    assert (c1[0] - c0[0], c1[1] - c0[1], c2[0] - c1[0], c2[1] - c1[1]) == (1, 0, 1, 1)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in params)


def test_fused_models_go_through_the_kernels(cuda):
    """A thermal-nerfacto-tpu with the three fused knobs, cut to small
    widths, on the card: a training step launches the ray-march forward for
    four proposals and two cross densities, the whole-field forward for two
    fields, and their backwards (the cross densities' with input
    gradients, the proposals' without), each stack's backward twice; no
    fused-MLP kernel runs."""
    cfg = get_method_config("thermal-nerfacto-tpu").model
    cfg.fused_raymarch = cfg.fused_field = cfg.fused_raymarch_proposals = True
    cfg.freq_num_layers, cfg.freq_hidden_dim = 4, 128
    cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray = (16, 8), 8
    model = ThermalNerfactoModel(cfg, [[-1.0] * 3, [1.0] * 3], 2, {"is_thermal": [0, 1]}, device=cuda, seed=3)
    from nerfstudio_thermal_torch.cameras.rays import RayBundle

    n = 512
    gen = torch.Generator().manual_seed(5)
    bundle = RayBundle(
        origins=(torch.rand(n, 3, generator=gen) * 0.2 + torch.tensor([2.0, 0.0, 0.0])).to(cuda),
        directions=torch.nn.functional.normalize(torch.tensor([-1.0, 0.0, 0.0]) + 0.3 * torch.randn(n, 3, generator=gen), dim=-1).to(cuda),
        pixel_area=torch.ones(n, 1, device=cuda), camera_indices=torch.zeros(n, 1, dtype=torch.int32, device=cuda),
    )
    counters = (fm.fused_mlp, fr.fused_ray_mlp, fr.fused_field_mlp, fr.fused_ray_mlp_bwd, fr.fused_field_mlp_bwd)
    before = [c.launches for c in counters] + [fr.fused_ray_mlp_bwd.input_grad_launches]
    stacks_before = fr.fused_ray_mlp_bwd.stack_launches.copy()
    fwd_stacks_before = fr.fused_ray_mlp.stack_launches.copy()
    out = model(bundle, train=True, generator=torch.Generator(device=cuda).manual_seed(0))
    (out["rgb"].sum() + out["rgb_thermal"].sum() + out["density2"].sum() + out["density2_thermal"].sum()
     + sum(w.sum() for w in out["weights_list"] + out["weights_list_thermal"])).backward()
    torch.cuda.synchronize()
    after = [c.launches for c in counters] + [fr.fused_ray_mlp_bwd.input_grad_launches]
    assert [a - b for a, b in zip(after, before)] == [0, 6, 2, 6, 2, 2]
    # the cross densities' stack and the two proposal stacks (F 5, F 7), in
    # both directions
    assert sorted((fr.fused_ray_mlp_bwd.stack_launches - stacks_before).values()) == [2, 2, 2]
    assert sorted((fr.fused_ray_mlp.stack_launches - fwd_stacks_before).values()) == [2, 2, 2]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_mlp_on_the_density_tv_points(cuda, dtype):
    """Rows 1-2 on the density TV loss's 7 x 5000 raw points (not a
    multiple of any tile; most outside (0, 1)^3 and zeroed) through
    thermal-nerfacto-tpu's base stack, with the TV loss's cotangent (the
    density column only)."""
    from nerfstudio_thermal_torch.fields.nerfacto_field import density_tv_points

    gen = torch.Generator().manual_seed(400)
    aabb = torch.tensor([[-1.0] * 3, [1.0] * 3], device=cuda)
    x = density_tv_points(aabb, torch.rand(5000, 3, generator=gen).to(cuda), 2048.0).contiguous()
    assert x.shape == (35000, 3) and 0 < int((x == 0).all(-1).sum()) < 35000
    enc, skips, dims = (10, 0.0, 9.0, True), (4,), (256,) * 7 + (16,)
    ws, bs = _params(gen, dims, skips, fm.encoding_dim(3, enc), cuda)
    f0 = fm.fused_mlp.launches
    got = fm.fused_mlp(x, ws, bs, "relu", None, skips, enc, dtype)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == f0 + 1
    _close(got, fm.fused_mlp_plain(x, ws, bs, "relu", None, skips, enc, dtype), dtype)
    g = torch.zeros(x.shape[0], dims[-1], device=cuda, dtype=dtype)
    g[:, 0] = torch.randn(x.shape[0], generator=gen).to(cuda).to(dtype)
    dx, dws, dbs = fm.fused_mlp_bwd(x, g, ws, bs, "relu", None, skips, enc, dtype)
    torch.cuda.synchronize()
    want = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", None, skips, enc, dtype)
    named = [("dx", dx, want[0])] + [(f"dW{i}", a, b) for i, (a, b) in enumerate(zip(dws, want[1]))]
    _grads_close(named + [(f"db{i}", a, b) for i, (a, b) in enumerate(zip(dbs, want[2]))], dtype)


def test_shared_fused_model_goes_through_the_kernels(cuda):
    """thermal-nerfacto-tpu with the fused knobs in the shared density mode,
    cut to small widths, on the card: one RGBT field through the
    whole-field kernel (output [N, 4 + 2]) and two proposals through the
    ray march; no thermal hierarchy, no cross density, no fused-MLP kernel;
    finite 4-channel colours and gradients."""
    cfg = get_method_config("thermal-nerfacto-tpu").model
    cfg.fused_raymarch = cfg.fused_field = cfg.fused_raymarch_proposals = True
    cfg.density_mode = "shared"
    cfg.freq_num_layers, cfg.freq_hidden_dim = 4, 128
    cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray = (16, 8), 8
    model = ThermalNerfactoModel(cfg, [[-1.0] * 3, [1.0] * 3], 2, {"is_thermal": [0, 1]}, device=cuda, seed=3)
    from nerfstudio_thermal_torch.cameras.rays import RayBundle

    n = 512
    gen = torch.Generator().manual_seed(6)
    bundle = RayBundle(
        origins=(torch.rand(n, 3, generator=gen) * 0.2 + torch.tensor([2.0, 0.0, 0.0])).to(cuda),
        directions=torch.nn.functional.normalize(torch.tensor([-1.0, 0.0, 0.0]) + 0.3 * torch.randn(n, 3, generator=gen), dim=-1).to(cuda),
        pixel_area=torch.ones(n, 1, device=cuda), camera_indices=torch.zeros(n, 1, dtype=torch.int32, device=cuda),
    )
    counters = (fm.fused_mlp, fr.fused_ray_mlp, fr.fused_field_mlp, fr.fused_ray_mlp_bwd, fr.fused_field_mlp_bwd)
    before = [c.launches for c in counters]
    out = model(bundle, train=True, generator=torch.Generator(device=cuda).manual_seed(0))
    assert out["rgbt"].shape == (n, 4) and "density2" not in out
    (out["rgbt"].sum() + sum(w.sum() for w in out["weights_list"])).backward()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 2, 1, 2, 1]
    assert bool(torch.isfinite(out["rgbt"]).all())
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.field.parameters())


@pytest.mark.parametrize("name", ["vanilla-nerf", "mipnerf"])
def test_nerf_models_go_through_the_kernels(cuda, name):
    """vanilla-nerf and mipnerf with use_pallas on the card: a training
    forward and backward launch the fused-MLP forward twice (the coarse and
    the fine pass's base stacks) and its backward twice, the wgmma path for
    bf16; the losses are finite and every parameter gets a finite
    gradient. Without use_pallas nothing launches."""
    from nerfstudio_thermal_torch.cameras.rays import RayBundle
    from nerfstudio_thermal_torch.configs.method_configs import resolve_model_class

    n = 256
    gen = torch.Generator().manual_seed(9)
    o = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1) * 4.0
    bundle = RayBundle(
        origins=o.to(cuda), directions=torch.nn.functional.normalize(-o + 0.3 * torch.randn(n, 3, generator=gen), dim=-1).to(cuda),
        pixel_area=torch.full((n, 1), 1e-6, device=cuda), camera_indices=torch.zeros(n, 1, dtype=torch.int32, device=cuda),
    )
    for use_pallas in (True, False):
        cfg = get_method_config(name).model
        cfg.use_pallas = use_pallas
        model = resolve_model_class(cfg)(cfg, [[-1.5] * 3, [1.5] * 3], 1, device=cuda, seed=1)
        before = (fm.fused_mlp.launches, fm.fused_mlp_bwd.launches, fm.fused_mlp.path_launches["wgmma"])
        out = model(bundle, train=True, generator=torch.Generator(device=cuda).manual_seed(0))
        gt = torch.rand(n, 3, generator=gen).to(cuda)
        loss = sum(model.get_loss_dict(out, {"image": gt}, {}).values())
        loss.backward()
        torch.cuda.synchronize()
        after = (fm.fused_mlp.launches, fm.fused_mlp_bwd.launches, fm.fused_mlp.path_launches["wgmma"])
        assert [a - b for a, b in zip(after, before)] == ([2, 2, 2] if use_pallas else [0, 0, 0])
        assert bool(torch.isfinite(loss))
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())
