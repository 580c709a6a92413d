"""A Python copy of the fused-MLP forward's path rule and wgmma plan, and of
the backward walk's shared memory.

The kernel libraries decide these (nerfstudio_thermal_torch/csrc/
fused_mlp_fwd.cu: fwd_path, make_wg_plan, wg_smem, f32_smem;
fused_mlp_bwd.cu: smem_layout); the wrapper asks them through
`fused_mlp.forward_plan` and `fused_mlp.bwd_sizes`, which need the built
libraries and so a card. This copy lets the CPU tests emulate the paths,
check the wgmma weight layout and see which stacks the backward's walk
fits; tests/test_torch_cuda_kernels.py holds it equal to the libraries'
answers on the card. It imports neither torch nor JAX.
"""

from typing import List, Optional, Sequence, Tuple

DESC_HEADER = 9
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
NARROW_WIDTH = 64  # widest padded layer (and input) of the narrow path
NARROW_ROWS = 128  # points per tile of the narrow path
WGMMA_WIDTHS = (16, 32, 64, 128, 256)  # wgmma N of the wide path; the last is its widest layer
WG_STAGES, WG_SLOT, WG_ROWS = 4, 64 * 256 * 2, 128  # the wide path's ring: slots, bytes per slot; tile rows
F32_ROWS = 64  # points per CTA of the f32 kernel


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def layers(desc: Sequence[int]) -> List[List[int]]:
    """Per layer [k_pad, n_pad, skip, w_off, b_off] of a descriptor."""
    return [list(desc[DESC_HEADER + 5 * i : DESC_HEADER + 5 * i + 5]) for i in range(desc[0])]


def wgmma_plan(desc: Sequence[int]) -> Tuple[Optional[List[Tuple[int, int, int, int]]], int]:
    """As make_wg_plan: per layer (wgmma width nw, 64-row slices of x0,
    64-row slices of the previous layer's output, offset of the layer's
    slices in elements) and the length of the wgmma-order weights; (None,
    0) for a stack wider than 256. nw is the layer's padded width rounded
    up to WGMMA_WIDTHS, at least 64 for a hidden layer; x0 (padded to
    whole 64-column atoms) feeds layer 0 and the skip layers."""
    ls = layers(desc)
    in_pad, plan, off, prev = desc[2], [], 0, None
    if in_pad > WGMMA_WIDTHS[-1] or any(n > WGMMA_WIDTHS[-1] for _, n, *_ in ls):
        return None, 0
    for li, (_, n_pad, skip, _, _) in enumerate(ls):
        nw = next(w for w in WGMMA_WIDTHS if w >= n_pad and (w >= 64 or li == len(ls) - 1))
        slices_x0 = -(-in_pad // 64) if li == 0 or skip else 0
        slices_h = 0 if li == 0 else prev // 64
        plan.append((nw, slices_x0, slices_h, off))
        off += (slices_x0 + slices_h) * 64 * nw
        prev = nw
    return plan, off


def narrow_smem(desc: Sequence[int]) -> int:
    """As narrow_smem: the packed weights, the biases, the tile's x0 rows."""
    ls = layers(desc)
    total_w = sum(k * n for k, n, *_ in ls)
    total_b = sum(n for _, n, *_ in ls)
    return _round_up(total_w * 2, 16) + _round_up(total_b * 4, 16) + NARROW_ROWS * (desc[2] + 8) * 2


def wg_smem(desc: Sequence[int]) -> int:
    """As wg_smem: alignment slack, the ring, x0 in 64-column atoms of 128
    rows, the ring's barriers."""
    return 1024 + WG_STAGES * WG_SLOT + -(-desc[2] // 64) * WG_ROWS * 128 + 2 * WG_STAGES * 8


def f32_smem(desc: Sequence[int]) -> int:
    """As f32_smem: x0 and two hidden buffers of 64 rows, each row padded
    by one float."""
    return F32_ROWS * (desc[2] + 1) * 4 + 2 * F32_ROWS * (desc[6] + 1) * 4


def forward_path(desc: Sequence[int], bf16: bool) -> Optional[str]:
    """As fwd_path: f32 compute takes the f32 kernel if its shared memory
    fits; bf16 the narrow one-pass kernel when no layer has a skip, every
    padded width (input included) is <= 64 and its shared memory fits,
    else the wgmma kernel when it has a plan and its shared memory fits.
    None when no kernel takes the stack."""
    if not bf16:
        return "f32" if f32_smem(desc) <= SMEM_LIMIT else None
    in_pad = desc[2]
    if (in_pad <= NARROW_WIDTH and all(not skip and k <= NARROW_WIDTH and n <= NARROW_WIDTH
                                       for k, n, skip, _, _ in layers(desc))
            and narrow_smem(desc) <= SMEM_LIMIT):
        return "narrow"
    if wgmma_plan(desc)[0] is not None and wg_smem(desc) <= SMEM_LIMIT:
        return "wgmma"
    return None


WALK_ROWS = 64  # points per CTA of the backward's walk
WALK_RING = 3 * 4 * 16 * 32 * 16  # the bf16 walk's weight ring: 3 slots of 4 k-tiles x 256 columns (bytes)


def walk_smem(desc: Sequence[int], bf16: bool) -> int:
    """As the backward's smem_layout (the walk of a stack that is not
    narrow): x0, two activation buffers as wide as the widest hidden or
    output layer (f32: a dh buffer overlapping the second), dx0, the last
    layer's f32 pre-activation for a sigmoid head only, the relu masks,
    and for bf16 the db partials and the weight ring."""
    es, pad = (2, 8) if bf16 else (4, 1)
    ls = layers(desc)
    in_pad, hid_pad, out_pad = desc[2], desc[6], ls[-1][1]
    wid = max(hid_pad, out_pad)
    x0 = _round_up(WALK_ROWS * (in_pad + pad) * es, 16)
    h = _round_up(WALK_ROWS * (wid + pad) * es, 16)
    fwd_end = x0 + 2 * h
    walk_end = fwd_end if bf16 else x0 + h + _round_up(WALK_ROWS * (wid + 4) * 4, 16)
    off = max(fwd_end, walk_end) + _round_up(WALK_ROWS * (in_pad + 4) * 4, 16)
    if desc[8]:  # out_sigmoid
        off += _round_up(WALK_ROWS * (out_pad + 4) * 4, 16)
    off += _round_up(max(len(ls) - 1, 1) * WALK_ROWS * ((wid + 31) // 32) * 4, 16)
    if bf16:
        off += _round_up(2 * wid * 4, 16) + WALK_RING
    return off
