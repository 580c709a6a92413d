"""A Python copy of the fused-MLP forward's path rule and wgmma plan, and of
the backward walk's shared memory.

The kernel libraries decide these (nerfstudio_thermal_torch/csrc/
fused_mlp_fwd.cu: fwd_path, make_wg_plan, wg_smem, f32_smem, f32_ok;
fused_mlp_f32.cuh: f32_tile_width; fused_mlp_bwd.cu: smem_layout,
walk32_smem); the wrapper asks them through
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
# The f32 kernels (csrc/fused_mlp_f32.cuh): points per CTA, floats between
# two k rows of a k-major activation buffer, the weight ring's bytes (2
# slots of 16 k rows x 256 columns), the widest column pass of a product.
F32_ROWS, F32_STRIDE, F32_RING, F32_MAX_WIDTH = 128, 128 + 4, 2 * 16 * 256 * 4, 256
F32_THREADS = 512  # threads of an f32 forward / walk / dW CTA
F32_DBW = 1024 * 4  # bytes of the f32 walk's db partials


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


def f32_spill_rows(width: int) -> int:
    """As f32_spill_rows: k rows of the spill buffer that holds the column
    passes past F32_MAX_WIDTH of a layer up to `width` wide."""
    return max(width - F32_MAX_WIDTH, 0)


def f32_pass_cols(ncols: int) -> List[Tuple[int, int]]:
    """As f32_passes / f32_pass_col0 / f32_pass_cols: (first column,
    columns) of each column pass of a product ncols wide, in the order the
    kernels run them (column blocks 1, 2, ..., then block 0)."""
    blocks = -(-ncols // F32_MAX_WIDTH)
    starts = [((q + 1) % blocks) * F32_MAX_WIDTH for q in range(blocks)]
    return [(c0, min(F32_MAX_WIDTH, ncols - c0)) for c0 in starts]


def f32_smem(desc: Sequence[int], scratch: int = 0) -> int:
    """As f32_smem: x0 and the one hidden buffer, k-major (in_pad and
    hid_pad rows of F32_STRIDE floats), the spill rows of a hidden layer
    wider than F32_MAX_WIDTH, the weight ring, then the x0 fill's scratch
    (`scratch` floats a point: the ray march's 3, the whole field's colour
    head 17)."""
    return ((desc[2] + desc[6] + f32_spill_rows(desc[6])) * F32_STRIDE * 4 + F32_RING
            + F32_ROWS * scratch * 4)


def f32_fits(desc: Sequence[int]) -> bool:
    """As f32_ok: the shared memory fits (wider products run in column
    passes)."""
    return f32_smem(desc) <= SMEM_LIMIT


def f32_tile_width(ncols: int) -> int:
    """As f32_tile_width: the columns an F32Tile covers for a product ncols
    wide."""
    return 256 if ncols > 128 else (128 if ncols > 64 else 64)


def f32_tile(ncols: int) -> Tuple[int, int]:
    """As f32_tile_width / with_f32_tile: the (TM, TN) register tile of a
    128-point product ncols wide (8 x 8 up to 256 columns, 8 x 4 up to 128,
    4 x 4 up to 64)."""
    return (8, 8) if ncols > 128 else ((8, 4) if ncols > 64 else (4, 4))


def forward_path(desc: Sequence[int], bf16: bool) -> Optional[str]:
    """As fwd_path: f32 compute takes the f32 kernel when f32_fits; bf16
    the narrow one-pass kernel when no layer has a skip, every
    padded width (input included) is <= 64 and its shared memory fits,
    else the wgmma kernel when it has a plan and its shared memory fits.
    None when no kernel takes the stack."""
    if not bf16:
        return "f32" if f32_fits(desc) else None
    in_pad = desc[2]
    if (in_pad <= NARROW_WIDTH and all(not skip and k <= NARROW_WIDTH and n <= NARROW_WIDTH
                                       for k, n, skip, _, _ in layers(desc))
            and narrow_smem(desc) <= SMEM_LIMIT):
        return "narrow"
    if wgmma_plan(desc)[0] is not None and wg_smem(desc) <= SMEM_LIMIT:
        return "wgmma"
    return None


WALK_ROWS = 64  # points per CTA of the bf16 backward's walk
WALK_RING = 3 * 4 * 16 * 32 * 16  # the bf16 walk's weight ring: 3 slots of 4 k-tiles x 256 columns (bytes)


def walk_smem(desc: Sequence[int], bf16: bool) -> int:
    """As the backward's smem_layout / walk32_smem (the walk of a stack
    that is not narrow). bf16: x0, two activation buffers as wide as the
    widest hidden or output layer, dx0, the last layer's f32
    pre-activation for a sigmoid head only, the relu masks, the db
    partials and the weight ring. f32: x0 (dx0 after the recompute) and
    one activation / dh buffer as wide as the widest layer, k-major, with
    its spill rows past F32_MAX_WIDTH, the weight ring and the db
    partials."""
    ls = layers(desc)
    in_pad, hid_pad, out_pad = desc[2], desc[6], ls[-1][1]
    wid = max(hid_pad, out_pad)
    if not bf16:
        return (in_pad + wid + f32_spill_rows(wid)) * F32_STRIDE * 4 + F32_RING + F32_DBW
    x0 = _round_up(WALK_ROWS * (in_pad + 8) * 2, 16)
    h = _round_up(WALK_ROWS * (wid + 8) * 2, 16)
    off = x0 + 2 * h + _round_up(WALK_ROWS * (in_pad + 4) * 4, 16)
    if desc[8]:  # out_sigmoid
        off += _round_up(WALK_ROWS * (out_pad + 4) * 4, 16)
    off += _round_up(max(len(ls) - 1, 1) * WALK_ROWS * ((wid + 31) // 32) * 4, 16)
    return off + _round_up(2 * wid * 4, 16) + WALK_RING


F32_DW_ROWS = 128  # rows (of W) of an f32 dW tile; its columns: f32_tile_width of the layer
F32_DW_CHUNK = 32  # points per stage of the f32 dW kernel
SUM_GROUP = 64  # slabs summed per block in the first db sum


def f32_bwd_plan(desc: Sequence[int], n: int, num_sms: int) -> dict:
    """As make_plan for f32 compute: 128-point walk blocks; dW tasks of
    F32_DW_ROWS x f32_tile_width(n_pad) over every layer; at most four
    full waves of one CTA an SM (splits of the points, whole chunks each);
    the workspace (x0, the hidden
    activations, every layer's dh, the walk's relu-mask words: two 32-bit
    words a thread, hidden layer's column pass and walk block) in floats; the scratch (dW
    slabs a split, db slabs a walk block, then the db sums of groups of
    SUM_GROUP) in floats."""
    ls = layers(desc)
    rows = -(-n // F32_ROWS) * F32_ROWS
    blocks = rows // F32_ROWS
    tasks = sum(-(-k // F32_DW_ROWS) * -(-m // f32_tile_width(m)) for k, m, *_ in ls)
    splits = min(max(4 * num_sms // tasks, 1), rows // F32_DW_CHUNK)
    per_split = -(-(-(-rows // splits)) // F32_DW_CHUNK) * F32_DW_CHUNK
    splits = -(-rows // per_split)
    total_w = sum(k * m for k, m, *_ in ls)
    total_b = sum(m for _, m, *_ in ls)
    ws = rows * (desc[2] + sum(m for _, m, *_ in ls[:-1]) + sum(m for _, m, *_ in ls))
    ws += sum(len(f32_pass_cols(m)) for _, m, *_ in ls[:-1]) * blocks * F32_THREADS * 2
    scratch = splits * total_w + blocks * total_b + -(-blocks // SUM_GROUP) * total_b
    return {"rows": rows, "walk_blocks": blocks, "tasks": tasks, "splits": splits, "rows_per_split": per_split,
            "ws_elems": ws, "scratch_floats": scratch}


# The f32 stacks the registered methods run through rows 1-6 under f32
# compute (--pipeline.model.compute-dtype float32): (in_dim, layer widths
# incl. output, skips, freq_encoding, out_act), the points of a main-path
# call, and the floats a point of the x0 fill's scratch that carries them
# there (the ray march's 3: the base stack as the cross density and the
# whole field's base, the proposals; the whole field's colour head 17; a
# plain fused_mlp call 0).
_BASE = (3, (256,) * 7 + (16,), (4,), (10, 0.0, 9.0, True), None)
F32_STACKS = {
    "thermal-nerfacto-tpu base": (_BASE, 1 << 20, 3),
    "TV points (base stack)": (_BASE, 35_000, 0),
    "colour head C=1": ((63, (64, 64, 1), (), None, "sigmoid"), 1 << 20, 17),
    "colour head C=3": ((63, (64, 64, 3), (), None, "sigmoid"), 1 << 20, 17),
    "colour head C=4 (RGBT)": ((63, (64, 64, 4), (), None, "sigmoid"), 1 << 20, 17),
    "proposal F5": ((3, (64, 64, 1), (), (5, 0.0, 4.0, True), None), 4_194_304, 3),
    "proposal F7": ((3, (64, 64, 1), (), (7, 0.0, 6.0, True), None), 1_572_864, 3),
    "vanilla-nerf base": ((63, (256,) * 8, (4,), None, None), 1 << 20, 0),
    "mipnerf base": ((99, (256,) * 8, (4,), None, None), 1 << 20, 0),
}

# Stacks whose products are wider than 256 and run in column passes (the
# CPU emulations and the card tests): a 272-wide layer 0 (written in place,
# it reads only x0); 288-wide hidden layers that read the activations they
# overwrite (the spill rows), a skip, a sigmoid head; a 272-wide input
# (dx0 in passes in the backward).
F32_PASS_STACKS = {
    "pass_272": (3, (272, 16), (), (4, 0.0, 3.0, True), None),
    "pass_spill_skip": (12, (288, 288, 20), (1,), None, "sigmoid"),
    "pass_wide_input": (260, (64, 64, 3), (1,), None, "sigmoid"),
}
