#!/usr/bin/env python3
"""Training ms/step of the port on one GPU, with the native or the Python
batch sampler, for comparing samplers and trees on one machine.

    python3 train_timing.py [--sampler native|python] [--root DIR] [--label NAME]
                            [--hash] [--field] [--f32] [--vjp]
                            [--backward-ab]

Trains each of chip_smoke.py's three configurations (thermal-nerfacto-tpu,
thermal-nerfacto, thermal-nerfacto-tpu+fused) for 30 steps of 8192 rays on
chip_smoke.py's sphere scene, through setup_trainer -> Trainer.setup ->
Trainer.train_iteration, each step ended by torch.cuda.synchronize(). Then
times the data manager's next_train alone over 30 more steps. Prints one
line per configuration: `TIMING {json}` with the mean, median and least
ms/step of steps 10-29 (host sampling included, as chip_smoke.py's train
metric), the sampler's mean ms per batch, whether the native sampler ran,
and the card's nvidia-smi name and power limit.

--hash times thermal-nerfacto alone, and more of it: its 1080p frame
(six renders through render_camera_device, the first a warm-up), the
device time of one 512 x 64 render chunk and of training steps 30-34
(torch.profiler, the sum of kernel times; and of each hash kernel in
steps 36-40), and the three hash kernels on
the positions and cotangents the model produced (the 8 hash calls of one
render chunk and of training step 9, timed by this checkout's
chip_smoke.hash_model_phase, which also holds each against the plain
versions). Prints `HASH {json}` with those numbers besides the TIMING
line.

--field times thermal-nerfacto-tpu+fused alone: its 1080p frame (six
renders, the first a warm-up) and row 5, the whole-field forward, through
that checkout's own chip_smoke.field_split_phase where it has one (CUDA-event
ms as a training step and as a render chunk call it, the device ms of each
kernel it launches, row 3's cross density on the same rays). Prints
`FIELD {json}`.

--f32 times rows 1-6 at f32 compute: each f32 kernel at the shapes
chip_smoke.py times it (rows 1-2 on thermal-nerfacto-tpu's base stack,
a 3 x 64 proposal stack and the colour head, and both NeRF stacks; rows
3-6 at phase 6's shapes), CUDA-event ms through the kernel wrappers
(prepare, launch, launch_bwd, launch_ray, fused_ray_mlp_bwd, launch_field,
fused_field_mlp_bwd; this checkout's f32_kernel_times), and the peak
device memory of one row-2 backward beyond what was allocated before it;
then ms/step (steps 10-29 of 30) with --pipeline.model.compute-dtype
float32 of thermal-nerfacto-tpu+fused (8192 rays, the sphere scene) and of
vanilla-nerf with use_pallas (4096 rays, through that checkout's
chip_smoke.classic_train on its blender scene). Prints `F32 {json}`.

--vjp times the hash position gradient's VJP kernel on neus-facto's
training step 9 (its one VJP call, recorded by that checkout's
chip_smoke.classic_train over 10 steps of 2048 rays on chip_smoke.py's RGB
sphere scene): that checkout's kernel through its C entry point
(hash_encoding.load_library) on preallocated outputs, d_table not zeroed
between calls, for every set of outputs (dg, d_table, d_pos2), each set
first held against hash_encode_bwd_pos_vjp_plain (chip_smoke.VJP_TOLS, dg
bitwise); with the bounds (chip_smoke.vjp_cost), the plain version's ms
and the REDs d_table needs per level (vjp_red_counts). Prints `VJP {json}`.

--backward-ab trains the three configurations for 70 steps each with the
training step's backward alternating from step to step between the
trainer's own (loss.backward of the optimized parameters,
engine/trainer.py:trained_params) and a plain loss.backward(), and prints
`BACKWARD {json}` with the median, mean and least ms/step of each over
steps 10-69 (30 steps each; the two give the same gradients, so the run
trains as either would).

--root imports chip_smoke.py and nerfstudio_thermal_torch from another
checkout (for instance an older commit unpacked with git archive), so that
two trees can be timed in turns on one machine (a tree without the native
sampler needs --sampler python); --hash records and times that checkout's
kernels with this checkout's recorder. Needs CUDA.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

METHODS = ("thermal-nerfacto-tpu", "thermal-nerfacto", "thermal-nerfacto-tpu+fused")
STEPS, TIMED_FROM = 30, 10


def local_smoke():
    """This checkout's chip_smoke.py (its hash recorder and
    hash_model_phase), loaded under another name so that it runs on the
    package already imported from --root."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", Path(__file__).resolve().parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    spec.loader.exec_module(mod)
    sys.path[:] = saved
    return mod


def device_ms(fn, calls: int) -> float:
    """Mean device time (ms) of fn(i), i < calls: the sum of every kernel's
    time in a torch.profiler session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    us = sum(getattr(ev, key) for ev in events)
    return us / 1e3 / calls


def hash_render(cs, here, smi):
    """thermal-nerfacto's render as chip_smoke.py's slice_phase builds it:
    the hash calls of one 1080p chunk, seconds per 1080p frame, device ms
    per chunk."""
    import numpy as np
    import torch
    from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel

    cfg = cs.method_config("thermal-nerfacto").model
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    model = ThermalNerfactoModel(cfg, aabb, device="cuda", num_train_data=2, metadata={"is_thermal": [0, 1]}, seed=0)
    cs.scale_hash_tables(model)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[0, 3] = 2.0
    cam = cs.make_camera(1920, 1080, 1400.0, c2w)
    width = cfg.eval_num_rays_per_chunk // 64
    with torch.no_grad(), here.recording_hash_calls() as calls:
        model.render_camera_device(cam, 0, width=width, height=64)
        torch.cuda.synchronize()
    frames = []
    with torch.no_grad():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.render_camera_device(cam, 0)
            torch.cuda.synchronize()
            frames.append(time.perf_counter() - t0)
        chunk_ms = device_ms(lambda i: model.render_camera_device(cam, 0, width=width, height=64), 3)
    return calls, frames[1:], chunk_ms


def fused_frames(cs):
    """thermal-nerfacto-tpu+fused's 1080p frame as chip_smoke.py's
    slice_phase builds it: seconds of six renders, the first a warm-up."""
    import numpy as np
    import torch
    from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel

    cfg = cs.method_config("thermal-nerfacto-tpu+fused").model
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    model = ThermalNerfactoModel(cfg, aabb, device="cuda", num_train_data=2, metadata={"is_thermal": [0, 1]}, seed=0)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[0, 3] = 2.0
    cam = cs.make_camera(1920, 1080, 1400.0, c2w)
    frames = []
    with torch.no_grad():
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.render_camera_device(cam, 0)
            torch.cuda.synchronize()
            frames.append(time.perf_counter() - t0)
    return frames[1:]


def f32_kernel_times(here, iters: int = 3) -> tuple:
    """CUDA-event ms of each f32 kernel of rows 1-6 on the package imported
    (a --root checkout's), at chip_smoke.py's shapes, inputs from fixed
    seeds; `here` is this checkout's chip_smoke (local_smoke). Also the
    device memory one row-2 backward allocates at its peak beyond what
    was allocated before it (its outputs, workspace and scratch), by
    stack. Returns (ms by kernel and shape, peak bytes by stack)."""
    import torch
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm
    from nerfstudio_thermal_torch.ops.cuda import fused_ray as fr

    f32, gen, out, peak = torch.float32, torch.Generator().manual_seed(21), {}, {}
    stacks = {
        # name: (in_dim, widths, skips, frequencies, out_act), forward points, backward points
        "base": ((3, here.BASE_DIMS, (4,), here.BASE_FREQ, None), 1 << 20, 1 << 18),
        "proposal_f5": ((3, (64, 64, 1), (), (5, 0.0, 4.0, True), None), 4_194_304, 4_194_304),
        "colour_head": ((63, (64, 64, 3), (), None, "sigmoid"), 1 << 20, 1 << 20),
        "vanilla_nerf_63": ((63, here.NERF_DIMS, (4,), None, None), 1 << 20, 1 << 18),
        "mipnerf_99": ((99, here.NERF_DIMS, (4,), None, None), 1 << 20, 1 << 18),
    }
    for name, ((in_dim, dims, skips, freq, out_act), n_fwd, n_bwd) in stacks.items():
        ws, bs = here.mlp_params(gen, in_dim, dims, skips, freq)
        packed = fm.prepare(in_dim, ws, bs, out_act, skips, freq, f32, transposed=True)
        x = torch.rand(n_fwd, in_dim, generator=gen).cuda()
        out[f"row1 {name} n={n_fwd}"] = here.cuda_ms(lambda: fm.launch(x, packed), iters, warmup=1)
        if n_bwd:
            x = x[:n_bwd].contiguous()
            g = torch.randn(n_bwd, dims[-1], generator=gen).cuda()
            out[f"row2 {name} n={n_bwd}"] = here.cuda_ms(lambda: fm.launch_bwd(x, g, packed), iters, warmup=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            grads = fm.launch_bwd(x, g, packed)
            torch.cuda.synchronize()
            peak[f"row2 {name} n={n_bwd}"] = torch.cuda.max_memory_allocated() - before
            del grads
        del x, packed
        torch.cuda.empty_cache()
    for name, dims, skips, freq, r_fwd, r_bwd, s, need in here.RAY_CASES:
        ws, bs = here.mlp_params(gen, 3, dims, skips, freq)
        packed = fm.prepare(3, ws, bs, None, skips, freq, f32, transposed=True)
        o, d, t = here.ray_inputs(gen, r_fwd, s)
        out[f"row3 {name} n={r_fwd * s}"] = here.cuda_ms(lambda: fr.launch_ray(o, d, t, s, packed), iters, warmup=1)
        o, d, t = here.ray_inputs(gen, r_bwd, s)
        g = torch.randn(r_bwd * s, dims[-1], generator=gen).cuda()
        out[f"row4 {name} n={r_bwd * s}"] = here.cuda_ms(lambda: fr.fused_ray_mlp_bwd(o, d, t, g, s, packed, need),
                                                         iters, warmup=1)
        del o, d, t, g, packed
        torch.cuda.empty_cache()
    c, r_fwd, r_bwd, s = here.FIELD_CASES[0]
    bw, bb = here.mlp_params(gen, 3, here.BASE_DIMS, (4,), here.BASE_FREQ)
    hw, hb = here.mlp_params(gen, 63, (64, 64, c), (), None)
    base = fm.prepare(3, bw, bb, None, (4,), here.BASE_FREQ, f32, transposed=True)
    head = fm.prepare(63, hw, hb, "sigmoid", (), None, f32, transposed=True)
    o, d, t = here.ray_inputs(gen, r_fwd, s)
    emb = torch.randn(r_fwd, 32, generator=gen).cuda()
    out[f"row5 C={c} n={r_fwd * s}"] = here.cuda_ms(lambda: fr.launch_field(o, d, t, emb, s, base, head), iters,
                                                    warmup=1)
    o, d, t = here.ray_inputs(gen, r_bwd, s)
    emb = torch.randn(r_bwd, 32, generator=gen).cuda()
    g = torch.randn(r_bwd * s, c + 2, generator=gen).cuda()
    _, head_in = fr.launch_field(o, d, t, emb, s, base, head)
    out[f"row6 C={c} n={r_bwd * s}"] = here.cuda_ms(
        lambda: fr.fused_field_mlp_bwd(o, d, t, emb, g, head_in, s, base, head), iters, warmup=1)
    return out, peak


def f32_steps(cs, tmp: Path) -> dict:
    """ms/step (steps 10-29 of 30) with f32 compute: thermal-nerfacto-tpu+fused
    at 8192 rays and vanilla-nerf with use_pallas at 4096, on the --root
    checkout's scenes and trainers."""
    import torch
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer

    out = {}
    scene = cs.write_scene(tmp / "sphere")
    method = cs.train_method("thermal-nerfacto-tpu+fused", scene, 8192)
    method.model.compute_dtype = "float32"
    method.trainer.max_num_iterations = STEPS
    trainer = setup_trainer(method, base_dir=tmp / "fused_f32", device="cuda")
    trainer.setup()
    step_ms = []
    for step in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_iteration(step)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["thermal-nerfacto-tpu+fused"] = statistics.mean(step_ms[TIMED_FROM:])
    del trainer
    torch.cuda.empty_cache()
    blender = cs.write_classic_blender(tmp / "blender")
    flags = [*cs.CLASSIC["vanilla-nerf"]["flags"], "--pipeline.model.compute-dtype", "float32"]
    run = cs.classic_train("vanilla-nerf", blender, tmp / "vanilla_f32", flags, cs.CLASSIC["vanilla-nerf"]["step"])
    out["vanilla-nerf use_pallas"] = run["step_s"] * 1e3
    return out


VJP_SETS = {"all": (True, True, True), "dg+d_table": (True, True, False), "dg": (True, False, False),
            "d_table": (False, True, False), "d_pos2": (False, False, True), "dg+d_pos2": (True, False, True),
            "d_table+d_pos2": (False, True, True)}


def vjp_red_counts(pos, g, scal, t: int) -> dict:
    """Per level, d_table's REDs on these points (a point adds nothing at a
    level where its g is zero): one a corner (`corners`), one per distinct
    row per warp of 32 points and corner (`warp_corner`: row 7's combine),
    one per distinct row per tile of 256 points (`tile256`: a block-wide
    combine); and the warps in which two neighbouring points that add share
    a cell (`warps_sharing`: the VJP combines only in those)."""
    import torch

    from nerfstudio_thermal_torch.ops import encodings as enc

    n = pos.shape[0]
    hf, hc, _, _ = enc._hash_factors(pos, scal, t)
    rows = torch.stack([enc._corner_index(hf, hc, bits, 0) for bits in enc._CORNER_BITS], -1)  # [L, N, 8]
    point = torch.arange(n, device=pos.device)
    out = {"corners": [], "warp_corner": [], "tile256": [], "warps_sharing": []}
    for level in range(scal.shape[0]):
        live = (g[:, 2 * level] != 0) | (g[:, 2 * level + 1] != 0)
        r, p = rows[level][live], point[live][:, None]
        out["corners"].append(r.numel())
        out["warp_corner"].append(torch.unique(((p // 32) * 8 + torch.arange(8, device=p.device)) * t + r).numel())
        out["tile256"].append(torch.unique((p // 256) * t + r).numel())
        share = live[1:] & live[:-1] & (rows[level, 1:, 0] == rows[level, :-1, 0]) & (point[1:] % 32 != 0)
        out["warps_sharing"].append(torch.unique(point[1:][share] // 32).numel())
    return out


def vjp_timing(cs, tmp: Path, iters: int = 50, rounds: int = 2) -> dict:
    """--vjp: see the module docstring."""
    import torch

    from nerfstudio_thermal_torch.ops import encodings as enc
    from nerfstudio_thermal_torch.ops.cuda import hash_encoding as th

    scene = cs.write_scene(tmp / "sphere_ngp", num_pairs=cs.NGP_PAIRS, thermal=False)
    run = cs.classic_train("neus-facto", scene, tmp / "neus-facto", [], cs.NEUS_FACTO_STEP,
                           steps=cs.SURF_CAPTURE_STEP + 1, capture_step=cs.SURF_CAPTURE_STEP, timed_from=0)
    (rec,) = run.pop("vjp")
    del run
    table, scal, t = rec["table"], rec["scal"], rec["t"]
    pos, g, v = (rec[k].cuda().contiguous() for k in ("pos", "g", "v"))
    n, levels = pos.shape[0], scal.shape[0]
    outs = (torch.empty(n, 2 * levels, device="cuda"), torch.zeros(levels * t, 2, device="cuda"),
            torch.empty(n, 3, device="cuda"))
    fn = th.load_library().hash_encode_bwd_pos_vjp

    def launch(need):
        err = fn(pos.data_ptr(), table.data_ptr(), g.data_ptr(), v.data_ptr(), scal.data_ptr(),
                 *[o.data_ptr() if w else None for o, w in zip(outs, need)], n, levels, t.bit_length() - 1,
                 torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"hash_encode_bwd_pos_vjp: cudaError {err}")

    rel = {}
    for set_name, need in VJP_SETS.items():
        outs[1].zero_()
        launch(need)
        torch.cuda.synchronize()
        want = enc.hash_encode_bwd_pos_vjp_plain(table, pos, g, v, scal, t, *need)
        for name, got, w in zip(("dg", "d_table", "d_pos2"), outs, want):
            if w is not None:
                rel[f"{set_name} {name}"] = r = cs.rel_l2(got, w)
                if not bool(torch.isfinite(got).all()) or r > cs.VJP_TOLS[name] or (
                        name == "dg" and not torch.equal(got, w)):
                    raise AssertionError(f"VJP {set_name}: {name} disagrees with the plain version (rel L2 {r:.3e})")
    ms = {s: [cs.cuda_ms(lambda: launch(need), iters=iters) for _ in range(rounds)] for s, need in VJP_SETS.items()}
    rows = cs.hash_rows_touched(pos, scal, t)
    plain = {s: cs.cuda_ms(lambda: enc.hash_encode_bwd_pos_vjp_plain(table, pos, g, v, scal, t, *VJP_SETS[s]),
                           iters=3) for s in ("dg+d_table", "all")}
    return {"n": n, "levels": levels, "table_size": t, "need": rec["need"], "ms": ms, "plain_ms": plain,
            "bound_ms": {s: cs.bound(*cs.vjp_cost(n, levels, t, rows, need))[0] for s, need in VJP_SETS.items()},
            "rel_l2": rel, "reds": vjp_red_counts(pos, g, scal, t)}


def backward_ab(cs, tmp: Path, steps: int = 70) -> dict:
    """--backward-ab: see the module docstring."""
    import torch

    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
    from nerfstudio_thermal_torch.engine import trainer as trainer_module

    restricted = trainer_module.trained_params
    scene = cs.write_scene(tmp / "sphere")
    out = {}
    for name in METHODS:
        method = cs.train_method(name, scene, 8192)
        method.trainer.max_num_iterations = steps
        trainer = setup_trainer(method, base_dir=tmp / name, device="cuda")
        trainer.setup()
        ms = {"params": [], "plain": []}
        for step in range(steps):
            kind = "plain" if step % 2 else "params"
            trainer_module.trained_params = restricted if kind == "params" else (lambda optimizers: None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_iteration(step)
            torch.cuda.synchronize()
            if step >= TIMED_FROM:
                ms[kind].append((time.perf_counter() - t0) * 1e3)
        trainer_module.trained_params = restricted
        out[name] = {k: {"median": statistics.median(v), "mean": statistics.fmean(v), "min": min(v), "steps": len(v)}
                     for k, v in ms.items()}
        del trainer
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sampler", choices=("native", "python"), default="native")
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent),
                        help="checkout whose chip_smoke.py and package are timed")
    parser.add_argument("--label", default="", help="copied into every output line")
    parser.add_argument("--hash", action="store_true",
                        help="thermal-nerfacto only: frame, device time and the hash kernels on the model's points")
    parser.add_argument("--field", action="store_true",
                        help="thermal-nerfacto-tpu+fused only: its frame and the whole-field forward's split")
    parser.add_argument("--f32", action="store_true",
                        help="rows 1-6 at f32 compute: the f32 kernels, and f32 ms/step of +fused and vanilla-nerf")
    parser.add_argument("--vjp", action="store_true",
                        help="the hash position gradient's VJP kernel on neus-facto's step-9 call")
    parser.add_argument("--backward-ab", action="store_true",
                        help="ms/step with the backward of the parameters only and with a plain backward, interleaved")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("train_timing: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import nerfstudio_thermal_torch  # noqa: F401  (the package of --root, before local_smoke)
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer

    here = local_smoke() if args.hash or args.f32 else None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if args.backward_ab:
        with tempfile.TemporaryDirectory() as tmp:
            out = backward_ab(cs, Path(tmp))
        print("BACKWARD " + json.dumps({"label": args.label, "root": root.name, "device": smi, **out}), flush=True)
        return 0
    if args.vjp:
        with tempfile.TemporaryDirectory() as tmp:
            out = vjp_timing(cs, Path(tmp))
        print("VJP " + json.dumps({"label": args.label, "root": root.name, "device": smi, **out}), flush=True)
        return 0
    if args.f32:
        kernels, peak = f32_kernel_times(here)
        with tempfile.TemporaryDirectory() as tmp:
            steps = f32_steps(cs, Path(tmp))
        print("F32 " + json.dumps({"label": args.label, "root": root.name, "device": smi, "kernels_ms": kernels,
                                   "bwd_peak_bytes": peak, "ms_step": steps}), flush=True)
        return 0
    if args.field:
        frames = fused_frames(cs)
        split = cs.field_split_phase() if hasattr(cs, "field_split_phase") else {}
        print("FIELD " + json.dumps({"label": args.label, "root": root.name, "device": smi, "frame_s": frames,
                                     **split}), flush=True)
        return 0
    hash_out = {}
    if args.hash:
        render_calls, hash_out["frame_s"], hash_out["chunk_device_ms"] = hash_render(cs, here, smi)
    with tempfile.TemporaryDirectory() as tmp:
        scene = cs.write_scene(Path(tmp) / "sphere")
        for name in (("thermal-nerfacto",) if args.hash else METHODS):
            method = cs.train_method(name, scene, 8192)
            method.datamanager.use_native_sampler = args.sampler == "native"
            method.trainer.max_num_iterations = STEPS
            trainer = setup_trainer(method, base_dir=Path(tmp) / name, device="cuda")
            trainer.setup()
            step_ms = []
            for step in range(STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if args.hash and step == TIMED_FROM - 1:  # updates the proposals, not timed
                    with here.recording_hash_calls() as step_calls:
                        trainer.train_iteration(step)
                else:
                    trainer.train_iteration(step)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if args.hash:
                hash_out["step_device_ms"] = device_ms(lambda i: trainer.train_iteration(STEPS + i), 5)
                steps = iter(range(STEPS + 5, STEPS + 11))
                split = here.kernel_split(lambda: trainer.train_iteration(next(steps)))
                hash_out["step_hash_kernels_ms"] = {k: v for k, v in split.items() if "hash_encode" in k}
            sample_ms = []
            for step in range(STEPS, 2 * STEPS):
                t0 = time.perf_counter()
                trainer.datamanager.next_train(step)
                sample_ms.append((time.perf_counter() - t0) * 1e3)
            timed = step_ms[TIMED_FROM:]
            print("TIMING " + json.dumps({
                "label": args.label, "root": root.name, "method": name, "sampler": args.sampler,
                "native_ran": bool(getattr(trainer.datamanager, "uses_native_sampler", False)),
                "ms_step_mean": statistics.mean(timed), "ms_step_median": statistics.median(timed),
                "ms_step_min": min(timed), "ms_next_train": statistics.mean(sample_ms), "device": smi,
            }), flush=True)
    if args.hash:
        sums = here.hash_model_phase({"render_chunk": render_calls, "train_step": step_calls})
        hash_out.update({f"{scope}_{kname}": s for scope, per in sums.items() for kname, s in per.items()})
        print("HASH " + json.dumps({"label": args.label, "root": root.name, "device": smi, **hash_out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
