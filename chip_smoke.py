#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerfstudio_thermal_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each fatal on failure:
1. the card's name and power limit (nvidia-smi);
2. build the fused-MLP forward and backward kernels from csrc/ with nvcc
   (sm_90a), one nvcc per source, started together; build seconds and
   registers;
3. the forward kernel against its plain PyTorch version on the card, at the
   main path's shape and in the other supported modes; kernel, plain,
   library (a chain of torch.matmul calls, a yardstick the port never
   calls) and bound times;
4. the backward kernel against its plain version (dx, every dW, every db)
   in the same modes; at the base shape (N = 262,144, the RGB field's
   points per training step) kernel, plain, bound, library (forward +
   torch.autograd.grad through the torch.matmul chain) and forward +
   backward kernel times;
5. the render path: thermal-nerfacto-tpu at full width (seeded random
   weights) answers render requests through get_outputs_for_camera /
   render_camera_device: 1920x1080 and 640x512. Every image output must be
   finite and of the right shape, the fused-MLP launch count must be
   4 x chunks per frame, and a small render must agree with the same model
   evaluated on the CPU;
6. the training path: a scene of its own (8 RGB 640x480 and 8 thermal
   640x512 frames of a ray-traced textured sphere) trains
   thermal-nerfacto-tpu at full width through setup_trainer ->
   Trainer.setup -> Trainer.train for 30 steps of 8192 rays. Every loss is
   finite, every param group changes, each step launches 4 forward and 4
   backward fused-MLP kernels, and the proposal update counter follows
   proposal_updated; train ms/step and rays/s over steps 10-29;
7. one full-width step of 256 rays on the card against the same step on
   the CPU (same params, batch and jitter): every loss term and every
   group's gradient;
8. a JSON line of the ported kernels, then the contract line.

--profile DIR additionally writes torch.profiler tables of one 1080p chunk
and of one training step to DIR. Exits non-zero without CUDA; imports
nothing of JAX.
"""

import argparse
import copy
import json
import math
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
BASE_FREQ = (10, 0.0, 9.0, True)
BASE_DIMS = (256,) * 7 + (16,)
# bf16: one flipped bf16 rounding in an early layer moves the output by
# about one bf16 step (2^-8 relative); f32: same exact products and sums in
# another order.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Backward, per tensor, relative L2 error: f32 exact products summed in
# another order over N; bf16 one flipped rounding of dh or of a relu mask
# at a tie moves a layer's dW by about 2^-8 relative.
BWD_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# One training step, card against CPU (bf16 MLPs): losses relative, each
# group's gradient relative L2.
STEP_LOSS_TOL, STEP_GRAD_TOL = 2e-2, 5e-2
TRAIN_STEPS, TIMED_FROM = 30, 10


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mlp_params(gen, in_dim, dims, skips, freq):
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    enc_dim = fm.encoding_dim(in_dim, freq)
    ws, bs, prev = [], [], enc_dim
    for i, dout in enumerate(dims):
        din = prev + (enc_dim if (i in skips and i != 0) else 0)
        ws.append((torch.randn(din, dout, generator=gen) / math.sqrt(din)).cuda())
        bs.append((torch.randn(dout, generator=gen) * 0.1).cuda())
        prev = dout
    return ws, bs


def library_mlp(x, ws, bs, skips, freq, out_act, dtype):
    """The same MLP as a chain of torch.matmul calls in the compute dtype
    (cuBLAS): a yardstick only."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    x0 = (fm.encode(x, freq) if freq is not None else x).to(dtype)
    h = x0
    for li, (w, b) in enumerate(zip(ws, bs)):
        inp = torch.cat([x0, h], -1) if (li in skips and li != 0) else h
        h = torch.matmul(inp, w) + b
        h = torch.relu(h) if li < len(ws) - 1 else (torch.sigmoid(h) if out_act else h)
    return h


def kernel_phase():
    """Kernel vs plain on the card. Returns the main-shape record."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    cases = [
        # name, in_dim, dims, skips, freq, out_act, dtype, n, timed
        ("base_8x256_skip4_bf16", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.bfloat16, 1 << 20, True),
        ("base_f32", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.float32, 1 << 17, False),
        ("sigmoid_4x128_bf16", 3, (128,) * 3 + (3,), (), (6, 0.0, 5.0, True), "sigmoid", torch.bfloat16, 1 << 18, False),
        ("no_encoding_bf16", 32, (128,) * 4 + (16,), (2,), None, None, torch.bfloat16, 1 << 18, False),
        ("no_skip_8x256_bf16", 3, BASE_DIMS, (), BASE_FREQ, None, torch.bfloat16, 1 << 18, False),
        ("ragged_n_base_bf16", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.bfloat16, 777_777, False),
    ]
    gen = torch.Generator().manual_seed(0)
    main = None
    for name, in_dim, dims, skips, freq, out_act, dtype, n, timed in cases:
        ws, bs = mlp_params(gen, in_dim, dims, skips, freq)
        x = torch.rand(n, in_dim, generator=gen).cuda()
        got = fm.fused_mlp(x, ws, bs, "relu", out_act, skips, freq, dtype)
        torch.cuda.synchronize()
        want = fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, freq, dtype)
        err = (got.float() - want.float()).abs()
        limit = TOL[dtype] * (1.0 + want.float().abs())
        max_err = float(err.max())
        if got.shape != want.shape or not bool(torch.isfinite(got.float()).all()) or bool((err > limit).any()):
            raise AssertionError(f"kernel disagrees with plain version in case {name}: max |err| {max_err}")
        line = f"kernel_vs_plain {name}: n={n} max_abs_err={max_err:.3e} (tol {TOL[dtype]:g} abs+rel) ok"
        if timed:
            packed = fm.prepare(in_dim, ws, bs, out_act, skips, freq, dtype)
            ms = cuda_ms(lambda: fm.launch(x, packed), iters=20)
            plain_ms = cuda_ms(lambda: fm.fused_mlp_plain(x, ws, bs, "relu", out_act, skips, freq, dtype), iters=5)
            wb = [w.to(dtype) for w in ws]
            bb = [b.to(dtype) for b in bs]
            library_ms = cuda_ms(lambda: library_mlp(x, wb, bb, skips, freq, out_act, dtype), iters=10)
            macs = sum(w.shape[0] * w.shape[1] for w in ws)
            flops = 2.0 * n * macs
            nbytes = n * (in_dim * 4 + dims[-1] * 2) + sum(w.numel() * 2 + b.numel() * 2 for w, b in zip(ws, bs))
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            main = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "max_abs_err": max_err, "flops": flops,
            }
            line += (
                f" | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms,"
                f" torch.matmul chain {library_ms:.3f} ms, bound {main['bound_ms']:.3f} ms ({main['bound_by']})"
            )
        log(line)
        del ws, bs, x, got, want, err, limit
    torch.cuda.empty_cache()
    return main


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def backward_phase():
    """Backward kernel vs plain on the card. Returns the main-shape record."""
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    cases = [
        # name, in_dim, dims, skips, freq, out_act, dtype, n, timed
        ("base_8x256_skip4_bf16", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.bfloat16, 1 << 18, True),
        ("base_f32", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.float32, 1 << 16, False),
        ("sigmoid_4x128_bf16", 3, (128,) * 3 + (3,), (), (6, 0.0, 5.0, True), "sigmoid", torch.bfloat16, 1 << 18, False),
        ("no_encoding_bf16", 32, (128,) * 4 + (16,), (2,), None, None, torch.bfloat16, 1 << 18, False),
        ("no_skip_8x256_bf16", 3, BASE_DIMS, (), BASE_FREQ, None, torch.bfloat16, 1 << 17, False),
        ("ragged_n_base_bf16", 3, BASE_DIMS, (4,), BASE_FREQ, None, torch.bfloat16, 100_003, False),
    ]
    gen = torch.Generator().manual_seed(1)
    main = None
    for name, in_dim, dims, skips, freq, out_act, dtype, n, timed in cases:
        ws, bs = mlp_params(gen, in_dim, dims, skips, freq)
        x = torch.rand(n, in_dim, generator=gen).cuda()
        g = torch.randn(n, dims[-1], generator=gen).cuda().to(dtype)
        dx, dws, dbs = fm.fused_mlp_bwd(x, g, ws, bs, "relu", out_act, skips, freq, dtype)
        torch.cuda.synchronize()
        want = fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, freq, dtype)
        errs, max_err, scale = {}, 0.0, 0.0
        for key, got_t, want_t in [("dx", [dx], [want[0]]), ("dW", dws, want[1]), ("db", dbs, want[2])]:
            for i, (a, b) in enumerate(zip(got_t, want_t)):
                if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"backward {name}: {key}{i} has shape {tuple(a.shape)} or is not finite")
                errs[f"{key}{i}"] = rel_l2(a, b)
                err = float((a.double() - b.double()).abs().max())
                if err > max_err:
                    max_err, scale = err, float(b.abs().max())
        worst = max(errs, key=errs.get)
        if errs[worst] > BWD_TOL[dtype]:
            raise AssertionError(f"backward kernel disagrees with plain version in case {name}: {worst} rel L2 {errs[worst]:.3e}")
        line = (
            f"bwd_kernel_vs_plain {name}: n={n} worst rel L2 {errs[worst]:.3e} ({worst}),"
            f" max |err| {max_err:.3e} where max |plain| is {scale:.3e} (tol {BWD_TOL[dtype]:g} rel L2) ok"
        )
        if timed:
            packed = fm.prepare(in_dim, ws, bs, out_act, skips, freq, dtype, transposed=True)
            ms = cuda_ms(lambda: fm.launch_bwd(x, g, packed), iters=10)
            plain_ms = cuda_ms(lambda: fm.fused_mlp_bwd_plain(x, g, ws, bs, "relu", out_act, skips, freq, dtype), iters=3)
            pair_ms = cuda_ms(lambda: (fm.launch(x, packed), fm.launch_bwd(x, g, packed)), iters=10)
            wb = [w.to(dtype).requires_grad_(True) for w in ws]
            bb = [b.to(dtype).requires_grad_(True) for b in bs]
            xr = x.clone().requires_grad_(True)

            def library():
                out = library_mlp(xr, wb, bb, skips, freq, out_act, dtype)
                return torch.autograd.grad(out, [xr, *wb, *bb], g)

            library_ms = cuda_ms(library, iters=10)
            macs = sum(w.shape[0] * w.shape[1] for w in ws)
            flops = 6.0 * n * macs  # recompute + dX + dW
            nbytes = n * (in_dim * 4 + dims[-1] * 2 + in_dim * 4) + sum(
                w.numel() * (2 + 4) + b.numel() * (4 + 4) for w, b in zip(ws, bs)
            )
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            main = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "pair_ms": pair_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "max_abs_err": max_err, "n": n,
            }
            line += (
                f" | kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms,"
                f" fwd+bwd kernels {pair_ms:.3f} ms, torch.matmul chain fwd+grad {library_ms:.3f} ms,"
                f" bound {main['bound_ms']:.3f} ms ({main['bound_by']})"
            )
        log(line)
        del ws, bs, x, g, dx, dws, dbs, want
    torch.cuda.empty_cache()
    return main


def make_camera(width, height, focal, c2w):
    from nerfstudio_thermal_torch.cameras.cameras import Cameras, CameraType

    return Cameras(
        camera_to_worlds=torch.as_tensor(c2w, dtype=torch.float32)[None],
        fx=torch.full((1,), focal), fy=torch.full((1,), focal),
        cx=torch.full((1,), width / 2.0), cy=torch.full((1,), height / 2.0),
        width=torch.full((1,), width, dtype=torch.int32),
        height=torch.full((1,), height, dtype=torch.int32),
        distortion_params=torch.zeros(1, 6),
        camera_type=torch.full((1,), CameraType.PERSPECTIVE.value, dtype=torch.int32),
    )


def check_image_outputs(outputs, h, w, expect):
    for key, channels in expect.items():
        if key not in outputs:
            raise AssertionError(f"render output {key} missing")
        v = outputs[key]
        v = torch.as_tensor(v) if isinstance(v, np.ndarray) else v
        if tuple(v.shape) not in ((h * w, channels), (h, w, channels)):
            raise AssertionError(f"render output {key} has shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"render output {key} is not finite")


def slice_phase():
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config
    from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    cfg = get_method_config("thermal-nerfacto-tpu").model
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], np.float32)
    kwargs = dict(num_train_data=2, metadata={"is_thermal": [0, 1]}, seed=0)
    model = ThermalNerfactoModel(cfg, aabb, device="cuda", **kwargs)
    chunk = cfg.eval_num_rays_per_chunk

    # the bench.py camera at 1920x1080, and a second, rotated pose
    c2w_a = np.eye(4, dtype=np.float32)[:3]
    c2w_a[0, 3] = 2.0
    ang = 0.6
    rot = np.array([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0], [-math.sin(ang), 0, math.cos(ang)]], np.float32)
    c2w_b = np.concatenate([rot, np.array([[0.8], [0.3], [1.5]], np.float32)], 1)
    cam_a = make_camera(1920, 1080, 1400.0, c2w_a)
    cam_b = make_camera(640, 512, 500.0, c2w_b)
    expect = {
        "rgb": 3, "accumulation": 1, "depth": 1, "expected_depth": 1,
        "prop_depth_0": 1, "prop_depth_1": 1, "removal": 3,
        "rgb_thermal": 1, "accumulation_thermal": 1, "depth_thermal": 1,
        "expected_depth_thermal": 1, "prop_depth_0_thermal": 1,
        "prop_depth_1_thermal": 1, "removal_thermal": 1,
    }

    # reference: a small render of the same seeded model on the CPU (plain
    # versions of every kernel, smaller chunks) against the card
    ref_cfg = copy.deepcopy(cfg)
    ref_cfg.eval_num_rays_per_chunk = 400
    cpu_model = ThermalNerfactoModel(ref_cfg, aabb, device="cpu", **kwargs)
    small = make_camera(40, 30, 30.0, c2w_b)
    ref = cpu_model.get_outputs_for_camera(small, 0)
    got = model.get_outputs_for_camera(small, 0)
    for key in expect:
        a, b = ref[key], got[key]
        ok = np.abs(a - b) <= 2e-2 * (1.0 + np.abs(a))
        # the median depths are step functions of the cumulative weight, so
        # a one-ulp difference can move a pixel by a whole sample
        if ok.mean() < 0.99 or not np.isfinite(b).all():
            raise AssertionError(f"render {key} disagrees with the CPU reference: {ok.mean():.4f} of pixels agree")
        log(f"render_vs_cpu {key}: {ok.mean() * 100:.2f}% of pixels within 2e-2, max |diff| {np.abs(a - b).max():.3e}")
    del cpu_model

    requests = [("1080p", cam_a, 1920, 1080), ("640x512", cam_b, 640, 512), ("1080p", cam_a, 1920, 1080)]
    fm.fused_mlp.launches = 0
    fm.fused_mlp_bwd.launches = 0
    total = 0
    timings = []
    for name, cam, w, h in requests:
        n_chunks = -(-(w * h) // chunk)
        before = fm.fused_mlp.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "1080p":
            out = model.render_camera_device(cam, 0)
            torch.cuda.synchronize()
        else:
            out = model.get_outputs_for_camera(cam, 0)
        dt = time.perf_counter() - t0
        launches = fm.fused_mlp.launches - before
        check_image_outputs(out, h, w, expect)
        if launches != 4 * n_chunks:
            raise AssertionError(f"{name}: {launches} fused-MLP launches, expected 4 x {n_chunks}")
        total += launches
        timings.append((name, dt))
        log(
            f"render {name}: {n_chunks} chunks, {launches} fused-MLP launches, "
            f"{dt:.3f} s/frame, {w * h / dt:,.0f} rays/s"
        )
    main_launches = fm.fused_mlp.launches
    if main_launches != total or fm.fused_mlp_bwd.launches != 0:
        raise AssertionError(f"render: {main_launches} forward launches (expected {total}), "
                             f"{fm.fused_mlp_bwd.launches} backward launches (expected 0)")

    return main_launches, timings[-1][1], lambda out_dir: profile_chunk(model, cam_a, out_dir)


def write_png(path: Path, img: np.ndarray) -> None:
    """uint8 [H, W, 1 or 3] as a PNG, with the standard library only."""
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return len(body).to_bytes(4, "big") + kind + body + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big")

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, {1: 0, 3: 2}[c], 0, 0, 0])
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b"")
    )


def look_at(eye: np.ndarray) -> np.ndarray:
    """OpenGL camera-to-world looking at the origin, z up."""
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -forward, eye
    return c2w


def render_sphere(c2w: np.ndarray, w: int, h: int, focal: float, thermal: bool) -> np.ndarray:
    """Ray-trace a unit sphere with a latitude/longitude checker texture
    (RGB) or a smooth temperature field (thermal) over a gradient sky."""
    ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    d = np.stack([(xs - w / 2) / focal, -(ys - h / 2) / focal, -np.ones_like(xs)], -1) @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = c2w[:3, 3]
    b = d @ o
    disc = b * b - (o @ o - 1.0)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    n = o + t[..., None] * d
    shade = 0.35 + 0.65 * np.clip(n @ np.array([0.5, 0.3, 0.8]) / np.linalg.norm([0.5, 0.3, 0.8]), 0, 1)
    if thermal:
        value = np.where(hit, 0.35 + 0.45 * (0.5 + 0.5 * n[..., 2]) * shade, 0.08 + 0.04 * d[..., 2])
        return (np.clip(value, 0, 1)[..., None] * 255).astype(np.uint8)
    lon = np.arctan2(n[..., 1], n[..., 0])
    lat = np.arccos(np.clip(n[..., 2], -1, 1))
    checker = (np.floor(lon / (np.pi / 6)) + np.floor(lat / (np.pi / 6))) % 2
    colour = np.where(checker[..., None] > 0, [0.9, 0.45, 0.15], [0.15, 0.55, 0.85]) * shade[..., None]
    sky = np.stack([0.55 + 0.2 * d[..., 2], 0.65 + 0.2 * d[..., 2], 0.8 + 0.1 * d[..., 2]], -1)
    return (np.clip(np.where(hit[..., None], colour, sky), 0, 1) * 255).astype(np.uint8)


def write_scene(root: Path, num_pairs: int = 8) -> Path:
    """transforms.json + images/ (RGB 640x480) + images_thermal/ (grey
    640x512): the ThermalNerf layout, RGB frames first."""
    frames = []
    for modality, (w, h), sub in (("rgb", (640, 480), "images"), ("thermal", (640, 512), "images_thermal")):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for i in range(num_pairs):
            ang = 2 * np.pi * i / num_pairs
            c2w = look_at(np.array([3.0 * np.cos(ang), 3.0 * np.sin(ang), 1.2]))
            focal = 0.8 * w
            name = f"frame_{i:04d}.png"
            write_png(root / sub / name, render_sphere(c2w, w, h, focal, modality == "thermal"))
            frames.append({
                "file_path": f"{sub}/{name}", "transform_matrix": c2w.tolist(),
                "fl_x": focal, "fl_y": focal, "cx": w / 2, "cy": h / 2, "w": w, "h": h,
                "is_thermal": int(modality == "thermal"),
            })
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    return root


def train_method(scene_dir: Path, rays: int):
    from nerfstudio_thermal_torch.configs.method_configs import get_method_config

    method = get_method_config("thermal-nerfacto-tpu")
    method.data = scene_dir
    method.datamanager.train_num_rays_per_batch = rays
    return method


def train_phase(scene_dir: Path, run_dir: Path):
    """30 full-width steps through setup_trainer -> Trainer.setup ->
    Trainer.train, with the launch counts read around Trainer.train."""
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer
    from nerfstudio_thermal_torch.models.nerfacto import proposal_updated
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    method = train_method(scene_dir, 8192)
    method.trainer.max_num_iterations = TRAIN_STEPS
    t0 = time.perf_counter()
    trainer = setup_trainer(method, base_dir=run_dir, device="cuda")
    trainer.setup()
    log(f"train setup (parse, model, optimizers): {time.perf_counter() - t0:.2f} s")
    groups = trainer.model.param_groups()
    before = {name: [p.detach().clone() for p in params] for name, params in groups.items()}
    records, step_times = [], []
    iteration = trainer.train_iteration

    def counted_iteration(step):
        """One Trainer iteration (host sampling included), synchronized and
        timed, with its kernel launches and proposal counter."""
        f0, b0 = fm.fused_mlp.launches, fm.fused_mlp_bwd.launches
        ssu = trainer.state.steps_since_update
        t_start = time.perf_counter()
        out = iteration(step)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t_start)
        records.append((step, ssu, trainer.state.steps_since_update,
                        fm.fused_mlp.launches - f0, fm.fused_mlp_bwd.launches - b0, out))
        return out

    trainer.train_iteration = counted_iteration
    fm.fused_mlp.launches = 0
    fm.fused_mlp_bwd.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    fwd, bwd = fm.fused_mlp.launches, fm.fused_mlp_bwd.launches

    if len(records) != TRAIN_STEPS:
        raise AssertionError(f"{len(records)} train steps ran, expected {TRAIN_STEPS}")
    losses = {k: torch.stack([r[5][k].float() for r in records]) for k in records[0][5] if "loss" in k}
    for k, v in losses.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"train: {k} is not finite")
    for step, _, _, nf, nb, _ in records:
        if (nf, nb) != (4, 4):
            raise AssertionError(f"train step {step}: {nf} forward and {nb} backward fused-MLP launches, expected 4 + 4")
    skipped = 0
    for step, ssu, new_ssu, _, _, _ in records:
        updated, want = proposal_updated(step, ssu, method.model.proposal_warmup, method.model.proposal_update_every)
        if new_ssu != want:
            raise AssertionError(f"train step {step}: steps_since_update {new_ssu}, proposal_updated says {want}")
        skipped += step >= TIMED_FROM and not updated
    if skipped == 0:
        raise AssertionError("no step from 10 on skipped the proposal update")
    unchanged = [
        name for name, params in groups.items()
        if all(torch.equal(a, p.detach()) for a, p in zip(before[name], params))
    ]
    if unchanged:
        raise AssertionError(f"param groups {unchanged} did not change in training")
    if not (run_dir / "nerfstudio_models" / f"step-{TRAIN_STEPS:09d}.ckpt").exists():
        raise AssertionError("Trainer.train saved no final checkpoint")
    step_s = float(np.mean(step_times[TIMED_FROM:]))
    rays = method.datamanager.train_num_rays_per_batch
    log(
        f"train: {TRAIN_STEPS} steps of {rays} rays, param groups {sorted(groups)} all changed, "
        f"{fwd} forward + {bwd} backward fused-MLP launches (4 + 4 per step), "
        f"{skipped} of steps {TIMED_FROM}-{TRAIN_STEPS - 1} without proposal update; "
        f"loss {float(losses['rgb_loss'][0]):.4f} -> {float(losses['rgb_loss'][-1]):.4f} (rgb), "
        f"{float(losses['thermal_loss'][0]):.4f} -> {float(losses['thermal_loss'][-1]):.4f} (thermal)"
    )
    log(f"train steps {TIMED_FROM}-{TRAIN_STEPS - 1}: {step_s * 1e3:.2f} ms/step, {rays / step_s:,.0f} rays/s "
        f"(peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)")
    trainer.train_iteration = iteration
    return fwd, bwd, step_s, rays, lambda out_dir: profile_step(trainer, out_dir)


def step_vs_cpu_phase(scene_dir: Path, run_dir: Path):
    """One full-width step of 256 rays on the card and on the CPU from the
    same seeded params, batch and jitter."""
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer

    method = train_method(scene_dir, 256)
    trainers = {}
    for dev in ("cpu", "cuda"):
        trainers[dev] = setup_trainer(copy.deepcopy(method), base_dir=run_dir / dev, device=dev)
        trainers[dev].setup()
    for (k, a), b in zip(trainers["cpu"].model.state_dict().items(), trainers["cuda"].model.state_dict().values()):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f"step_vs_cpu: the seeded models differ at {k}")
    batch = trainers["cpu"].datamanager.next_train(0)
    gen = torch.Generator().manual_seed(7)
    levels = len(method.model.num_proposal_samples_per_ray) + 1
    uniforms = {m: [torch.rand(256, 1, generator=gen) for _ in range(levels)] for m in ("rgb", "thermal")}
    results = {}
    for dev, tr in trainers.items():
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        u = {m: [t.to(dev) for t in us] for m, us in uniforms.items()}
        scalars = tr._train_step(tr.state, b, uniforms=u)
        grads = {
            name: torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten().float().cpu() for p in ps])
            for name, ps in tr.model.param_groups().items()
        }
        results[dev] = ({k: float(v) for k, v in scalars.items()}, grads)
    (want_s, want_g), (got_s, got_g) = results["cpu"], results["cuda"]
    worst_loss = 0.0
    for k, w in want_s.items():
        err = abs(got_s[k] - w) / max(abs(w), 1e-3)
        worst_loss = max(worst_loss, err)
        if not math.isfinite(got_s[k]) or err > STEP_LOSS_TOL:
            raise AssertionError(f"step_vs_cpu: {k} card {got_s[k]:.6g} cpu {w:.6g}")
    worst_grad = {}
    for name, w in want_g.items():
        worst_grad[name] = rel_l2(got_g[name], w)
        if not bool(torch.isfinite(got_g[name]).all()) or worst_grad[name] > STEP_GRAD_TOL:
            raise AssertionError(f"step_vs_cpu: gradient of {name} rel L2 {worst_grad[name]:.3e}")
    log(
        f"step_vs_cpu (256 rays, full width): {len(want_s)} losses/metrics within {worst_loss:.2e} rel "
        f"(tol {STEP_LOSS_TOL:g}); gradients rel L2 "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst_grad.items()) + f" (tol {STEP_GRAD_TOL:g})"
    )


def profile_step(trainer, out_dir: Path) -> None:
    """torch.profiler over one training step: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    step = trainer.state.step
    trainer.train_iteration(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_iteration(step + 1)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
    (out_dir / "train_step_profile.txt").write_text(table)
    log(f"profile of one training step written to {out_dir / 'train_step_profile.txt'}")


def profile_chunk(model, cam, out_dir):
    """torch.profiler over one chunk of 512x64 rays: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    width = model.config.eval_num_rays_per_chunk // 64
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.render_camera_device(cam, 0, width=width, height=64)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / "chunk_profile.txt").write_text(table)
    log(f"profile of one {width}x64 chunk written to {out_dir / 'chunk_profile.txt'}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", default=None,
                        help="write profiler tables of one render chunk and one training step here")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import nerfstudio_thermal_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    from nerfstudio_thermal_torch.ops.cuda import fused_mlp as fm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)

    built = fm.build()
    for kind, (path, seconds, build_log) in built.items():
        regs = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
        log(f"build {path.name}: {seconds:.2f} s; " + "; ".join(regs))
        fm.load_library(kind)

    fwd_kernel = kernel_phase()
    bwd_kernel = backward_phase()
    render_launches, frame_s, profile_render = slice_phase()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene = write_scene(Path(tmp) / "sphere")
        log(f"scene: 8 RGB 640x480 + 8 thermal 640x512 frames written in {time.perf_counter() - t0:.2f} s")
        train_fwd, train_bwd, step_s, rays, profile_train = train_phase(scene, Path(tmp) / "run")
        step_vs_cpu_phase(scene, Path(tmp) / "step")
        if args.profile is not None:
            # after every timed phase: a profiler session slows the host ops
            # that follow it
            profile_render(Path(args.profile))
            profile_train(Path(args.profile))

    common = {"route": "cuda"}
    kernels = [
        {
            "name": "fused_mlp_fwd", **common,
            "source": "nerfstudio_thermal_torch/csrc/fused_mlp_fwd.cu",
            "replaces": "nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:318",
            "launches": train_fwd,
            **{k: fwd_kernel[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "fused_mlp_bwd", **common,
            "source": "nerfstudio_thermal_torch/csrc/fused_mlp_bwd.cu",
            "replaces": "nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:413",
            "launches": train_bwd,
            **{k: bwd_kernel[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        },
    ]
    log(f"1080p frame: {frame_s:.3f} s, {1920 * 1080 / frame_s:,.0f} rays/s ({render_launches} forward launches in the render path)")
    log(f"train: {step_s * 1e3:.2f} ms/step, {rays / step_s:,.0f} rays/s ({smi})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
