#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nerfstudio_thermal_torch) on one GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each fatal on failure:
1. the card's name and power limit (nvidia-smi);
2. build the fused-MLP kernel from csrc/ with nvcc (sm_90a);
3. the kernel against its plain PyTorch version on the card, at the main
   path's shape and in the other supported modes; kernel, plain, library
   (a chain of torch.matmul calls, a yardstick the port never calls) and
   bound times;
4. the slice: thermal-nerfacto-tpu at full width (seeded random weights)
   answers render requests through get_outputs_for_camera /
   render_camera_device: 1920x1080 and 640x512. Every image output must be
   finite and of the right shape, the fused-MLP launch count must be
   4 x chunks per frame, and a small render must agree with the same
   model evaluated on the CPU (plain versions of every kernel);
5. a JSON line of the ported kernels, then the contract line.

--profile DIR additionally writes a torch.profiler table of one 1080p
chunk to DIR. Exits non-zero without CUDA; imports nothing of JAX.
"""

import argparse
import copy
import json
import math
import subprocess
import sys
import time
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


def slice_phase(profile_dir):
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
    assert main_launches == total

    if profile_dir is not None:
        profile_chunk(model, cam_a, Path(profile_dir))
    return main_launches, timings[-1][1]


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
    parser.add_argument("--profile", default=None, help="write a profiler table of one chunk here")
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

    path, seconds, build_log = fm.build()
    regs = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
    log(f"build {path.name}: {seconds:.2f} s; " + "; ".join(regs))
    fm.load_library()

    main_kernel = kernel_phase()
    launches, frame_s = slice_phase(args.profile)

    kernels = [{
        "name": "fused_mlp_fwd",
        "route": "cuda",
        "source": "nerfstudio_thermal_torch/csrc/fused_mlp_fwd.cu",
        "replaces": "nerfstudio_thermal_tpu/ops/pallas/fused_mlp.py:318",
        "launches": launches,
        "max_abs_err": main_kernel["max_abs_err"],
        "ms": main_kernel["ms"],
        "plain_ms": main_kernel["plain_ms"],
        "bound_ms": main_kernel["bound_ms"],
        "bound_by": main_kernel["bound_by"],
        "library_ms": main_kernel["library_ms"],
    }]
    log(f"1080p frame: {frame_s:.3f} s, {1920 * 1080 / frame_s:,.0f} rays/s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
