#!/usr/bin/env python3
"""Training ms/step of the port on one GPU, with the native or the Python
batch sampler, for comparing samplers and trees on one machine.

    python3 train_timing.py [--sampler native|python] [--root DIR] [--label NAME]
                            [--hash] [--field]

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

    here = local_smoke() if args.hash else None

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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
