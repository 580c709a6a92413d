#!/usr/bin/env python3
"""Training ms/step of the port on one GPU, with the native or the Python
batch sampler, for comparing samplers and trees on one machine.

    python3 train_timing.py [--sampler native|python] [--root DIR] [--label NAME]

Trains each of chip_smoke.py's three configurations (thermal-nerfacto-tpu,
thermal-nerfacto, thermal-nerfacto-tpu+fused) for 30 steps of 8192 rays on
chip_smoke.py's sphere scene, through setup_trainer -> Trainer.setup ->
Trainer.train_iteration, each step ended by torch.cuda.synchronize(). Then
times the data manager's next_train alone over 30 more steps. Prints one
line per configuration: `TIMING {json}` with the mean, median and least
ms/step of steps 10-29 (host sampling included, as chip_smoke.py's train
metric), the sampler's mean ms per batch, whether the native sampler ran,
and the card's nvidia-smi name and power limit.

--root imports chip_smoke.py and nerfstudio_thermal_torch from another
checkout (for instance an older commit unpacked with git archive), so that
two trees can be timed in turns on one machine (a tree without the native
sampler needs --sampler python). Needs CUDA.
"""

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

METHODS = ("thermal-nerfacto-tpu", "thermal-nerfacto", "thermal-nerfacto-tpu+fused")
STEPS, TIMED_FROM = 30, 10


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sampler", choices=("native", "python"), default="native")
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent),
                        help="checkout whose chip_smoke.py and package are timed")
    parser.add_argument("--label", default="", help="copied into every output line")
    args = parser.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("train_timing: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nerfstudio_thermal_torch.configs.method_configs import setup_trainer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        scene = cs.write_scene(Path(tmp) / "sphere")
        for name in METHODS:
            method = cs.train_method(name, scene, 8192)
            method.datamanager.use_native_sampler = args.sampler == "native"
            method.trainer.max_num_iterations = STEPS
            trainer = setup_trainer(method, base_dir=Path(tmp) / name, device="cuda")
            trainer.setup()
            step_ms = []
            for step in range(STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_iteration(step)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
