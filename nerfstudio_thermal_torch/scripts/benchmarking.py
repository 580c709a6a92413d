"""ns-benchmark: train a method on the Blender scenes and score them
(counterpart of nerfstudio_thermal_tpu/scripts/benchmarking.py).

    ns-benchmark-torch --method nerfacto --data-dir data/blender \
        [--scenes lego,chair] [--output-dir DIR] [-- extra ns-train flags]

Trains each scene with the port's ns-train and scores its last checkpoint
with the port's ns-eval, both in this process and on the card, with the
reference's nerfacto benchmark overrides (white background, uniform initial
sampler, near/far 2/6, camera optimizer off, no appearance averaging, no
distortion loss, contraction off) for `nerfacto*` and `thermal-nerfacto*`.
Each ns-train argv ends with the `blender-data` dataparser subcommand, as
the reference's script ends it; the JAX script's argv lacks it, so its
nerfacto looks for a transforms.json that a Blender scene does not have.
Writes OUTPUT_DIR/TIMESTAMP/benchmark.json: the method, the timestamp, each
scene's ns-eval results (or the failing step's error) and the mean PSNR,
as the JAX script does (reference
`nerfstudio/scripts/benchmarking/launch_{train,eval}_blender.sh`).
"""

import json
import sys
import time
from pathlib import Path
from typing import List, Optional

BLENDER_SCENES = (
    "mic", "ficus", "chair", "hotdog", "materials", "drums", "ship", "lego"
)

# launch_train_blender.sh nerfacto-specific overrides
NERFACTO_BENCH_OVERRIDES = [
    "--pipeline.model.background-color", "white",
    "--pipeline.model.proposal-initial-sampler", "uniform",
    "--pipeline.model.near-plane", "2.0",
    "--pipeline.model.far-plane", "6.0",
    "--pipeline.model.camera-optimizer.mode", "off",
    "--pipeline.model.use-average-appearance-embedding", "False",
    "--pipeline.model.distortion-loss-mult", "0",
    "--pipeline.model.disable-scene-contraction", "True",
]


def main(argv: Optional[List[str]] = None, *, device="cuda") -> int:
    """`device` (passed to ns-train and ns-eval) is the seam for tests,
    which pass "cpu"."""
    argv = list(sys.argv[1:] if argv is None else argv)
    method = "nerfacto"
    data_dir = Path("data/blender")
    output_dir = Path("benchmarks")
    scenes = None
    extra: list = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(
                "usage: ns-benchmark [--method M] [--data-dir DIR] "
                "[--scenes s1,s2] [--output-dir DIR] [-- extra ns-train flags]"
            )
            return 0
        if a == "--method":
            method = argv[i + 1]; i += 2
        elif a == "--data-dir":
            data_dir = Path(argv[i + 1]); i += 2
        elif a == "--output-dir":
            output_dir = Path(argv[i + 1]); i += 2
        elif a == "--scenes":
            scenes = argv[i + 1].split(","); i += 2
        elif a == "--":
            extra = argv[i + 1:]; break
        else:
            print(f"error: unknown flag {a}", file=sys.stderr)
            return 2

    from nerfstudio_thermal_torch.scripts import eval as ns_eval
    from nerfstudio_thermal_torch.scripts import train as ns_train

    scenes = scenes or [s for s in BLENDER_SCENES if (data_dir / s).exists()]
    if not scenes:
        print(
            f"error: no blender scenes found under {data_dir} "
            f"(expected subdirs like {', '.join(BLENDER_SCENES[:3])}...)",
            file=sys.stderr,
        )
        return 1

    timestamp = time.strftime("%Y-%m-%d_%H%M%S")
    output_dir.mkdir(parents=True, exist_ok=True)
    results = {}
    for scene in scenes:
        print(f"=== benchmarking {method} on {scene} ===", flush=True)
        run_args = [
            method, "--data", str(data_dir / scene),
            "--output-dir", str(output_dir / timestamp),
            "--experiment-name", scene,
        ]
        if method.startswith("nerfacto") or method.startswith("thermal-nerfacto"):
            run_args += NERFACTO_BENCH_OVERRIDES
        run_args += extra
        # the Blender parser, as the reference's launch_train_blender.sh
        # selects it (nerfacto's own reads transforms.json, which a Blender
        # scene does not have)
        run_args.append("blender-data")
        rc = ns_train.main(run_args, device=device)
        if rc != 0:
            results[scene] = {"error": f"train failed rc={rc}"}
            continue
        configs = sorted(
            (output_dir / timestamp / scene).glob("**/config.yml")
        )
        metrics_path = output_dir / timestamp / f"{scene}_metrics.json"
        rc = ns_eval.main([
            "--load-config", str(configs[-1]),
            "--output-path", str(metrics_path),
        ], device=device)
        if rc != 0:
            results[scene] = {"error": f"eval failed rc={rc}"}
            continue
        results[scene] = json.loads(metrics_path.read_text())["results"]

    psnrs = [
        r.get("psnr_rgb", r.get("psnr"))
        for r in results.values()
        if isinstance(r, dict) and (r.get("psnr_rgb") or r.get("psnr"))
    ]
    summary = {
        "method": method,
        "timestamp": timestamp,
        "scenes": results,
        "mean_psnr": float(sum(psnrs) / len(psnrs)) if psnrs else None,
    }
    dest = output_dir / timestamp / "benchmark.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    print(f"wrote {dest}")
    return 0


def entrypoint():
    sys.exit(main())


if __name__ == "__main__":
    entrypoint()
