"""ns-eval: score a trained run's eval images
(counterpart of nerfstudio_thermal_tpu/scripts/eval.py).

    python -m nerfstudio_thermal_torch.scripts.eval --load-config RUN/config.yml [--output-path out.json]

Reloads the run through `eval_setup` (on the card) and writes the JSON the
JAX package's ns-eval writes: experiment_name, method_name, checkpoint,
lpips_provenance and results (the mean and std over the eval set of PSNR,
SSIM and LPIPS per modality, and the render throughput).
"""

import json
import sys
from pathlib import Path
from typing import List, Optional, Union

import torch

from nerfstudio_thermal_torch.utils.precision import pin_precision


def main(argv: Optional[List[str]] = None, *, device: Union[str, torch.device] = "cuda") -> int:
    """`device` is the seam for tests, which pass "cpu"."""
    pin_precision()
    argv = list(sys.argv[1:] if argv is None else argv)
    load_config = None
    output_path = Path("output.json")
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-h", "--help"):
            print("usage: ns-eval --load-config CONFIG.yml [--output-path out.json]")
            return 0
        key, eq, val = tok.partition("=")
        if key in ("--load-config", "--output-path"):
            if not eq:
                if i + 1 >= len(argv):
                    print(f"error: {key} expects a value", file=sys.stderr)
                    return 2
                val = argv[i + 1]
                i += 1
            if key == "--load-config":
                load_config = Path(val)
            else:
                output_path = Path(val)
        else:
            print(f"error: unexpected argument {tok}", file=sys.stderr)
            return 2
        i += 1
    if load_config is None:
        print("error: --load-config is required", file=sys.stderr)
        return 2

    from nerfstudio_thermal_torch.utils.eval_utils import eval_setup
    from nerfstudio_thermal_torch.utils.lpips import lpips_provenance

    config, trainer = eval_setup(load_config, device=device)
    with torch.no_grad():
        metrics = trainer.pipeline.get_average_eval_image_metrics()
    out = {
        "experiment_name": config.trainer.experiment_name,
        "method_name": config.method_name,
        "checkpoint": str(config.trainer.load_dir),
        "lpips_provenance": lpips_provenance(),
        "results": metrics,
    }
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
