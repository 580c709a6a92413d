"""ns-train: train a registered method
(counterpart of nerfstudio_thermal_tpu/scripts/train.py).

    python -m nerfstudio_thermal_torch.scripts.train thermal-nerfacto --data SCENE \
        [--max-num-iterations 30000] [--output-dir outputs] [--experiment-name NAME] \
        [--pipeline.model.fused-raymarch True] [--<config.path> VALUE ...]

Trains on the card. The run goes to OUTPUT_DIR/EXPERIMENT/METHOD/TIMESTAMP/
(the experiment defaults to the scene's directory name, or to the method
for generfacto, which trains without --data): config.yml,
written before training, for ns-eval to reload; dataparser_transforms.json;
events.jsonl with the train, eval and eval_all scalars; images/; and
nerfstudio_models/ with the checkpoint. Every nested config field is a flag
(`configs/cli.py`). `--vis viewer` serves the web viewer on
http://localhost:VIEWER_PORT (default 7007; websocket on VIEWER_PORT + 1)
while training, rendering on the card (viewer/server.py), and stops it
when training ends. --help lists the port's methods and the plugin
methods (plugins/registry.py). Not carried: several comma-separated --data
scenes (A7), which raise with their ROADMAP item.
"""

import json
import sys
import time
from pathlib import Path
from typing import List, Optional, Union

import torch

from nerfstudio_thermal_torch.configs.cli import CLIError, apply_cli_overrides, print_config_help
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, method_names, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import save_config
from nerfstudio_thermal_torch.utils.precision import pin_precision

# top-level conveniences, mapped into the config tree
_SHORT_FLAGS = {
    "data": lambda c, v: setattr(c, "data", Path(v)),
    "max_num_iterations": lambda c, v: setattr(c.trainer, "max_num_iterations", int(v)),
    "output_dir": lambda c, v: setattr(c.trainer, "output_dir", Path(v)),
    "experiment_name": lambda c, v: setattr(c.trainer, "experiment_name", v),
    "vis": lambda c, v: setattr(c.trainer, "vis", v),
    "viewer_port": lambda c, v: setattr(c.trainer, "viewer_port", int(v)),
}


def main(argv: Optional[List[str]] = None, *, device: Union[str, torch.device] = "cuda") -> int:
    """`device` is the seam for tests, which pass "cpu"."""
    pin_precision()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: ns-train METHOD [--data PATH] [--<config.path> VALUE ...]\n")
        print("methods:")
        for name, description in sorted(method_names().items()):
            print(f"  {name:24s} {description}")
        return 0

    method = argv[0]
    try:
        config = get_method_config(method)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    rest = argv[1:]
    if "-h" in rest or "--help" in rest or "--help-flags" in rest:
        print(f"usage: ns-train {method} --data PATH [--<config.path> VALUE ...]")
        print(f"\n{config.description}\n\nflags:")
        print_config_help(config)
        print("\n(reference-style --pipeline.model.X aliases also accepted)")
        return 0

    mapped = []
    i = 0
    while i < len(rest):
        tok = rest[i]
        key = tok.lstrip("-").replace("-", "_").split("=")[0]
        if tok.startswith("--") and key in _SHORT_FLAGS:
            if "=" in tok:
                val = tok.split("=", 1)[1]
                i += 1
            elif i + 1 < len(rest):
                val = rest[i + 1]
                i += 2
            else:
                print(f"error: flag {tok} expects a value", file=sys.stderr)
                return 2
            _SHORT_FLAGS[key](config, val)
            continue
        mapped.append(tok)
        i += 1
    try:
        config, positionals = apply_cli_overrides(config, mapped)
    except CLIError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if positionals:
        print(f"error: unexpected arguments {positionals}", file=sys.stderr)
        return 2
    from nerfstudio_thermal_torch.models.generfacto import GenerfactoModelConfig

    if config.data is None and not isinstance(config.model, GenerfactoModelConfig):
        print("error: --data is required", file=sys.stderr)
        return 2
    if config.data is not None and "," in str(config.data):
        raise NotImplementedError("multi-scene training (comma-separated --data) is not ported yet (ROADMAP A7)")

    timestamp = time.strftime("%Y-%m-%d_%H%M%S")
    if config.trainer.experiment_name == "experiment":
        config.trainer.experiment_name = Path(config.data).name if config.data is not None else method
    base_dir = Path(config.trainer.output_dir) / config.trainer.experiment_name / method / timestamp
    base_dir.mkdir(parents=True, exist_ok=True)
    save_config(config, base_dir / "config.yml")
    print(f"config saved to {base_dir / 'config.yml'}")

    trainer = setup_trainer(config, base_dir=base_dir, device=device)
    trainer.setup()
    dpo = trainer.datamanager.train_dataparser_outputs
    (base_dir / "dataparser_transforms.json").write_text(json.dumps(dpo.as_dict(), indent=2))
    try:
        trainer.train()
    finally:
        trainer.stop_viewer()
    trainer.writer.close()
    print(f"training complete; outputs in {base_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
