"""ns-train: train a registered method
(counterpart of nerfstudio_thermal_tpu/scripts/train.py).

    python -m nerfstudio_thermal_torch.scripts.train thermal-nerfacto --data SCENE[,SCENE2,...] \
        [--max-num-iterations 30000] [--output-dir outputs] [--experiment-name NAME] \
        [--trainer.num-devices D] [--pipeline.model.fused-raymarch True] [--<config.path> VALUE ...]

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
methods (plugins/registry.py).

`--trainer.num-devices D` (default: every visible card, as the JAX
package's `create_mesh(None)`) trains any method on D cards: ns-train
spawns D ranks on this host, joined over NCCL (gloo for the CPU seam) at
a free localhost port, runs the data-parallel trainer in each
(parallel/mesh.py: the ray-batch methods shard their rays, splatfacto
and generfacto replicate their batch) and joins them at the end; the
main rank writes the run, and opens the TensorBoard / W&B / Comet
writers that `--trainer.use-tensorboard` etc. ask for. Several comma-separated --data scenes train as a
multi-scene run (engine/multi_scene.py): K scenes of one config, each
rank stepping its K / D scenes in turn, into
OUTPUT_DIR/multi_{K}scenes/METHOD/TIMESTAMP/scene_{i}_{name}/, each a
standard run directory.
"""

import json
import sys
import time
from pathlib import Path
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from nerfstudio_thermal_torch.configs.cli import CLIError, apply_cli_overrides, print_config_help
from nerfstudio_thermal_torch.configs.method_configs import get_method_config, method_names, setup_trainer
from nerfstudio_thermal_torch.configs.serialization import save_config
from nerfstudio_thermal_torch.parallel.mesh import free_port, initialize_distributed, is_main_process, visible_devices
from nerfstudio_thermal_torch.utils.precision import pin_precision

USAGE = "usage: ns-train METHOD [--data PATH[,PATH...]] [--trainer.num-devices D] [--<config.path> VALUE ...]"

# top-level conveniences, mapped into the config tree
_SHORT_FLAGS = {
    "data": lambda c, v: setattr(c, "data", Path(v)),
    "max_num_iterations": lambda c, v: setattr(c.trainer, "max_num_iterations", int(v)),
    "output_dir": lambda c, v: setattr(c.trainer, "output_dir", Path(v)),
    "experiment_name": lambda c, v: setattr(c.trainer, "experiment_name", v),
    "vis": lambda c, v: setattr(c.trainer, "vis", v),
    "viewer_port": lambda c, v: setattr(c.trainer, "viewer_port", int(v)),
}


def _rank_main(rank: int, world: int, port: int, argv: List[str], device: str, timestamp: str) -> None:
    """One spawned rank: join the group, train, leave it."""
    initialize_distributed(f"tcp://localhost:{port}", world, rank, device=device)
    try:
        if main(argv, device=device, timestamp=timestamp) != 0:
            raise RuntimeError(f"rank {rank}: ns-train failed")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, argv: List[str], device: Union[str, torch.device], timestamp: str) -> int:
    """Run ns-train in `world` spawned ranks on this host and join them."""
    import torch.multiprocessing as mp

    port = free_port()
    print(f"spawning {world} ranks (rendezvous tcp://localhost:{port})")
    mp.start_processes(_rank_main, args=(world, port, argv, str(device), timestamp), nprocs=world,
                       join=True, start_method="spawn")
    return 0


def _ranks(config, num_scenes: int, device: Union[str, torch.device]) -> int:
    """The ranks to run: --trainer.num-devices, or by default every
    visible card; a multi-scene run's trimmed to its K scenes as the JAX
    package trims its scene mesh."""
    requested = config.trainer.num_devices
    ranks = visible_devices(device) if requested is None else requested
    return min(ranks, num_scenes) if num_scenes > 1 else ranks


def main(
    argv: Optional[List[str]] = None, *, device: Union[str, torch.device] = "cuda", timestamp: Optional[str] = None
) -> int:
    """`device` is the seam for tests, which pass "cpu"; `timestamp` names
    the run directory (the spawned ranks share their parent's)."""
    pin_precision()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE + "\n")
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
        print(USAGE.replace("METHOD", method))
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
    timestamp = timestamp or time.strftime("%Y-%m-%d_%H%M%S")
    dirs = [Path(p) for p in str(config.data).split(",") if p] if config.data is not None else []
    ranks = _ranks(config, len(dirs), device)
    if ranks > 1 and not dist.is_initialized():
        return spawn_ranks(ranks, argv, device, timestamp)

    if len(dirs) > 1:
        from nerfstudio_thermal_torch.engine.multi_scene import train_multi_scene

        out = Path(config.trainer.output_dir) / f"multi_{len(dirs)}scenes" / method / timestamp
        out.mkdir(parents=True, exist_ok=True)
        summary = train_multi_scene(
            config, dirs, steps=config.trainer.max_num_iterations,
            seed=config.trainer.seed, out_dir=out, log_every=config.trainer.steps_per_log, device=device,
        )
        if is_main_process():
            print(
                f"multi-scene training complete: {summary.num_scenes} scenes on "
                f"{summary.num_devices} device(s), final losses "
                f"{['%.4f' % x for x in summary.final_losses]}; outputs in {out}"
            )
        return 0

    if config.trainer.experiment_name == "experiment":
        config.trainer.experiment_name = Path(config.data).name if config.data is not None else method
    base_dir = Path(config.trainer.output_dir) / config.trainer.experiment_name / method / timestamp
    base_dir.mkdir(parents=True, exist_ok=True)
    main_rank = is_main_process()
    if main_rank:
        save_config(config, base_dir / "config.yml")
        print(f"config saved to {base_dir / 'config.yml'}")

    trainer = setup_trainer(config, base_dir=base_dir, device=device)
    trainer.setup()
    if main_rank:
        dpo = trainer.datamanager.train_dataparser_outputs
        (base_dir / "dataparser_transforms.json").write_text(json.dumps(dpo.as_dict(), indent=2))
    try:
        trainer.train()
    finally:
        trainer.stop_viewer()
    trainer.writer.close()
    if main_rank:
        print(f"training complete; outputs in {base_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
