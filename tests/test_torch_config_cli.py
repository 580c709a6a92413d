"""The port's config.yml round trip and CLI against the JAX package's, on
the CPU. Everything here is exact: config trees compare equal.

- `save_config` writes YAML that PyYAML (present here, maybe not on the
  card's machine) reads back to the port's `to_dict` tree, and
  `load_config` gives back a config equal to the one saved, tuples and
  Paths included.
- The port's `to_dict` tree of a registered method, before and after
  overrides, equals the JAX package's of the same method and overrides
  once `nerfstudio_thermal_tpu` reads `nerfstudio_thermal_torch` in the
  class tags. No key differs.
- The same override lists give equal trees in both CLIs, and bad flags
  raise CLIError in both.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from nerfstudio_thermal_tpu.configs import cli as jax_cli
from nerfstudio_thermal_tpu.configs.method_configs import get_method_config as jax_method_config
from nerfstudio_thermal_tpu.configs.serialization import to_dict as jax_to_dict

from nerfstudio_thermal_torch.configs import cli
from nerfstudio_thermal_torch.configs.method_configs import (
    descriptions,
    get_method_config,
    resolve_model_class,
)
from nerfstudio_thermal_torch.configs.serialization import dump_yaml, load_config, load_yaml, save_config, to_dict
from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from nerfstudio_thermal_torch.models.thermal_nerfacto import ThermalNerfactoModel

FUSED = ["--model.fused-raymarch", "True", "--model.fused-field", "True", "--model.fused-raymarch-proposals", "True"]
CONFIGS = [
    ("thermal-nerfacto", []),
    ("thermal-nerfacto-tpu", []),
    ("thermal-nerfacto-tpu", FUSED),
]
OVERRIDES = [
    ["--pipeline.model.density-mode", "separate", "--model.near-plane=0.1"],
    ["--trainer.steps-per-eval-batch", "20", "--steps-per-eval-image", "20", "--steps-per-eval-all-images", "40"],
    ["--model.num-proposal-samples-per-ray", "(64, 32)"],
    ["--model.num-proposal-samples-per-ray", "[64,32]"],
    ["--model.num-proposal-samples-per-ray", "64,32"],
    ["--model.num-proposal-samples-per-ray", "64 32"],
    ["--trainer.load-step", "None", "--trainer.num-devices", "null", "--trainer.load-dir", "runs/a"],
    ["--model.use-pallas", "false", "--model.proposal-camera-gradients", "yes", "--model.fused-field", "1"],
    ["--pipeline.datamanager.dataparser.eval-mode", "all", "--pipeline.datamanager.patch-size", "1",
     "--datamanager.train-num-rays-per-batch", "256", "--pipeline.datamanager.dataparser.train-split-fraction",
     "0.5"],
    ["--optimizers.fields.optimizer.lr", "1e-3", "--optimizers.camera-opt.scheduler.max-steps", "100"],
    ["--model.camera-optimizer.mode", "off", "--data", "scene/dir"],
]
BAD = [
    ["--model.no-such-field", "1"],
    ["--no.such.path", "1"],
    ["--model.use-pallas", "maybe"],
    ["--model.compute-dtype"],
]


def _port_tags(tree):
    if isinstance(tree, dict):
        return {k: _port_tags(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_tags(v) for v in tree]
    if isinstance(tree, str):
        return tree.replace("nerfstudio_thermal_tpu", "nerfstudio_thermal_torch")
    return tree


def _both(name, flags):
    config, rest = cli.apply_cli_overrides(get_method_config(name), list(flags))
    jax_config, jax_rest = jax_cli.apply_cli_overrides(jax_method_config(name), list(flags))
    assert rest == jax_rest == []
    return config, jax_config


@pytest.mark.parametrize("name,flags", CONFIGS)
def test_config_yml_round_trip(tmp_path, name, flags):
    config, _ = _both(name, flags)
    path = tmp_path / "run" / "config.yml"
    save_config(config, path)
    text = path.read_text()
    assert yaml.safe_load(text) == to_dict(config) == load_yaml(text)
    loaded = load_config(path)
    assert loaded == config
    assert isinstance(loaded.model.num_proposal_samples_per_ray, tuple)
    assert loaded.trainer.output_dir == config.trainer.output_dir
    assert all(getattr(loaded.model, k) == (flags == FUSED)
               for k in ("fused_raymarch", "fused_field", "fused_raymarch_proposals"))


@pytest.mark.parametrize("name,flags", CONFIGS)
def test_config_tree_matches_jax(name, flags):
    config, jax_config = _both(name, flags)
    assert to_dict(config) == _port_tags(jax_to_dict(jax_config))


def test_yaml_subset_round_trips_awkward_scalars():
    tree = {
        "floats": [1e-15, 1e20, -3.0, 0.1, float("inf"), float("-inf")],
        "strings": ["yes", "No", "on", "null", "~", "", " lead", "a: b", "#c", "1.5", "12", "-x", "{timestamp}",
                    "line\nbreak", 'quote"s', "été", "thermal-nerfacto", "/abs/path", "[x]", "e"],
        "nested": [[1, [2, {}]], {"k": None, "t": True, "f": False}, []],
        "empty": {},
        "q:key": {"ü": 0},
    }
    text = dump_yaml(tree)
    assert yaml.safe_load(text) == tree == load_yaml(text)
    assert load_yaml(dump_yaml({})) == {} and load_yaml(dump_yaml([])) == []


@pytest.mark.parametrize("flags", OVERRIDES)
def test_cli_overrides_match_jax(flags):
    config, jax_config = _both("thermal-nerfacto-tpu", flags)
    assert to_dict(config) == _port_tags(jax_to_dict(jax_config))
    assert to_dict(config) != to_dict(get_method_config("thermal-nerfacto-tpu"))


@pytest.mark.parametrize("flags", BAD)
def test_bad_flags_raise_in_both(flags):
    with pytest.raises(cli.CLIError):
        cli.apply_cli_overrides(get_method_config("thermal-nerfacto"), list(flags))
    with pytest.raises(jax_cli.CLIError):
        jax_cli.apply_cli_overrides(jax_method_config("thermal-nerfacto"), list(flags))


def test_config_help_lists_the_same_flags(capsys):
    cli.print_config_help(get_method_config("thermal-nerfacto-tpu"))
    port = capsys.readouterr().out
    jax_cli.print_config_help(jax_method_config("thermal-nerfacto-tpu"))
    assert port == capsys.readouterr().out
    assert "--model.fused-raymarch bool (default: False)" in port


def test_registry_descriptions_and_model_classes():
    for name in ("thermal-nerfacto", "thermal-nerfacto-tpu"):
        assert descriptions[name] == jax_method_config(name).description
        assert resolve_model_class(get_method_config(name).model) is ThermalNerfactoModel
    assert resolve_model_class(NerfactoModelConfig()) is NerfactoModel
    with pytest.raises(KeyError, match="A9"):
        get_method_config("nerfacto-plugin")


def test_port_never_imports_yaml():
    """The card's machine may lack PyYAML: importing the scripts,
    serialization and the pipeline imports no yaml (nor JAX, matplotlib,
    Pillow or the JAX package)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import nerfstudio_thermal_torch.scripts.train, nerfstudio_thermal_torch.scripts.eval\n"
        "import nerfstudio_thermal_torch.utils.eval_utils, nerfstudio_thermal_torch.configs.serialization\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in ('yaml', 'jax', 'matplotlib',"
        " 'PIL', 'nerfstudio_thermal_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1])
