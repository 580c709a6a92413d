"""Every config dataclass the port shares with the JAX package has the same
fields, with the same defaults, so that a JAX config (a config.yml, a CLI
flag) names nothing the port lacks and means the same there.

A pair is a `*Config` dataclass of a port module and the class of the same
name in the JAX package's module of the same path. Defaults compare by
value; a nested config compares by class name and, recursively, its own
fields.
"""

import dataclasses
import importlib
import pkgutil

import pytest

import nerfstudio_thermal_torch


def _config_pairs():
    pairs = []
    for info in pkgutil.walk_packages(nerfstudio_thermal_torch.__path__, "nerfstudio_thermal_torch."):
        module = importlib.import_module(info.name)
        try:
            jax_module = importlib.import_module(info.name.replace("nerfstudio_thermal_torch", "nerfstudio_thermal_tpu", 1))
        except ImportError:
            continue
        for name, cls in vars(module).items():
            if (name.endswith("Config") and dataclasses.is_dataclass(cls) and cls.__module__ == module.__name__
                    and dataclasses.is_dataclass(getattr(jax_module, name, None))):
                pairs.append((info.name, name))
    return sorted(pairs)


PAIRS = _config_pairs()


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return dataclasses.MISSING


def _differences(port, jax, where):
    """Where two defaults differ, as readable strings (empty: the same)."""
    if dataclasses.is_dataclass(port) or dataclasses.is_dataclass(jax):
        if type(port).__name__ != type(jax).__name__:
            return [f"{where}: {type(port).__name__} (port) vs {type(jax).__name__} (JAX)"]
        return _field_differences(type(port), type(jax), where, port, jax)
    if isinstance(port, dict) and isinstance(jax, dict):
        if set(port) != set(jax):
            return [f"{where}: keys {sorted(port)} vs {sorted(jax)}"]
        return [d for k in port for d in _differences(port[k], jax[k], f"{where}[{k!r}]")]
    if isinstance(port, (list, tuple)) and isinstance(jax, (list, tuple)):
        if len(port) != len(jax):
            return [f"{where}: {port!r} vs {jax!r}"]
        return [d for i, (a, b) in enumerate(zip(port, jax)) for d in _differences(a, b, f"{where}[{i}]")]
    return [] if port == jax else [f"{where}: {port!r} (port) vs {jax!r} (JAX)"]


def _field_differences(port_cls, jax_cls, where, port=None, jax=None):
    pf = {f.name: f for f in dataclasses.fields(port_cls)}
    jf = {f.name: f for f in dataclasses.fields(jax_cls)}
    out = [f"{where}.{n}: only in JAX" for n in sorted(set(jf) - set(pf))]
    out += [f"{where}.{n}: only in the port" for n in sorted(set(pf) - set(jf))]
    for n in sorted(set(pf) & set(jf)):
        a = getattr(port, n) if port is not None else _default(pf[n])
        b = getattr(jax, n) if jax is not None else _default(jf[n])
        out += _differences(a, b, f"{where}.{n}")
    return out


def test_every_shared_config_is_found():
    names = {name for _, name in PAIRS}
    assert {"MethodConfig", "TrainerConfig", "VanillaDataManagerConfig", "ModelConfig", "NerfactoModelConfig",
            "ThermalNerfactoModelConfig", "CameraOptimizerConfig", "AdamOptimizerConfig"} <= names


@pytest.mark.parametrize("module,name", PAIRS)
def test_config_fields_and_defaults_match_jax(module, name):
    port_cls = getattr(importlib.import_module(module), name)
    jax_cls = getattr(importlib.import_module(module.replace("nerfstudio_thermal_torch", "nerfstudio_thermal_tpu", 1)), name)
    assert _field_differences(port_cls, jax_cls, name) == []


def test_setup_trainer_trains_the_default_model(tmp_path):
    """A MethodConfig left at its default model (NerfactoModelConfig, as in
    the JAX package) and its default Nerfstudio dataparser: setup_trainer
    builds a NerfactoModel, and one CPU training step gives finite losses
    and moves every param group."""
    import torch

    from nerfstudio_thermal_torch.configs.method_configs import MethodConfig, _camera_opt, _field_opt, setup_trainer
    from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel
    from tests.fixtures import make_synthetic_rgbt_dataset
    from tests.test_torch_hash_slice import tiny_hash

    scene = make_synthetic_rgbt_dataset(tmp_path / "scene")
    method = MethodConfig(
        method_name="nerfacto",
        optimizers={"proposal_networks": _field_opt(), "fields": _field_opt(), "camera_opt": _camera_opt()},
        data=scene,
    )
    tiny_hash(method.model, "float32")
    method.datamanager.train_num_rays_per_batch = 64
    trainer = setup_trainer(method, base_dir=tmp_path / "run", device="cpu")
    trainer.setup()
    assert type(trainer.model) is NerfactoModel
    groups = trainer.model.param_groups()
    before = {name: [p.detach().clone() for p in ps] for name, ps in groups.items()}
    out = trainer.train_iteration(0)
    losses = {k: float(v) for k, v in out.items() if "loss" in k}
    assert losses and all(torch.isfinite(torch.tensor(v)) for v in losses.values()), losses
    unchanged = [name for name, ps in groups.items() if all(torch.equal(a, p) for a, p in zip(before[name], ps))]
    assert not unchanged, unchanged
