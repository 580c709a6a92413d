"""Carry a JAX param tree into the port's modules, and back out.

`load_jax_params` takes the tree as nested dicts of numpy arrays, e.g.
`jax.tree.map(np.asarray, params)` of the JAX package's `init_params`, and
copies it into a model of this package in place. `export_jax_tree` is the
inverse: the model's parameters, or their gradients, as that tree of numpy
arrays, so a test can compare every group in the JAX layout. JAX itself is
not needed.

Layouts handled:
- flax kernels [din, dout] become `nn.Linear.weight` [dout, din];
- both MLP layouts: the fused path's flat `Dense_{i}_kernel` /
  `Dense_{i}_bias` and the eager path's `Dense_{i}/{kernel, bias}`. The
  export writes the layout the JAX module of the same configuration
  creates: flat for a stack that passes the fused-MLP gate, for the
  proposal MLPs that run the fused ray march and for the colour head of a
  field that runs the whole-field kernel; nested otherwise;
- `hash_table` [L * T, F] of a hash encoding, as it is (no transpose): the
  base field's `mlp_base/{encoding, mlp}` and the hash proposal fields'
  `encoding` beside `mlp`, or `Dense_0` with `use_linear`;
- `embedding_appearance` in a field, and the hash field's semantic head
  `mlp_semantics` (semantic-nerfw);
- the SDF field (neus, neus-facto): its weight-normalised layers
  `glin{i}` / `clin{i}` with `kernel`, `bias` and `g` as they are (the
  port keeps JAX's [din, dout] layout), `variance`,
  `embedding_appearance` and, with the grid, `grid_encoding/hash_table`;
  the surface models' background NeRFField is the group
  `field_background`;
- the frequency NeRFField (vanilla-nerf, mipnerf): `mlp_base` (flat when
  `use_pallas` fuses it), `density_head`, `mlp_head`; vanilla-nerf's two
  fields are `fields/{coarse, fine}`;
- the TensoRFField: its four grids as they are, `basis/kernel` (no bias)
  and `mlp_head`;
- `pose_adjustment` of the camera optimizers;
- the standalone `Embedding` table (`ops/embeddings.py`): `embedding`;
- the top-level groups below.
A key the port does not expect, or one it expects and does not find,
raises: a silent partial load would compare different models.

Splatfacto's tree is flat: one array per group (`xyz`, `features_dc`,
`features_rest`, `opacities`, `scales`, `quats`), as they are.

`load_jax_extra` / `export_jax_extra` carry the trainer's extra state
(instant-ngp's occupancy grid: its `densities`; splatfacto's `alive`,
`grad_accum`, `grad_count`, `max_radii` and `step`) the same way, from
the JAX TrainState's `extra` (e.g. `jax.tree.map(np.asarray,
state.extra)` as a dict, or the grid itself) and back.
`load_jax_moments` / `export_jax_moments` carry the optimizers' first or
second Adam moments in the param tree's layout. `load_jax_scene_params` /
`export_jax_stacked` carry the JAX multi-scene run's stacked tree (a
leading scene axis on every array) into one model per scene and back
(engine/multi_scene.py).
"""

import dataclasses

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.camera_optimizers import CameraOptimizer
from nerfstudio_thermal_torch.fields.density_fields import HashMLPDensityField, MLPDensityField
from nerfstudio_thermal_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_thermal_torch.fields.sdf_field import SDFField, WNDense
from nerfstudio_thermal_torch.fields.tensorf_field import GRID_KEYS, TensoRFField
from nerfstudio_thermal_torch.fields.vanilla_nerf_field import NeRFField
from nerfstudio_thermal_torch.models.splatfacto import SplatfactoModel
from nerfstudio_thermal_torch.ops.embeddings import Embedding
from nerfstudio_thermal_torch.ops.encodings import HashEncoding
from nerfstudio_thermal_torch.ops.mlp import MLP, MLPWithHashEncoding

# JAX param group -> attribute of the model
GROUPS = {
    "fields": "field",
    "field_background": "field_background",
    "fields_thermal": "field_thermal",
    "proposal_networks": "proposal_networks",
    "proposal_networks_thermal": "proposal_networks_thermal",
    "camera_opt": "camera_optimizer",
    "camera_opt_thermal": "camera_optimizer_thermal",
    "shared_camera_opt": "shared_camera_optimizer",
    "shared_camera_opt_thermal": "shared_camera_optimizer_thermal",
}


def _copy(dst: torch.Tensor, src: Any, name: str) -> None:
    src = torch.tensor(np.asarray(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {tuple(src.shape)} != port shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.device))


def _check_keys(tree: Mapping, expected, where: str) -> None:
    extra = set(tree) - set(expected)
    missing = set(expected) - set(tree)
    if extra or missing:
        raise KeyError(f"{where}: unexpected {sorted(extra)}, missing {sorted(missing)}")


def load_mlp(mlp: MLP, tree: Mapping, where: str = "mlp") -> None:
    n = len(mlp.layers)
    fused = "Dense_0_kernel" in tree
    if fused:
        _check_keys(tree, [f"Dense_{i}_{p}" for i in range(n) for p in ("kernel", "bias")], where)
    else:
        _check_keys(tree, [f"Dense_{i}" for i in range(n)], where)
    for i, layer in enumerate(mlp.layers):
        if fused:
            kernel, bias = tree[f"Dense_{i}_kernel"], tree[f"Dense_{i}_bias"]
        else:
            _check_keys(tree[f"Dense_{i}"], ["kernel", "bias"], f"{where}/Dense_{i}")
            kernel, bias = tree[f"Dense_{i}"]["kernel"], tree[f"Dense_{i}"]["bias"]
        _copy(layer.weight, np.asarray(kernel).T, f"{where}/Dense_{i}/kernel")
        _copy(layer.bias, bias, f"{where}/Dense_{i}/bias")


def _load_dense(layer: nn.Linear, tree: Mapping, where: str) -> None:
    _check_keys(tree, ["kernel", "bias"], where)
    _copy(layer.weight, np.asarray(tree["kernel"]).T, f"{where}/kernel")
    _copy(layer.bias, tree["bias"], f"{where}/bias")


def _base_name(field: NerfactoField) -> str:
    return "mlp_base_net" if field.field_encoding == "freq" else "mlp_base"


def _sdf_keys(field: SDFField):
    return ([f"glin{i}" for i in range(len(field.geo_layers))] + [f"clin{i}" for i in range(len(field.color_layers))]
            + ["variance", "embedding_appearance"] + ["grid_encoding"] * field.use_grid_feature)


def _wn_keys(layer: WNDense):
    return ["kernel", "bias"] + ["g"] * layer.use_weight_norm


def load_module(module: nn.Module, tree: Mapping, where: str) -> None:
    if isinstance(module, NerfactoField):
        has_emb = module.appearance_embedding_dim > 0
        has_sem = module.num_semantic_classes > 0
        base = _base_name(module)
        _check_keys(tree, [base, "mlp_head"] + ["embedding_appearance"] * has_emb + ["mlp_semantics"] * has_sem, where)
        if has_emb:
            _copy(module.embedding_appearance, tree["embedding_appearance"], f"{where}/embedding_appearance")
        load_module(module.base_network, tree[base], f"{where}/{base}")
        load_mlp(module.mlp_head, tree["mlp_head"], f"{where}/mlp_head")
        if has_sem:
            load_mlp(module.mlp_semantics, tree["mlp_semantics"], f"{where}/mlp_semantics")
    elif isinstance(module, SDFField):
        _check_keys(tree, _sdf_keys(module), where)
        for prefix, layers in (("glin", module.geo_layers), ("clin", module.color_layers)):
            for i, layer in enumerate(layers):
                sub = tree[f"{prefix}{i}"]
                _check_keys(sub, _wn_keys(layer), f"{where}/{prefix}{i}")
                for name in _wn_keys(layer):
                    _copy(getattr(layer, name), sub[name], f"{where}/{prefix}{i}/{name}")
        _copy(module.variance, tree["variance"], f"{where}/variance")
        _copy(module.embedding_appearance, tree["embedding_appearance"], f"{where}/embedding_appearance")
        if module.use_grid_feature:
            load_module(module.grid_encoding, tree["grid_encoding"], f"{where}/grid_encoding")
    elif isinstance(module, NeRFField):
        _check_keys(tree, ["mlp_base", "density_head", "mlp_head"], where)
        load_mlp(module.mlp_base, tree["mlp_base"], f"{where}/mlp_base")
        _load_dense(module.density_head, tree["density_head"], f"{where}/density_head")
        load_mlp(module.mlp_head, tree["mlp_head"], f"{where}/mlp_head")
    elif isinstance(module, TensoRFField):
        _check_keys(tree, [*GRID_KEYS, "basis", "mlp_head"], where)
        for name in GRID_KEYS:
            _copy(getattr(module, name), tree[name], f"{where}/{name}")
        _check_keys(tree["basis"], ["kernel"], f"{where}/basis")
        _copy(module.basis.weight, np.asarray(tree["basis"]["kernel"]).T, f"{where}/basis/kernel")
        load_mlp(module.mlp_head, tree["mlp_head"], f"{where}/mlp_head")
    elif isinstance(module, MLP):
        load_mlp(module, tree, where)
    elif isinstance(module, HashEncoding):
        _check_keys(tree, ["hash_table"], where)
        _copy(module.hash_table, tree["hash_table"], f"{where}/hash_table")
    elif isinstance(module, MLPWithHashEncoding):
        _check_keys(tree, ["encoding", "mlp"], where)
        load_module(module.encoding, tree["encoding"], f"{where}/encoding")
        load_mlp(module.mlp, tree["mlp"], f"{where}/mlp")
    elif isinstance(module, HashMLPDensityField):
        head = "Dense_0" if module.use_linear else "mlp"
        _check_keys(tree, ["encoding", head], where)
        load_module(module.encoding, tree["encoding"], f"{where}/encoding")
        if module.use_linear:
            _load_dense(module.linear, tree["Dense_0"], f"{where}/Dense_0")
        else:
            load_mlp(module.mlp, tree["mlp"], f"{where}/mlp")
    elif isinstance(module, MLPDensityField):
        _check_keys(tree, ["mlp"], where)
        load_mlp(module.mlp, tree["mlp"], f"{where}/mlp")
    elif isinstance(module, CameraOptimizer):
        _check_keys(tree, ["pose_adjustment"], where)
        _copy(module.pose_adjustment, tree["pose_adjustment"], f"{where}/pose_adjustment")
    elif isinstance(module, Embedding):
        _check_keys(tree, ["embedding"], where)
        _copy(module.embedding, tree["embedding"], f"{where}/embedding")
    elif isinstance(module, nn.ModuleList):
        _check_keys(tree, [str(i) for i in range(len(module))], where)
        for i, sub in enumerate(module):
            load_module(sub, tree[str(i)], f"{where}/{i}")
    elif isinstance(module, nn.ModuleDict):
        _check_keys(tree, list(module.keys()), where)
        for k, sub in module.items():
            load_module(sub, tree[k], f"{where}/{k}")
    else:
        raise TypeError(f"{where}: no JAX layout known for {type(module).__name__}")


def _flat_groups(model: nn.Module):
    """Splatfacto's flat groups ({name: [parameter]}, one array each in the
    JAX tree), or None for a model of modules."""
    return model.param_groups() if isinstance(model, SplatfactoModel) else None


def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> None:
    """Copy the JAX model's param groups into `model` in place."""
    flat = _flat_groups(model)
    if flat is not None:
        _check_keys(params, list(flat), "params")
        for name, (p,) in flat.items():
            _copy(p, params[name], name)
        return
    expected = []
    for group, attr in GROUPS.items():
        module = getattr(model, attr, None)
        if module is None or (isinstance(module, CameraOptimizer) and module.mode == "off"):
            continue
        expected.append(group)
    _check_keys(params, expected, "params")
    for group in expected:
        load_module(getattr(model, GROUPS[group]), params[group], group)


def split_scene_params(stacked: Any, scene: int) -> Any:
    """Scene `scene`'s params out of a stacked tree (nested mappings of
    arrays with a leading scene axis)."""
    if isinstance(stacked, Mapping):
        return {k: split_scene_params(v, scene) for k, v in stacked.items()}
    return np.asarray(stacked)[scene]


def load_jax_scene_params(models, stacked: Dict[str, Any], scenes=None) -> None:
    """Scene `scenes[i]`'s slice (default: i) of a stacked JAX tree into
    `models[i]`, each in place."""
    for i, model in enumerate(models):
        load_jax_params(model, split_scene_params(stacked, i if scenes is None else scenes[i]))


def _stack(trees) -> Any:
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def export_jax_stacked(models, grads: bool = False) -> Dict[str, Any]:
    """The models' JAX trees stacked on a leading scene axis (the layout of
    the JAX package's multi-scene params)."""
    return _stack([export_jax_tree(m, grads) for m in models])


def _value(p: torch.Tensor, grads: bool) -> np.ndarray:
    t = p.grad if grads else p
    if t is None:
        t = torch.zeros_like(p)
    return t.detach().float().cpu().numpy().copy()


def export_mlp(mlp: MLP, grads: bool = False, flat: bool = False) -> Dict[str, Any]:
    """An MLP's tree: flat `Dense_{i}_kernel` names where it passes the
    fused-MLP gate or `flat` says its JAX module runs it inside a fused
    kernel, nested `Dense_{i}` otherwise."""
    tree: Dict[str, Any] = {}
    for i, layer in enumerate(mlp.layers):
        kernel, bias = _value(layer.weight, grads).T.copy(), _value(layer.bias, grads)
        if flat or mlp._fusable():
            tree[f"Dense_{i}_kernel"], tree[f"Dense_{i}_bias"] = kernel, bias
        else:
            tree[f"Dense_{i}"] = {"kernel": kernel, "bias": bias}
    return tree


def _export_dense(layer: nn.Linear, grads: bool) -> Dict[str, np.ndarray]:
    return {"kernel": _value(layer.weight, grads).T.copy(), "bias": _value(layer.bias, grads)}


def export_module(module: nn.Module, grads: bool = False) -> Dict[str, Any]:
    if isinstance(module, NerfactoField):
        tree = {
            _base_name(module): export_module(module.base_network, grads),
            "mlp_head": export_mlp(module.mlp_head, grads, flat=module._fused_field_ok()),
        }
        if module.appearance_embedding_dim > 0:
            tree["embedding_appearance"] = _value(module.embedding_appearance, grads)
        if module.num_semantic_classes > 0:
            tree["mlp_semantics"] = export_mlp(module.mlp_semantics, grads)
        return tree
    if isinstance(module, SDFField):
        tree = {f"{prefix}{i}": {name: _value(getattr(layer, name), grads) for name in _wn_keys(layer)}
                for prefix, layers in (("glin", module.geo_layers), ("clin", module.color_layers))
                for i, layer in enumerate(layers)}
        tree["variance"] = _value(module.variance, grads)
        tree["embedding_appearance"] = _value(module.embedding_appearance, grads)
        if module.use_grid_feature:
            tree["grid_encoding"] = export_module(module.grid_encoding, grads)
        return tree
    if isinstance(module, NeRFField):
        return {
            "mlp_base": export_mlp(module.mlp_base, grads),
            "density_head": _export_dense(module.density_head, grads),
            "mlp_head": export_mlp(module.mlp_head, grads),
        }
    if isinstance(module, TensoRFField):
        tree = {name: _value(getattr(module, name), grads) for name in GRID_KEYS}
        tree["basis"] = {"kernel": _value(module.basis.weight, grads).T.copy()}
        tree["mlp_head"] = export_mlp(module.mlp_head, grads)
        return tree
    if isinstance(module, MLP):
        return export_mlp(module, grads)
    if isinstance(module, HashEncoding):
        return {"hash_table": _value(module.hash_table, grads)}
    if isinstance(module, MLPWithHashEncoding):
        return {"encoding": export_module(module.encoding, grads), "mlp": export_mlp(module.mlp, grads)}
    if isinstance(module, HashMLPDensityField):
        tree = {"encoding": export_module(module.encoding, grads)}
        if module.use_linear:
            tree["Dense_0"] = _export_dense(module.linear, grads)
        else:
            tree["mlp"] = export_mlp(module.mlp, grads)
        return tree
    if isinstance(module, MLPDensityField):
        return {"mlp": export_mlp(module.mlp, grads, flat=module.fuses_rays())}
    if isinstance(module, CameraOptimizer):
        return {"pose_adjustment": _value(module.pose_adjustment, grads)}
    if isinstance(module, Embedding):
        return {"embedding": _value(module.embedding, grads)}
    if isinstance(module, nn.ModuleList):
        return {str(i): export_module(sub, grads) for i, sub in enumerate(module)}
    if isinstance(module, nn.ModuleDict):
        return {k: export_module(sub, grads) for k, sub in module.items()}
    raise TypeError(f"no JAX layout known for {type(module).__name__}")


def export_jax_tree(model: nn.Module, grads: bool = False) -> Dict[str, Any]:
    """The model's param groups (or, with `grads`, their .grad, zeros where
    a parameter has none) as the JAX package's param tree of numpy arrays."""
    flat = _flat_groups(model)
    if flat is not None:
        return {name: _value(p, grads) for name, (p,) in flat.items()}
    tree = {}
    for group, attr in GROUPS.items():
        module = getattr(model, attr, None)
        if module is None or (isinstance(module, CameraOptimizer) and module.mode == "off"):
            continue
        tree[group] = export_module(module, grads)
    return tree


def load_jax_extra(extra: Any, jax_extra: Any) -> Any:
    """The port's extra state (a dataclass such as OccupancyGridState) with
    the arrays of the JAX one (its dataclass or a dict of its array
    fields) copied in; the static fields must agree."""
    source = jax_extra if isinstance(jax_extra, Mapping) else {
        f.name: getattr(jax_extra, f.name) for f in dataclasses.fields(jax_extra)
    }
    updates = {}
    for f in dataclasses.fields(extra):
        value = getattr(extra, f.name)
        if f.name not in source:
            raise KeyError(f"extra: missing {f.name}")
        if isinstance(value, torch.Tensor):
            new = torch.tensor(np.asarray(source[f.name]), dtype=value.dtype)
            if new.shape != value.shape:
                raise ValueError(f"extra/{f.name}: JAX shape {tuple(new.shape)} != port shape {tuple(value.shape)}")
            updates[f.name] = new.to(value.device)
        elif np.asarray(source[f.name]).tolist() != np.asarray(value).tolist():
            raise ValueError(f"extra/{f.name}: JAX {source[f.name]} != port {value}")
    return dataclasses.replace(extra, **updates)


def export_jax_extra(extra: Any) -> Dict[str, np.ndarray]:
    """The array fields of the port's extra state as numpy arrays."""
    return {
        f.name: getattr(extra, f.name).detach().cpu().numpy().copy()
        for f in dataclasses.fields(extra)
        if isinstance(getattr(extra, f.name), torch.Tensor)
    }


def _groups_params(optimizers):
    return [(p, i, opt) for opt in optimizers.groups.values() for i, p in enumerate(opt.params)]


def export_jax_moments(model: nn.Module, optimizers, which: str) -> Dict[str, Any]:
    """The optimizers' first ("mu") or second ("nu") moments in the JAX
    param tree's layout (through the parameters' .grad slots)."""
    saved = {id(p): p.grad for p in model.parameters()}
    for p, i, opt in _groups_params(optimizers):
        p.grad = getattr(opt, which)[i].clone()
    tree = export_jax_tree(model, grads=True)
    for p in model.parameters():
        p.grad = saved[id(p)]
    return tree


def load_jax_moments(model: nn.Module, optimizers, which: str, tree: Dict[str, Any]) -> None:
    """Copy a JAX moment tree ("mu" or "nu", the param tree's layout) into
    the optimizers' moments (through the parameters, restored after)."""
    saved = [p.detach().clone() for p in model.parameters()]
    load_jax_params(model, tree)
    with torch.no_grad():
        for p, i, opt in _groups_params(optimizers):
            getattr(opt, which)[i].copy_(p)
        for p, v in zip(model.parameters(), saved):
            p.copy_(v)
