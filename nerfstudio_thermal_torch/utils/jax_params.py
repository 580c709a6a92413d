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
- `embedding_appearance` in a field;
- `pose_adjustment` of the camera optimizers;
- the top-level groups below.
A key the port does not expect, or one it expects and does not find,
raises: a silent partial load would compare different models.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from nerfstudio_thermal_torch.cameras.camera_optimizers import CameraOptimizer
from nerfstudio_thermal_torch.fields.density_fields import HashMLPDensityField, MLPDensityField
from nerfstudio_thermal_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_thermal_torch.ops.encodings import HashEncoding
from nerfstudio_thermal_torch.ops.mlp import MLP, MLPWithHashEncoding

# JAX param group -> attribute of the model
GROUPS = {
    "fields": "field",
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


def load_module(module: nn.Module, tree: Mapping, where: str) -> None:
    if isinstance(module, NerfactoField):
        has_emb = module.appearance_embedding_dim > 0
        base = _base_name(module)
        _check_keys(tree, [base, "mlp_head"] + ["embedding_appearance"] * has_emb, where)
        if has_emb:
            _copy(module.embedding_appearance, tree["embedding_appearance"], f"{where}/embedding_appearance")
        load_module(module.base_network, tree[base], f"{where}/{base}")
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
    elif isinstance(module, nn.ModuleList):
        _check_keys(tree, [str(i) for i in range(len(module))], where)
        for i, sub in enumerate(module):
            load_module(sub, tree[str(i)], f"{where}/{i}")
    else:
        raise TypeError(f"{where}: no JAX layout known for {type(module).__name__}")


def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> None:
    """Copy the JAX model's param groups into `model` in place."""
    expected = []
    for group, attr in GROUPS.items():
        module = getattr(model, attr, None)
        if module is None or (isinstance(module, CameraOptimizer) and module.mode == "off"):
            continue
        expected.append(group)
    _check_keys(params, expected, "params")
    for group in expected:
        load_module(getattr(model, GROUPS[group]), params[group], group)


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


def export_module(module: nn.Module, grads: bool = False) -> Dict[str, Any]:
    if isinstance(module, NerfactoField):
        tree = {
            _base_name(module): export_module(module.base_network, grads),
            "mlp_head": export_mlp(module.mlp_head, grads, flat=module._fused_field_ok()),
        }
        if module.appearance_embedding_dim > 0:
            tree["embedding_appearance"] = _value(module.embedding_appearance, grads)
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
            tree["Dense_0"] = {
                "kernel": _value(module.linear.weight, grads).T.copy(),
                "bias": _value(module.linear.bias, grads),
            }
        else:
            tree["mlp"] = export_mlp(module.mlp, grads)
        return tree
    if isinstance(module, MLPDensityField):
        return {"mlp": export_mlp(module.mlp, grads, flat=module.fuses_rays())}
    if isinstance(module, CameraOptimizer):
        return {"pose_adjustment": _value(module.pose_adjustment, grads)}
    if isinstance(module, nn.ModuleList):
        return {str(i): export_module(sub, grads) for i, sub in enumerate(module)}
    raise TypeError(f"no JAX layout known for {type(module).__name__}")


def export_jax_tree(model: nn.Module, grads: bool = False) -> Dict[str, Any]:
    """The model's param groups (or, with `grads`, their .grad, zeros where
    a parameter has none) as the JAX package's param tree of numpy arrays."""
    tree = {}
    for group, attr in GROUPS.items():
        module = getattr(model, attr, None)
        if module is None or (isinstance(module, CameraOptimizer) and module.mode == "off"):
            continue
        tree[group] = export_module(module, grads)
    return tree
