"""Carry a JAX param tree into the port's modules.

Takes the tree as nested dicts of numpy arrays, e.g.
`jax.tree.map(np.asarray, params)` of the JAX package's `init_params`, and
copies it into a model of this package in place. JAX itself is not needed.

Layouts handled:
- flax kernels [din, dout] become `nn.Linear.weight` [dout, din];
- both MLP layouts: the fused path's flat `Dense_{i}_kernel` /
  `Dense_{i}_bias` and the eager path's `Dense_{i}/{kernel, bias}`;
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
from nerfstudio_thermal_torch.fields.density_fields import MLPDensityField
from nerfstudio_thermal_torch.fields.nerfacto_field import NerfactoField
from nerfstudio_thermal_torch.ops.mlp import MLP

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


def load_module(module: nn.Module, tree: Mapping, where: str) -> None:
    if isinstance(module, NerfactoField):
        has_emb = module.appearance_embedding_dim > 0
        _check_keys(tree, ["mlp_base_net", "mlp_head"] + ["embedding_appearance"] * has_emb, where)
        if has_emb:
            _copy(module.embedding_appearance, tree["embedding_appearance"], f"{where}/embedding_appearance")
        load_mlp(module.mlp_base_net, tree["mlp_base_net"], f"{where}/mlp_base_net")
        load_mlp(module.mlp_head, tree["mlp_head"], f"{where}/mlp_head")
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
