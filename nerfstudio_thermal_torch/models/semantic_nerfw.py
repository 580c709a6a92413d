"""Semantic NeRF-W (counterpart of nerfstudio_thermal_tpu/models/semantic_nerfw.py).

nerfacto whose field carries a semantic head (`num_semantic_classes`
from the dataset's metadata["semantics"]["classes"], at least 1): the
per-sample logits are composited with the detached weights into
"semantics" [R, C], whose argmax (of the softmax) picks a colour of the
metadata's colours (or, without them, of default_rng(0)'s uniform ones)
for "semantics_colormap"; the training loss adds the cross-entropy of
the logits against the batch's "semantics" labels, times
`semantic_loss_weight` (a label outside [0, C) adds 0, as JAX's one-hot
does; a data-parallel rank contributes its share of the rays' mean). As
in the JAX package, the transient (NeRF-W) branch is not implemented.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from nerfstudio_thermal_torch.fields.base_field import FieldHeadNames
from nerfstudio_thermal_torch.models.nerfacto import NerfactoModel, NerfactoModelConfig
from nerfstudio_thermal_torch.parallel.mesh import RayShard


@dataclass
class SemanticNerfWModelConfig(NerfactoModelConfig):
    """Field names and defaults as in the JAX package's config."""

    semantic_loss_weight: float = 1.0
    pass_semantic_gradients: bool = False


def semantic_colors(metadata: Dict) -> np.ndarray:
    """The colormap [max(C, 1), 3] f32: the metadata's colours, or
    default_rng(0)'s uniform ones."""
    sem = metadata.get("semantics") or {}
    colors = sem.get("colors")
    if colors is None:
        colors = np.random.default_rng(0).uniform(size=(max(len(sem.get("classes", [])), 1), 3))
    return np.asarray(colors, np.float32)


class SemanticNerfWModel(NerfactoModel):
    config: SemanticNerfWModelConfig

    def populate_modules(self) -> None:
        sem = self.metadata.get("semantics") or {}
        self.semantic_classes = list(sem.get("classes", []))
        self.num_semantic_classes = max(len(self.semantic_classes), 1)
        super().populate_modules()
        self.register_buffer("semantic_colormap", torch.from_numpy(semantic_colors(self.metadata)), persistent=False)

    def _field_kwargs(self) -> Dict:
        return dict(super()._field_kwargs(), num_semantic_classes=self.num_semantic_classes,
                    pass_semantic_gradients=self.config.pass_semantic_gradients)

    def _add_field_outputs(self, outputs: Dict, field_outputs: Dict, weights: torch.Tensor) -> None:
        sem = torch.sum(weights.detach() * field_outputs[FieldHeadNames.SEMANTICS], dim=-2)
        outputs["semantics"] = sem
        labels = torch.argmax(torch.softmax(sem, dim=-1), dim=-1)
        outputs["semantics_colormap"] = self.semantic_colormap[labels]

    def get_loss_dict(self, outputs, batch, metrics_dict, *, train: bool = True,
                      shard: Optional[RayShard] = None, **kwargs) -> Dict[str, torch.Tensor]:
        loss_dict = super().get_loss_dict(outputs, batch, metrics_dict, train=train, shard=shard, **kwargs)
        if train and "semantics" in batch and "semantics" in outputs:
            logits = outputs["semantics"]
            labels = batch["semantics"].long().reshape(-1)
            logp = torch.log_softmax(logits, dim=-1)
            onehot = labels[:, None] == torch.arange(logits.shape[-1], device=labels.device)
            ce = -torch.sum(onehot * logp, dim=-1)
            weight = self._shard(shard, batch).weight
            loss_dict["semantics_loss"] = self.config.semantic_loss_weight * torch.mean(ce) * weight
        return loss_dict
