"""Per-image (appearance) embeddings
(counterpart of nerfstudio_thermal_tpu/ops/embeddings.py).

An index -> learned vector table, as a plain `nn.Embedding` in the
reference. The fields keep their appearance codes as parameters of their
own; this module is the standalone table.
"""

from typing import Optional

import torch
from torch import nn


class Embedding(nn.Module):
    """Index -> learned vector table: one parameter `embedding` [N, F],
    drawn from normal(0, 1) as flax's `normal(stddev=1.0)` initializer
    draws it (from `generator` where one is given)."""

    def __init__(self, num_embeddings: int, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.embedding = nn.Parameter(torch.randn(num_embeddings, features, generator=generator))

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        return self.embedding[indices]

    def mean(self) -> torch.Tensor:
        """Mean embedding (used at eval when use_average_appearance_embedding)."""
        return torch.mean(self.embedding, dim=0)
