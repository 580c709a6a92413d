"""Field ops: encodings, MLPs, activations, spatial distortions and the
embedding table (counterpart of nerfstudio_thermal_tpu/ops/__init__.py,
which re-exports `Embedding` the same way)."""

from nerfstudio_thermal_torch.ops.embeddings import Embedding

__all__ = ["Embedding"]
