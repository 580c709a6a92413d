"""Score-distillation guidance for text-to-3D (generfacto)
(counterpart of nerfstudio_thermal_tpu/generative/guidance.py).

`sds_loss(embeddings, image, ...)` pulls the rendered image toward what a
prompt asks for. Diffusion checkpoints cannot be downloaded here, so, as in
the JAX package:
- `StableDiffusionGuidance` is a shell gated on $NS_SD_WEIGHTS:
  `available()` says whether that directory exists; `embed_prompts`
  raises the JAX package's message without it and `sds_loss` always
  raises its message (the JAX package's SDS needs a diffusers runtime);
  the port imports no diffusers, so with weights `embed_prompts` raises
  `sds_loss`'s message instead of loading a pipeline;
- `ColorMatchGuidance` takes "the prompt is a colour": each view's
  embedding is an RGB target and the loss the mean squared pull toward
  it, which drives the whole path (per-view prompts, gradients through the
  render) without weights.
"""

import os
from pathlib import Path
from typing import Dict, Protocol

import torch


class Guidance(Protocol):
    def available(self) -> bool: ...

    def embed_prompts(self, base: str, top: str, side: str, front: str, back: str): ...

    def sds_loss(self, embeddings, image: torch.Tensor, *, vertical: torch.Tensor, horizontal: torch.Tensor,
                 guidance_scale: float, rng=None) -> torch.Tensor: ...


def select_view_embedding(embeddings: Dict[str, torch.Tensor], vertical, horizontal) -> torch.Tensor:
    """Discrete positional prompting: overhead when vertical > 40 degrees,
    else front / side / back / side by the horizontal angle's quadrant."""
    top, side, front, back = embeddings["top"], embeddings["side"], embeddings["front"], embeddings["back"]
    horizontal = torch.as_tensor(horizontal, dtype=torch.float32, device=top.device)
    vertical = torch.as_tensor(vertical, dtype=torch.float32, device=top.device)
    h = torch.remainder(horizontal, 360.0)
    quad = torch.where(
        (h < 45) | (h >= 315), 0,  # front
        torch.where(h < 135, 1, torch.where(h < 225, 2, 1)),  # side / back / side
    )
    by_quad = torch.stack([front, side, back], dim=0)[quad]
    return torch.where(vertical > 40.0, top, by_quad)


class ColorMatchGuidance:
    """'The prompt is a colour': each view embedding is an RGB target and
    sds_loss = guidance_scale * mean squared difference to it."""

    def __init__(self, base_color=(0.8, 0.3, 0.2)):
        self.base_color = torch.tensor(base_color, dtype=torch.float32)

    def available(self) -> bool:
        return True

    def embed_prompts(self, base, top, side, front, back) -> Dict[str, torch.Tensor]:
        shift = {
            "top": [0.0, 0.1, 0.0],
            "side": [0.0, 0.0, 0.1],
            "front": [0.0, 0.0, 0.0],
            "back": [0.1, 0.0, 0.0],
        }
        return {k: torch.clamp(self.base_color + torch.tensor(v), 0, 1) for k, v in shift.items()}

    def sds_loss(self, embeddings, image, *, vertical, horizontal, guidance_scale=1.0, rng=None) -> torch.Tensor:
        emb = {k: v.to(image.device) for k, v in embeddings.items()}
        target = select_view_embedding(emb, vertical, horizontal)
        return guidance_scale * torch.mean((image - target[None, None]) ** 2)


class StableDiffusionGuidance:
    """Stable Diffusion SDS, gated on local checkpoints ($NS_SD_WEIGHTS)."""

    def __init__(self, sd_version: str = "1-5", guidance_scale: float = 20.0):
        self.sd_version = sd_version
        self.guidance_scale = guidance_scale
        self._path = os.environ.get("NS_SD_WEIGHTS")

    def available(self) -> bool:
        return bool(self._path) and Path(self._path).exists()

    def embed_prompts(self, base, top, side, front, back):
        if not self.available():
            raise RuntimeError(
                "Stable Diffusion weights not found. Set NS_SD_WEIGHTS to a "
                "diffusers-flax pipeline directory (this image has no egress "
                "to download checkpoints)."
            )
        raise NotImplementedError(
            "SDS with flax StableDiffusion requires the diffusers runtime; "
            "gate generfacto on guidance.available() before training."
        )

    def sds_loss(self, embeddings, image, *, vertical, horizontal, guidance_scale=None, rng=None):
        raise NotImplementedError(
            "SDS with flax StableDiffusion requires the diffusers runtime; "
            "gate generfacto on guidance.available() before training."
        )


def build_guidance(name: str, **kwargs) -> Guidance:
    if name == "colormatch":
        return ColorMatchGuidance(**kwargs)
    if name == "stablediffusion":
        return StableDiffusionGuidance(**kwargs)
    raise ValueError(f"unknown guidance '{name}'")
