"""LPIPS perceptual metric, VGG16 backbone (counterpart of
nerfstudio_thermal_tpu/utils/lpips.py).

The same computation as the JAX package's: VGG16 features at
relu1_2/2_2/3_3/4_3/5_3, unit-normalized per channel, squared differences
reduced by linear heads, averaged over space and layers. The convolutions
are `torch.nn.functional.conv2d` ("SAME" 3 x 3 convolutions as padding 1,
the 2 x 2 stride-2 VALID max-pool as `max_pool2d`, which floors odd sizes
alike), run in exact f32: entry points pin the precision, so cuDNN takes
no TF32 path.

Weights, first hit wins:
  1. $NS_LPIPS_WEIGHTS, an npz vendored in the package (data/lpips_vgg16.npz)
     or ~/.nerfstudio/lpips_vgg16.npz, in the JAX package's layout (HWIO
     kernels conv{i}_kernel, biases conv{i}_bias, heads lin{k}_weight),
     transposed here to OIHW;
  2. the seeded untrained VGG16: numpy's default_rng(0) drawn in the JAX
     package's order and He-scaled, with uniform 1/C heads, so its weights
     equal the JAX package's bit for bit. Its metrics are named
     `lpips_untrained_*`.
The JAX package's third tier (converting a torchvision VGG16 checkpoint
with the `lpips` package's heads) is not carried: neither package exists
on the machines the port runs on. NS_LPIPS=0 disables the metric.
"""

import os
import sys
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 conv plan: (out_channels, followed_by_pool)
_VGG16_PLAN = [
    (64, False), (64, True),
    (128, False), (128, True),
    (256, False), (256, False), (256, True),
    (512, False), (512, False), (512, True),
    (512, False), (512, False), (512, True),
]
# indices (into the conv list) whose post-relu activations feed LPIPS
_FEATURE_LAYERS = [1, 3, 6, 9, 12]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
_UNTRAINED = "untrained-seeded(vgg16-he, seed 0, uniform heads)"


def _candidate_paths() -> List[Path]:
    cands = []
    env = os.environ.get("NS_LPIPS_WEIGHTS")
    if env:
        cands.append(Path(env))
    cands.append(Path(__file__).resolve().parent.parent / "data" / "lpips_vgg16.npz")
    cands.append(Path.home() / ".nerfstudio" / "lpips_vgg16.npz")
    return cands


def _weights_path() -> Optional[Path]:
    for p in _candidate_paths():
        if p.exists():
            return p
    return None


def _enabled() -> bool:
    return os.environ.get("NS_LPIPS", "1").lower() not in ("0", "off", "false")


def lpips_available() -> bool:
    """True unless disabled (NS_LPIPS=0): without weights on disk the
    seeded untrained tier still serves the metric."""
    return _enabled()


def lpips_provenance() -> Optional[str]:
    """Where the active weights come from (recorded in the ns-eval JSON)."""
    if not _enabled():
        return None
    path = _weights_path()
    return f"weights:{path}" if path is not None else _UNTRAINED


def lpips_metric_name(suffix: str) -> str:
    """`lpips_<suffix>` with weights from disk, `lpips_untrained_<suffix>`
    with the seeded tier, so an untrained value is never read as the
    trained metric."""
    prov = lpips_provenance()
    if prov is not None and prov.startswith("weights:"):
        return f"lpips_{suffix}"
    return f"lpips_untrained_{suffix}"


def seeded_weights() -> Tuple[List[Tuple[np.ndarray, np.ndarray]], List[np.ndarray]]:
    """The seeded tier in the JAX package's layout: He-initialized HWIO
    kernels with zero biases, drawn in order from default_rng(0), and
    uniform non-negative heads (1/C, so a head is a channel mean)."""
    rng = np.random.default_rng(0)
    convs = []
    in_ch = 3
    for out_ch, _ in _VGG16_PLAN:
        k = rng.normal(size=(3, 3, in_ch, out_ch)).astype(np.float32)
        k *= np.sqrt(2.0 / (3 * 3 * in_ch))
        convs.append((k, np.zeros((out_ch,), np.float32)))
        in_ch = out_ch
    lins = [np.full((_VGG16_PLAN[i][0],), 1.0 / _VGG16_PLAN[i][0], np.float32) for i in _FEATURE_LAYERS]
    return convs, lins


class LPIPS(nn.Module):
    """VGG16 features and linear heads; forward(pred, target) on [N, 3, H, W]
    images already mapped to [-1, 1] gives the distance per image."""

    def __init__(self, convs, lins):
        super().__init__()
        self.convs = nn.ModuleList()
        for k, b in convs:
            conv = nn.Conv2d(k.shape[2], k.shape[3], 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))))
                conv.bias.copy_(torch.from_numpy(np.asarray(b)))
            self.convs.append(conv)
        for i, w in enumerate(lins):
            self.register_buffer(f"lin{i}", torch.from_numpy(np.asarray(w, np.float32)).view(1, -1, 1, 1))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))
        self.requires_grad_(False)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = (x - self.shift) / self.scale
        feats = []
        for i, (conv, (_, pool)) in enumerate(zip(self.convs, _VGG16_PLAN)):
            h = F.relu(conv(h))
            if i in _FEATURE_LAYERS:
                feats.append(h)
            if pool:
                h = F.max_pool2d(h, 2, 2)
        return feats

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for k, (a, b) in enumerate(zip(self.features(pred), self.features(target))):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            d = torch.sum((a - b) ** 2 * getattr(self, f"lin{k}"), dim=1)
            total = total + d.mean(dim=(1, 2))
        return total


def _load_weights(path: Optional[Path]):
    if path is None:
        return seeded_weights()
    data = np.load(path)
    convs = [(data[f"conv{i}_kernel"], data[f"conv{i}_bias"]) for i in range(13)]
    return convs, [data[f"lin{k}_weight"] for k in range(5)]


@lru_cache(maxsize=4)
def _network(path: Optional[Path], device: torch.device) -> LPIPS:
    if path is None:
        print(
            "[lpips] no pretrained weights found; using the deterministic untrained-VGG16 "
            "variant (set NS_LPIPS_WEIGHTS for the trained metric, NS_LPIPS=0 to disable)",
            file=sys.stderr,
        )
    return LPIPS(*_load_weights(path)).to(device)


@torch.no_grad()
def lpips(pred: torch.Tensor, target: torch.Tensor) -> Optional[float]:
    """pred, target: [H, W, 3] in [0, 1] (torchmetrics' normalize=True), on
    any device; None when the metric is disabled."""
    if not lpips_available():
        return None
    net = _network(_weights_path(), pred.device)
    p = pred.float().permute(2, 0, 1)[None] * 2.0 - 1.0
    t = target.float().permute(2, 0, 1)[None] * 2.0 - 1.0
    return float(net(p, t)[0])
