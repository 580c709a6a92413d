"""Float32 matmul precision policy and device selection for entry points.

Counterpart of nerfstudio_thermal_tpu/utils/precision.py. There the TPU's
DEFAULT matmul precision rounds f32 operands to bf16; on Hopper the same
silent rounding is TF32. Every path that wants bf16 compute casts to it
explicitly, so any f32 matmul that remains (prefix sums, pose rotations,
the plain versions of the kernels) must stay exact f32. Entry points call
`pin_precision` (the package also calls it at import).
"""

from typing import Union

import torch


def pin_precision() -> None:
    """Exact f32 matmuls and convolutions: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """Entry-point device: raise when CUDA is asked for and absent.

    There is no silent fallback to the CPU: a caller that wants the CPU
    passes device="cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
