"""PyTorch/CUDA port of nerfstudio_thermal_tpu.

The package mirrors the JAX package's module paths. It imports torch and
never JAX: the JAX package is the reference the tests hold it against.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; every hand-written kernel sits beside a plain PyTorch
version that a wrapper uses only for tensors on the CPU.
"""

from nerfstudio_thermal_torch.utils.precision import pin_precision

pin_precision()
