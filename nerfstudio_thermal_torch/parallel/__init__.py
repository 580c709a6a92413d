"""Data-parallel training over torch.distributed ranks (parallel/mesh.py)."""
