"""Data-parallel training over torch.distributed ranks
(counterpart of nerfstudio_thermal_tpu/parallel/mesh.py).

The JAX package runs one process per host and one SPMD program over a 1-D
`data` mesh: the ray batch is sharded, the parameters are replicated and
XLA inserts the gradient psum. Here one process drives one card (a rank):
`initialize_distributed` joins the ranks (NCCL on CUDA, gloo on the CPU,
or the backend the caller names), `create_mesh` says where this rank
stands (world, rank, local rank, host index) and `shard_batch` keeps its
rows of its host's batch. `is_main_process` is rank 0.

The W-rank ray-batch step (engine/trainer.py `make_ray_train_step` given a
`RayShard`; every method but splatfacto and generfacto) computes JAX's
one-device step on the global batch:
- Every rank of host h samples host h's batch (seed `datamanager.seed +
  7919 * h`, JAX's per-process offset; `setup_trainer` applies it) and
  keeps the r-th contiguous 1/D of its rays, D ranks a host. The global
  batch is the hosts' batches in host order.
- Draws: every rank draws the global batch's jitter and random
  backgrounds from the trainer's generator (seeded alike on every rank)
  and keeps its rows (`RayShard.draw`; the samplers do so when they are
  handed the shard), so the generators stay in step and each ray sees the
  draw it would see in a one-rank step. Draws that belong to no ray (the
  occupancy grid's points, the density TV points) are the same on every
  rank.
- Each loss term of a rank is its contribution to the global term; the
  contributions sum to it over the ranks:
  * per-ray means: the local mean times R_local / R_global (`weight`);
  * masked means (`tv_pixel_loss`, `cross_channel_loss`, depth-nerfacto's
    `depth_mae`): the local masked sum over the global mask count, a
    scalar all-reduce before the backward (`global_sum`);
  * thermal-nerfacto's cross-density ray prefix: k from the global ray
    count; a rank evaluates its rows inside [0, k) (`prefix`, possibly
    none) and contributes their share of the L1 mean over k rays;
  * parameter-only terms (the camera penalties, TensoRF's L1, the
    surface models' s_val) and batch-independent draws (the density TV
    points) enter once, on the main rank (`once`);
  * a term that is no sum over rays (the surface models' monocular depth
    loss: one scale and shift fitted over the global batch) is computed
    on the whole global batch on every rank from the other ranks'
    detached rows and this rank's own (`gather`); it enters with its
    value once and its gradient to this rank's rows whole (`whole`).
  A single process's step is the same code over the trivial shard
  (`RayShard.full`: every row, weight 1, no reduction), bitwise the
  plain step.
  The gradient of the summed contributions is then the sum of the ranks'
  gradients: `all_reduce_grads` sums every trained parameter's gradient
  (zeros where a rank got none, which the optimizers treat alike) in
  buckets (BUCKET_BYTES) before the optimizers step.
- Logged scalars are the global values (`reduce_scalars` sums the
  contributions; the PSNRs come from summed squared errors and counts,
  `RayShard.psnr`). Checkpoints, config.yml, events, the writers and the
  viewer are the main rank's.

The whole-image step (splatfacto) and the generative step (generfacto)
replicate their batch, as JAX does: every rank runs the whole step on
the same batch with the same generator, then takes rank 0's gradients
(`broadcast_grads`) and splatfacto's refinement statistics before the
update, so every rank applies bitwise the same update even where the
card's atomics sum in another order on each rank.
"""

import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

from nerfstudio_thermal_torch.utils.math import psnr

BUCKET_BYTES = 32 * 2**20


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> None:
    """Join `num_processes` ranks at `coordinator_address`
    (tcp://host:port) as rank `process_id`. A no-op without
    `num_processes`. A one-rank group may give port 0: its store then
    listens on whatever port is free when it starts, with no race. The backend is NCCL on CUDA and gloo on the CPU
    unless `backend` names one (two ranks sharing one card need gloo). A
    CUDA rank takes the card of its rank on this host."""
    if num_processes is None:
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=coordinator_address, world_size=num_processes, rank=process_id,
    )


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def visible_devices(device: Union[str, torch.device] = "cuda") -> int:
    """The cards a data-parallel `num_devices=None` run spans: every
    visible one (JAX's `create_mesh(None)`); one on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


@dataclass(frozen=True)
class Mesh:
    """This rank's place: `world` ranks, `local_world` of them a host."""

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    local_world: int = 1
    distributed: bool = False
    """True when the ranks form a process group (even of one rank): the
    step then reduces its gradients and scalars over it."""

    @property
    def host_index(self) -> int:
        return self.rank // self.local_world

    @property
    def num_hosts(self) -> int:
        return self.world // self.local_world

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def ray_shard(self, host_rays: int, patch_size: int = 1) -> Optional["RayShard"]:
        """This rank's rows of the global batch of `num_hosts` host batches
        of `host_rays` rays; None for a single process."""
        if not self.distributed:
            return None
        rows = _shard_rows(host_rays, self.local_world, patch_size)
        start = self.host_index * host_rays + self.local_rank * rows
        return RayShard(start, start + rows, host_rays * self.num_hosts, self.is_main)


SINGLE = Mesh()


def create_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The mesh of the running process group, or of this process alone.
    Inside a group `num_devices` must be None or the group's size (the
    ranks a host: LOCAL_WORLD_SIZE where a launcher such as torchrun sets
    it, else every rank). Outside one, a single process drives one card:
    None gives that, and more than one raises, since each card takes a
    process of its own (ns-train spawns them for --trainer.num-devices, or
    call initialize_distributed in each)."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_devices not in (None, world):
            raise ValueError(f"num_devices={num_devices} in a process group of {world} ranks")
        rank = dist.get_rank()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if world % local_world:
            raise ValueError(f"{world} ranks do not divide into hosts of {local_world}")
        return Mesh(world, rank, int(os.environ.get("LOCAL_RANK", rank % local_world)), local_world, True)
    if num_devices is not None and num_devices > 1:
        raise ValueError(
            f"num_devices={num_devices}: each device needs a process of its own "
            "(ns-train --trainer.num-devices spawns them; or call initialize_distributed in each)"
        )
    return SINGLE


def _shard_rows(num_rays: int, ranks: int, patch_size: int) -> int:
    if num_rays % ranks:
        raise ValueError(f"a batch of {num_rays} rays does not divide over {ranks} ranks")
    rows = num_rays // ranks
    if patch_size > 1 and rows % patch_size**2:
        raise ValueError(
            f"a shard of {rows} rays would split a {patch_size}x{patch_size} patch: "
            f"train_num_rays_per_batch must be a multiple of {ranks * patch_size**2}"
        )
    return rows


def shard_batch(batch: Dict[str, Any], mesh: Mesh, patch_size: int = 1) -> Dict[str, Any]:
    """This rank's contiguous 1/D of its host's batch (every entry's
    leading dimension), D ranks a host; the batch itself for a single
    process."""
    if not mesh.distributed:
        return batch
    n = len(next(iter(batch.values())))
    rows = _shard_rows(n, mesh.local_world, patch_size)
    lo = mesh.local_rank * rows
    return {k: v[lo:lo + rows] for k, v in batch.items()}


@dataclass(frozen=True)
class RayShard:
    """Rows [start, stop) of a global batch of `num_rays` rays."""

    start: int
    stop: int
    num_rays: int
    main: bool
    distributed: bool = True
    """False for `full`: the contributions are the values themselves."""

    @staticmethod
    def full(num_rays: int) -> "RayShard":
        """A single process's shard: every row, nothing to reduce."""
        return RayShard(0, num_rays, num_rays, True, False)

    @property
    def rows(self) -> int:
        return self.stop - self.start

    @property
    def weight(self) -> float:
        """A per-ray mean's share of the global mean."""
        return self.rows / self.num_rays

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global-batch tensor."""
        return t[self.start:self.stop]

    def draw(self, generator: torch.Generator, columns: int, device) -> torch.Tensor:
        """This rank's rows of a U[0, 1) [num_rays, columns] draw of the
        global batch from `generator`."""
        return self.local(torch.rand((self.num_rays, columns), generator=generator, device=device, dtype=torch.float32))

    def prefix(self, k: int) -> int:
        """How many of this rank's rows lie in the global prefix [0, k)."""
        return min(max(k - self.start, 0), self.rows)

    def global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a (detached) tensor."""
        t = t.detach()
        if self.distributed:
            t = t.clone()
            dist.all_reduce(t)
        return t

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """A term that enters the global loss once: the main rank's."""
        return t if self.main else t * 0.0

    def psnr(self, pred: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The (masked) PSNR of the global batch (utils/math.py `psnr`) on
        the main rank, 0 on the others, from squared errors and counts
        summed over the ranks."""
        if not self.distributed:
            return psnr(pred, target, mask).detach()
        se = (pred - target) ** 2
        mask = torch.ones_like(se) if mask is None else torch.broadcast_to(mask, se.shape)
        sums = self.global_sum(torch.stack([torch.sum(se * mask), torch.sum(mask)]))
        mse = sums[0] / torch.clamp(sums[1], min=1.0)
        return self.once(-10.0 * torch.log10(torch.clamp(mse, min=1e-12)))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor of this rank's rows -> the global batch's: the other
        ranks' rows detached, this rank's with their graph."""
        if not self.distributed:
            return t
        parts = [torch.empty_like(t) for _ in range(self.num_rays // self.rows)]
        dist.all_gather(parts, t.detach().contiguous())
        parts[self.start // self.rows] = t
        return torch.cat(parts)

    def whole(self, loss: torch.Tensor) -> torch.Tensor:
        """A term every rank computes on the whole global batch (`gather`):
        its value enters the global loss once, its gradient to this
        rank's rows whole."""
        if not self.distributed:
            return loss
        return loss - loss.detach() + self.once(loss.detach())


def _buckets(tensors: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    by_kind: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
        by_kind.setdefault((t.device, t.dtype), []).append(t)
    for group in by_kind.values():
        bucket, size = [], 0
        for t in group:
            bucket.append(t)
            size += t.numel() * t.element_size()
            if size >= BUCKET_BYTES:
                yield bucket
                bucket, size = [], 0
        if bucket:
            yield bucket


def all_reduce_grads(params: List[torch.Tensor]) -> int:
    """Sum every parameter's gradient over the ranks, zeros where a rank
    has none, in buckets of about BUCKET_BYTES; returns the bytes reduced."""
    return _collective_grads(params, dist.all_reduce)


def broadcast_grads(params: List[torch.Tensor]) -> int:
    """Rank 0's gradient of every parameter on every rank (zeros where it
    has none), in buckets as `all_reduce_grads`; returns the bytes sent."""
    return _collective_grads(params, lambda flat: dist.broadcast(flat, src=0))


def broadcast_tensors(tensors: Iterable[torch.Tensor]) -> None:
    """Rank 0's values of these tensors on every rank, in place."""
    for t in tensors:
        dist.broadcast(t, src=0)


def _collective_grads(params: List[torch.Tensor], collective) -> int:
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    total = 0
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        collective(flat)
        total += flat.numel() * flat.element_size()
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return total


def grad_bytes(params: List[torch.Tensor]) -> int:
    """The bytes `all_reduce_grads` reduces for these parameters."""
    return sum(p.numel() * p.element_size() for p in params)


def reduce_scalars(scalars: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global values of a step's scalars: each rank's contributions
    summed over the ranks, in one all-reduce."""
    keys = sorted(scalars)
    flat = torch.stack([torch.as_tensor(scalars[k]).detach().to(torch.float32).reshape(()) for k in keys])
    dist.all_reduce(flat)
    return {k: flat[i] for i, k in enumerate(keys)}


def broadcast_params(params: Iterable[torch.Tensor]) -> None:
    """Rank 0's parameter values on every rank (the replicas start equal)."""
    broadcast_tensors(p.data for p in params)


def free_port() -> int:
    """A TCP port free now on every local address, for a rendezvous
    address: rank 0's store listens on all of them, so a port that is free
    on localhost alone can still be taken. A one-rank group needs none of
    this: its address may give port 0."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return int(s.getsockname()[1])


def host_seed(seed: int, mesh: Mesh) -> int:
    """The data manager seed of this rank's host (JAX: seed + 7919 *
    process_index, one process a host)."""
    return seed + 7919 * mesh.host_index
