"""Device mesh and multi-process runtime (port of xrsfm_tpu/parallel/mesh.py).

The JAX package drives N devices from one controller (a
jax.sharding.Mesh over jax.devices()) and several hosts through
jax.distributed.  The port's counterpart:

  * `Mesh`: the ordered devices one process drives, the axis names and the
    global shape.  Shard i of this process keeps its arrays on devices[i].
    A device may repeat: repeated entries are virtual shards on one device,
    the twin of the JAX tests' --xla_force_host_platform_device_count=8
    (torch has one CPU device, and one card is one CUDA device).  Such a
    mesh is built from an explicit device list; `make_mesh` never repeats
    a CUDA device.
  * several processes: `initialize_distributed` (torch.distributed, NCCL
    for CUDA devices, Gloo for the CPU) and `make_pod_mesh`, whose slow
    "dcn" axis is the processes and whose fast "ici" axis is each
    process's devices.  Global shard g lies on process g // n_local, local
    shard g % n_local.

`make_mesh` on CUDA takes the first n GPUs and raises when fewer exist.
The JAX package's entry points print a line and run on one device
instead (xrsfm_tpu/pipelines/run_matching.py:137-146,
mapper/incremental.py:176-193); the port does not fall back.
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence, Tuple

import torch

from ..device import resolve_device


class Mesh:
    """Devices of this process, axis names and the global shape.

    devices: the shards this process drives, in global shard order; the
    first is the home device, where reduced (replicated) values live.
    shape: one size per axis (default: one axis over the devices); the
    product is the global shard count, len(devices) * process_count.
    group: the torch.distributed group whose processes hold the other
    shards, or None for a mesh of one process."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = ("obs",),
                 shape: Optional[Sequence[int]] = None, process_index: int = 0,
                 process_count: int = 1, group=None):
        self.devices = tuple(resolve_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = tuple(shape) if shape is not None else (len(self.devices),)
        if not self.devices or len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh of {len(self.devices)} devices: axes "
                             f"{self.axis_names} and shape {sizes} disagree")
        if math.prod(sizes) != len(self.devices) * process_count:
            raise ValueError(f"shape {sizes} does not hold {process_count} "
                             f"process(es) x {len(self.devices)} devices")
        self.shape = dict(zip(self.axis_names, sizes))
        self.process_index = process_index
        self.process_count = process_count
        self.group = group

    @property
    def size(self) -> int:
        """Global number of shards."""
        return len(self.devices) * self.process_count

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def shard_index(self, i: int) -> int:
        """Global index of this process's shard i."""
        return self.process_index * len(self.devices) + i

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, shape={self.shape}, "
                f"process {self.process_index}/{self.process_count})")


def make_mesh(n_devices: int, device="cuda", axis: str = "obs") -> Mesh:
    """1-D mesh of n_devices shards.  On CUDA the first n GPUs (from the
    index `device` names, if any); raises RuntimeError when fewer exist.
    On the CPU n virtual shards of the one CPU device."""
    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if dev.type == "cpu":
        return Mesh([dev] * n_devices, (axis,))
    start = dev.index or 0
    have = torch.cuda.device_count()
    if start + n_devices > have:
        raise RuntimeError(
            f"n_devices={n_devices} from cuda:{start} requested but only "
            f"{have} CUDA device(s) exist; a mesh does not fall back to "
            f"fewer devices")
    return Mesh([torch.device("cuda", start + i) for i in range(n_devices)],
                (axis,))


def initialize_distributed(init_method: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cpu", timeout_s: float = 120.0):
    """Join the default torch.distributed process group: NCCL when
    `device` is CUDA (this process's card, made current), Gloo for the CPU.
    A no-op for one process without an init_method (as the JAX package's
    is without num_processes > 1); nothing on a machine announces a
    cluster, so init_method ("tcp://host:port", "file:///path"), the
    process count and this process's rank are given.  A collective that
    waits longer than timeout_s raises.  Returns (process count, rank)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if init_method is None and (num_processes or 1) <= 1:
            return 1, 0
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method, world_size=num_processes or 1,
            rank=process_id or 0,
            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size(), dist.get_rank()


def make_pod_mesh(devices: Sequence, ici_axis: str = "ici",
                  dcn_axis: str = "dcn") -> Mesh:
    """2-D (processes x devices of each process) mesh: `devices` are this
    process's, the process count and rank come from the default
    torch.distributed group (one process when there is none).  BA sums
    over both axes with one gather of every process's partials."""
    import torch.distributed as dist

    if dist.is_initialized():
        n, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        n, rank, group = 1, 0, None
    return Mesh(devices, (dcn_axis, ici_axis), shape=(n, len(devices)),
                process_index=rank, process_count=n, group=group)
