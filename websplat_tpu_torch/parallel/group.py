"""Device groups for multi-device rendering: the counterpart of the JAX
package's 1-D meshes (``websplat_tpu/parallel/multiview.py:view_mesh``,
``sharded.py:splat_mesh``).

One process per device, over ``torch.distributed``: NCCL for CUDA tensors,
gloo for CPU tensors.  The backend follows the device the caller names;
nothing falls back from NCCL to gloo or from the card to the CPU.  A group
is built from an initialised default process group (as ``torchrun
--nproc_per_node=N`` leaves it, or ``init_process_group`` with an explicit
``tcp://`` address, world size and rank), or, in a process with no default
group, from an in-process world of one (``dist.HashStore``, rank 0), which
becomes the default group.  Rank r renders on ``cuda:r`` (``cuda:
$LOCAL_RANK`` under torchrun); asking for the card with fewer visible GPUs
than ranks raises.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class DeviceGroup(NamedTuple):
    """A process group with this process's place in it and its device."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    size: int
    device: torch.device


def device_group(n_devices: Optional[int] = None, device="cuda") -> DeviceGroup:
    """The group of every rank of the default process group (``n_devices``,
    where given, must equal its size), initialising an in-process world of
    one where there is none."""
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"unsupported device {device!r}: 'cuda' (NCCL) or 'cpu' (gloo)")
    backend = BACKENDS[dev.type]
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a group of {n_devices} devices needs an initialised default "
                             "process group (torchrun --nproc_per_node=N, or "
                             "init_process_group with a tcp:// address)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if backend not in dist.get_backend():
        raise ValueError(f"the default process group runs {dist.get_backend()!r}; device "
                         f"{device!r} needs {backend!r}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}, but the default process group has {size} ranks")
    if dev.type == "cuda":
        if torch.cuda.device_count() < size:
            raise RuntimeError(f"{size} ranks need {size} GPUs; {torch.cuda.device_count()} "
                               "visible")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    return DeviceGroup(dist.group.WORLD, rank, size, dev)


def view_group(n_devices: Optional[int] = None, device="cuda") -> DeviceGroup:
    """The group the cameras are split over (JAX: ``view_mesh``)."""
    return device_group(n_devices, device)


def splat_group(n_devices: Optional[int] = None, device="cuda") -> DeviceGroup:
    """The group the Gaussians are split over (JAX: ``splat_mesh``)."""
    return device_group(n_devices, device)
