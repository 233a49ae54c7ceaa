"""Process groups: one rank per process, each on its own device.

Port of ``gpu_bidirectional_raytracer_tpu/parallel/distributed.py`` on
``torch.distributed``. In JAX, `jax.distributed` makes every host's chips
one device list and GSPMD emits the collectives; here every process is one
rank of a process group, holds one device, and `parallel.mesh` writes the
split and the collectives out.

- `initialize_cluster` joins the group: with no arguments from the
  environment that ``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``/
  ``RANK``/``WORLD_SIZE``), or from an explicit ``init_method``, world size
  and rank. The backend is named or follows the device: ``"nccl"`` for
  CUDA, ``"gloo"`` for the CPU. ``"gloo"`` also takes CUDA tensors (its
  ``all_reduce`` and ``broadcast``), which is how several ranks share one
  card, where NCCL refuses two ranks on one GPU. Nothing switches the
  backend or the device on its own: a failed NCCL init raises.
- `rank_device`: the rank's device, ``cuda:<LOCAL_RANK % count>`` unless
  the caller names one.
"""

from __future__ import annotations

import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

from gpu_bidirectional_raytracer_tpu_torch.core.types import resolve_device


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` if given, else ``cuda:<LOCAL_RANK % device count>``;
    raises when the device is a missing card."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")   # raises without a card
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_cluster(init_method: str | None = None,
                       world_size: int | None = None,
                       rank: int | None = None, backend: str | None = None,
                       device: str | torch.device | None = None,
                       timeout: float | None = None) -> None:
    """Join the process group of a sharded run; does nothing if this
    process is already in one.

    ``init_method`` defaults to ``"env://"`` (``torchrun``'s variables);
    ``world_size`` and ``rank`` default to the environment's. ``backend``
    defaults to ``"nccl"`` on a card and ``"gloo"`` on the CPU;
    ``device`` to `rank_device`'s. On a card the device becomes the
    current one, and an NCCL group is formed at once, so a failure
    raises here. ``timeout``: seconds a collective may wait."""
    if dist.is_initialized():
        return
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a card, not {dev}")
    kw: dict[str, Any] = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)


def is_multi_host() -> bool:
    """True when more than one process is in the group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def local_device_count() -> int:
    return torch.cuda.device_count()

