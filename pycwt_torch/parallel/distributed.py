"""Multi-process initialization and host-0 cache semantics.

Counterpart of ``pycwt_tpu/parallel/distributed.py``.  The port runs one
``torch.distributed`` rank per device: :func:`initialize` starts the
process group (NCCL on the card, gloo on the CPU, or gloo on the card when
several ranks share one), :func:`is_coordinator` names the rank that owns
host-side I/O, and :func:`host_broadcast_array` shares a small host array
from it (the Monte-Carlo significance cache and checkpoint).
"""
from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_coordinator", "host_broadcast_array"]

#: A rank that does not come up fails the run after this long.
TIMEOUT = datetime.timedelta(seconds=120)

#: The device of the group this process initialized: the process group is
#: process-wide, and so is the device its tensors live on.
_GROUP_DEVICE: list[torch.device] = []


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None, backend: str | None = None):
    """Start this process's rank of the process group.

    ``coordinator_address`` is ``"host:port"`` (``tcp://host:port``), any
    URL with ``://`` (e.g. ``file://`` for tests), or ``None`` for
    ``env://``, which ``torchrun`` sets up.  ``device=None`` is the card
    (``torch.cuda.set_device(LOCAL_RANK)``, default backend ``nccl``);
    ``device="cpu"`` selects ``gloo``.  ``backend="gloo"`` with the card lets
    several ranks share one GPU, which NCCL refuses.  Call once per process
    before any sharded computation.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run the "
                "ranks on the CPU over gloo")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {} if num_processes is None else dict(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            timeout=TIMEOUT, **kw)
    _GROUP_DEVICE[:] = [device]


def _init_method(coordinator_address: str | None) -> str:
    """``None`` → ``env://``; a URL (``file://``, ``tcp://``) as it is;
    ``"host:port"`` → ``tcp://host:port``."""
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _initialize_single() -> None:
    """A one-rank group on the card, on a free localhost port."""
    initialize(f"localhost:{_free_port()}", 1, 0)


def group_device() -> torch.device:
    """The device of the initialized group's tensors: the one
    :func:`initialize` was given, else the current card under NCCL, else
    the CPU."""
    if _GROUP_DEVICE:
        return _GROUP_DEVICE[0]
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process that owns host-side I/O (cache writes, prints)."""
    return process_count() == 1 or dist.get_rank() == 0


def host_broadcast_array(x: np.ndarray) -> np.ndarray:
    """Rank 0's ``x`` on every rank, as float64 (the identity in a world of
    one): a broadcast on the group's device under NCCL, on the CPU
    under gloo.  Every rank passes an array of the same shape."""
    if process_count() == 1:
        return x
    device = torch.device("cpu")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    t = torch.as_tensor(np.asarray(x, np.float64), device=device).contiguous()
    dist.broadcast(t, src=0)
    return t.cpu().numpy()
