"""Device-mesh construction for the (data × scale) / (mc) parallel layouts.

Counterpart of ``pycwt_tpu/parallel/mesh.py``, on one ``torch.distributed``
rank per device: a :class:`~torch.distributed.device_mesh.DeviceMesh` with
dims ``("data", "scale", "mc")``:

* ``data``  — batch of signals (or pairs, or time slabs), data-parallel;
* ``scale`` — filter-bank rows; inverse transforms and scale sums reduce
  over it, and the WCT's scale boxcar exchanges halo rows along it;
* ``mc``    — Monte-Carlo members or nulls; histograms reduce over it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import distributed

__all__ = ["MeshSpec", "make_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape.  Any axis set to 1 is still present (size-1 axes
    cost nothing and keep the sharding rules uniform)."""

    data: int = 1
    scale: int = 1
    mc: int = 1

    @property
    def ndevices(self) -> int:
        return self.data * self.scale * self.mc


def make_mesh(spec: MeshSpec | None = None, devices=None) -> DeviceMesh:
    """Build a ``DeviceMesh(("data", "scale", "mc"))`` over the ranks.

    ``devices`` may only be every rank of the world, in order (the
    default): a process group numbers a dim's ranks in that order, which the
    collectives rely on.  With no spec, all of them go to the ``data`` axis.
    The mesh lives on the device of the initialized group
    (:func:`pycwt_torch.parallel.distributed.initialize`).  Without a
    group, a one-device spec starts a one-rank group on the card (code
    written for one device keeps working); any other spec raises.  Every
    rank of the world calls this together.
    """
    if not dist.is_initialized():
        if spec is not None and spec.ndevices != 1:
            raise RuntimeError(
                f"mesh spec {spec} needs {spec.ndevices} ranks and no process "
                "group is initialized: call "
                "pycwt_torch.parallel.distributed.initialize on every rank first")
        distributed._initialize_single()
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if spec is None:
        spec = MeshSpec(data=n)
    if spec.ndevices != n:
        raise ValueError(f"mesh spec {spec} needs {spec.ndevices} devices, have {n}")
    if ranks != list(range(world)):
        raise ValueError(
            f"devices must be the {world} ranks of the world in order, got {ranks}")
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(spec.data, spec.scale, spec.mc)
    return DeviceMesh(distributed.group_device().type, layout,
                      mesh_dim_names=("data", "scale", "mc"))
