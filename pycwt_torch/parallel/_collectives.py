"""The collectives of the sharded surfaces, over one dim of a DeviceMesh.

Each JAX ``shard_map`` body of ``pycwt_tpu`` is a per-device SPMD function;
here it runs on one ``torch.distributed`` rank per device, and its
collectives map as follows:

* ``jax.lax.axis_index`` / ``axis_size`` → :func:`axis_rank` /
  :func:`axis_size` of the rank in the dim's group;
* ``jax.lax.psum`` → :func:`psum`, one ``all_reduce``;
* the two neighbour ``ppermute`` shifts of a halo exchange → :func:`shift`,
  one ``all_to_all_single`` with uneven splits (the edge ranks receive zero
  rows, as ``ppermute`` fills pairs that have no source);
* ``jax.lax.all_to_all(..., tiled=True)`` → :func:`all_to_all_tiled`.

Complex tensors travel as their real view.  A dim of size 1 needs no
collective, and none is called.  Nothing else in the package calls a
collective, but for :mod:`.distributed`'s broadcast.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["axis_rank", "axis_size", "psum", "shift", "all_to_all_tiled",
           "gather", "mesh_device", "block", "to_dtensor", "local_block"]


def axis_size(mesh, dim: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(dim))


def axis_rank(mesh, dim: str) -> int:
    return mesh.get_local_rank(dim)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: the current card for a
    ``cuda`` mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def psum(t: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``dim``, on every one of them."""
    out = t.clone(memory_format=torch.contiguous_format)
    if axis_size(mesh, dim) > 1:
        dist.all_reduce(_real(out), group=mesh.get_group(dim))
    return out


def _shift_splits(rank: int, n: int, up: int, down: int):
    """(rows sent to, rows received from) each peer of ``shift``: the first
    ``up`` rows go to the previous rank, the last ``down`` rows to the next;
    so ``down`` rows come from the previous rank and ``up`` from the next."""
    send, recv = [0] * n, [0] * n
    if rank > 0:
        send[rank - 1], recv[rank - 1] = up, down
    if rank < n - 1:
        send[rank + 1], recv[rank + 1] = down, up
    return send, recv


def shift(t: torch.Tensor, mesh, dim: str, up: int, down: int) -> torch.Tensor:
    """Halo exchange along axis 0 over the ranks of ``dim``: returns
    ``(down + rows + up, ...)``, the previous rank's last ``down`` rows, then
    ``t``, then the next rank's first ``up`` rows.  The first rank gets zeros
    below and the last zeros above (the global edges' zero padding).  One
    ``all_to_all_single`` with uneven splits; the caller checks that the
    halo fits the block."""
    n, r = axis_size(mesh, dim), axis_rank(mesh, dim)
    rows = t.shape[0]
    below = t.new_zeros((down,) + t.shape[1:])
    above = t.new_zeros((up,) + t.shape[1:])
    if n > 1 and (up or down):
        send, recv = _shift_splits(r, n, up, down)
        parts = ([t[:up]] if r > 0 else []) + ([t[rows - down:]] if r < n - 1 else [])
        inp = torch.cat(parts).contiguous()
        out = t.new_empty((sum(recv),) + t.shape[1:])
        dist.all_to_all_single(_real(out), _real(inp), output_split_sizes=recv,
                               input_split_sizes=send, group=mesh.get_group(dim))
        if r > 0:
            below = out[:down]
        if r < n - 1:
            above = out[out.shape[0] - up:]
    return torch.cat([below, t, above])


def all_to_all_tiled(t: torch.Tensor, mesh, dim: str, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(t, dim, split_axis, concat_axis, tiled=True)``:
    ``t`` is cut into D equal chunks along ``split_axis``, chunk j goes to
    rank j of ``dim``, and the chunks received are joined along
    ``concat_axis`` in the order of the ranks that sent them."""
    D = axis_size(mesh, dim)
    if D == 1:
        return t
    nd = t.ndim
    a, c = split_axis % nd, concat_axis % nd
    y = t.movedim(a, 0)
    y = y.reshape((D, y.shape[0] // D) + y.shape[1:]).contiguous()
    out = torch.empty_like(y)
    dist.all_to_all_single(_real(out), _real(y), group=mesh.get_group(dim))
    # (D, chunk at axis a, ...) -> (D, ...t's axes...) -> D in front of c
    out = out.movedim(1, a + 1).movedim(0, c)
    shape = out.shape
    return out.reshape(shape[:c] + (shape[c] * shape[c + 1],) + shape[c + 2:])


def gather(t: torch.Tensor, mesh, dim: str, axis: int = 0) -> torch.Tensor:
    """Every rank's block of ``dim`` joined along ``axis`` in rank order, on
    every rank: each rank writes its block into zeros and one :func:`psum`
    adds them (exact, since each element has one non-zero term)."""
    D = axis_size(mesh, dim)
    if D == 1:
        return t
    axis %= t.ndim
    n = t.shape[axis]
    full = t.new_zeros(t.shape[:axis] + (D * n,) + t.shape[axis + 1:])
    full.narrow(axis, axis_rank(mesh, dim) * n, n).copy_(t)
    return psum(full, mesh, dim)


def block(x: torch.Tensor, mesh, dim: str | None, axis: int) -> torch.Tensor:
    """This rank's block of a global tensor along ``axis``, cut evenly over
    the ranks of ``dim`` (the whole tensor for ``None``)."""
    if dim is None:
        return x
    D = axis_size(mesh, dim)
    n = x.shape[axis] // D
    return x.narrow(axis, axis_rank(mesh, dim) * n, n)


def local_block(x, mesh, dim: str, axis: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``axis`` over ``dim``: a DTensor
    already sharded so on ``mesh`` gives its local tensor, any other DTensor
    its full tensor's block, and a global tensor its block."""
    if isinstance(x, DTensor):
        axis %= x.ndim
        want = Shard(axis) if axis_size(mesh, dim) > 1 else None
        got = x.placements[mesh.mesh_dim_names.index(dim)]
        if x.device_mesh == mesh and (want is None or got == want) and all(
                isinstance(p, Replicate) for i, p in enumerate(x.placements)
                if mesh.mesh_dim_names[i] != dim):
            return x.to_local()
        x = x.full_tensor()
    return block(x, mesh, dim, axis)


def to_dtensor(local: torch.Tensor, mesh, shard: dict) -> DTensor:
    """A DTensor of this rank's ``local`` block: ``shard`` maps mesh dims to
    the tensor axis they split (JAX's ``PartitionSpec``); every other dim is
    replicated.  No collective runs."""
    placements = [Shard(shard[name]) if name in shard else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(local, mesh, placements, run_check=False)
