"""The device mesh and the slices of a GOP, ported from
fastvideocodec_tpu/parallel/mesh.py to torch.distributed.

The reference's parallelism maps onto three mesh axes, as in JAX:
- 'data'  : GOP/batch replicas (DataParallel's);
- 'view'  : MCVC's camera views (the views fold into the batch; the
            cross-view attention gathers its keys and values over 'view');
- 'frame' : LSVC's tree-layer frames (the temporal, 'sequence' axis).

A mesh is a ``DeviceMesh`` with those dim names over the ranks of the
process group, in rank order. Parameters are replicated (``replicate``: a
broadcast from the mesh's first rank). JAX places a sharded array's parts
on devices; here a rank holds its own part: ``shard_gop`` and
``shard_views`` return this rank's slice of a GOP, which its step takes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

AXES = ("data", "view", "frame")


def make_mesh(data: int = 1, view: int = 1, frame: int = 1, device_type: str = "cuda"):
    """A (data, view, frame) ``DeviceMesh`` over the process group's ranks
    (``init_device_mesh``), with the groups over each pair of its axes that
    does not span it built at once (a collective of every rank; kept as
    the mesh's ``pair_groups``). The mesh
    covers the whole group: a mesh larger than the group raises as JAX's
    does, and so does a smaller one (a rank outside it would hold
    nothing)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = data * view * frame
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {data}x{view}x{frame} needs {n} devices, have {world}")
    mesh = init_device_mesh(device_type, (data, view, frame), mesh_dim_names=AXES)
    sizes = dict(zip(AXES, (data, view, frame)))
    ranks = mesh.mesh.reshape(data, view, frame)
    mesh.pair_groups = {}
    for axes in (("data", "view"), ("data", "frame"), ("view", "frame")):
        rest = next(a for a in AXES if a not in axes)
        if all(sizes[a] > 1 for a in (*axes, rest)):
            dims = [AXES.index(a) for a in axes] + [AXES.index(rest)]
            subsets = ranks.permute(*dims).reshape(-1, sizes[rest]).T
            mesh.pair_groups[axes], _ = dist.new_subgroups_by_enumeration(subsets.tolist())
    return mesh


def axis_group(mesh, axes) -> tuple:
    """(group, ranks in it, this rank's index) of a ``make_mesh`` mesh over
    ``axes``, those of size 1 dropped: (None, 1, 0) when none is left; the
    default group over axes that span the mesh."""
    sizes = dict(zip(AXES, mesh.mesh.shape))
    axes = tuple(a for a in AXES if a in axes and sizes[a] > 1)
    if not axes:
        return None, 1, 0
    coord = dict(zip(AXES, mesh.get_coordinate()))
    index, parts = 0, 1
    for a in axes:
        index, parts = index * sizes[a] + coord[a], parts * sizes[a]
    if len(axes) == 1:
        return mesh.get_group(axes[0]), parts, index
    if parts == mesh.mesh.numel():
        return dist.group.WORLD, parts, index
    return mesh.pair_groups[axes], parts, index


def replicate(mesh, tree):
    """Replicate a tree of tensors (parameters, optimizer state: dicts,
    lists and tuples of them) across the mesh: each tensor, in place, the
    mesh's first rank's (one broadcast for the tensors of each device and
    dtype). Returns the tree."""
    src = int(mesh.mesh.flatten()[0])
    groups = {}

    def visit(node):
        if isinstance(node, torch.Tensor):
            groups.setdefault((node.device, node.dtype), []).append(node)
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(tree)
    with torch.no_grad():
        for tensors in groups.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, src=src)
            start = 0
            for t in tensors:
                t.copy_(flat[start:start + t.numel()].view_as(t))
                start += t.numel()
    return tree


@dataclass(frozen=True)
class GopSharding:
    """Which mesh axes split which axis of a GOP tensor (JAX's
    ``NamedSharding``): ``dim`` split evenly over ``axes`` in mesh order
    (none: every rank holds the whole). Called on a tensor, this rank's
    part."""

    mesh: object
    dim: int
    axes: tuple

    def rows(self, n: int) -> slice:
        _, parts, index = axis_group(self.mesh, self.axes)
        if n % parts:
            raise ValueError(f"an axis of {n} does not split evenly over {self.axes} "
                             f"({parts} parts)")
        each = n // parts
        return slice(index * each, (index + 1) * each)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        part = t[(slice(None),) * self.dim + (self.rows(t.shape[self.dim]),)]
        return part.contiguous()


def gop_sharding(mesh, batch_axes=("data",)) -> GopSharding:
    """A GOP [T, B, ...] split on B over ``batch_axes`` (JAX's
    P(None, batch_axes))."""
    return GopSharding(mesh, 1, tuple(batch_axes))


def shard_gop(mesh, gop: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """This rank's part of a [T, B, 3, H, W] GOP batch, B split over a mesh
    axis."""
    return gop_sharding(mesh, (axis,))(gop)


def shard_views(mesh, gop: torch.Tensor) -> torch.Tensor:
    """This rank's part of an MCVC [T, B*V, 3, H, W] GOP, B*V split over
    ('data', 'view') on axis 1."""
    return gop_sharding(mesh, ("data", "view"))(gop)
