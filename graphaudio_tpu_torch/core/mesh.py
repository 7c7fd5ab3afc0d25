"""Reading a ``("voice", "part")`` device mesh, for the layers that shard.

The graph, the nodes and parallel/ all ask the same three things of a
``torch.distributed.device_mesh.DeviceMesh``: a dimension's size, this
rank's coordinate along it, and its process group. A mesh without the
dimension reads as one rank. ``PartShardable`` gives a node the padding of
its partition count that every part-sharded stage uses.
"""

from __future__ import annotations

#: The mesh's dimension names, in order.
AXES = ("voice", "part")


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dimension ``name`` (1 where the mesh has none)."""
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 where the mesh has none).
    Raises if this rank is not in the mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        import torch.distributed as dist

        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    return int(coord[names.index(name)])


def axis_group(mesh, name: str):
    """The process group of this rank's line along ``name``, or None where
    the dimension has one rank (nothing to reduce)."""
    return mesh.get_group(name) if axis_size(mesh, name) > 1 else None


class PartShardable:
    """A node whose stage can split its partitions over a mesh's ``part``
    dimension. The node says when (``supports_part_sharding``) and which
    axis of each stage const holds the partitions (``const_part_axes``)."""

    const_part_axes: dict = {}

    def supports_part_sharding(self, mesh) -> bool:
        raise NotImplementedError

    def _padded_parts(self, P: int, mesh) -> int:
        """P rounded up to a multiple of the mesh's ``part`` size (P itself
        when the stage does not shard)."""
        if not self.supports_part_sharding(mesh):
            return P
        n = axis_size(mesh, "part")
        return -(-P // n) * n
