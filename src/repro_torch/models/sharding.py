"""Item-axis sharding of the samplers (port of ``repro/models/sharding.py``
as far as the samplers use it).

The NDPP samplers shard the catalog ("items") axis of (M, R) matrices
over the mesh "model" axis (``launch/mesh.py``).  The port's mesh is
single-controller, so a row-sharded matrix is a ``ShardedRows``: S parts
of M/S rows, part s on mesh device s.  ``psum`` adds per-shard partials
on the mesh's first device.  Subsets are tiny (<= 2K items), so gathering
their rows is a masked local lookup on every shard plus a ``psum``:
exactly one shard owns each row and every other shard contributes exact
zeros, and x + 0.0 is exact, so the gathered rows are bit-identical to an
unsharded gather.

Placement follows the reference's ``logical_to_spec`` rule: an "items"
axis shards over "model" when the mesh extent divides it and is
replicated otherwise (a replicated matrix is one plain tensor on the
mesh's first device: one controller needs one copy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch


def model_extent(mesh) -> int:
    """Size of the mesh "model" axis; raises a clear error when ``mesh``
    has no such axis (build sampler meshes with
    ``repro_torch.launch.mesh.make_sampler_mesh``)."""
    if "model" not in getattr(mesh, "axis_names", ()):
        raise ValueError(
            f"mesh {mesh!r} has no 'model' axis; build sampler meshes with "
            f"make_sampler_mesh (1-D ('model',) axis)")
    return mesh.shape["model"]


def logical_to_spec(mesh, axes: Sequence[Optional[str]],
                    dims: Sequence[int]) -> Tuple[Optional[str], ...]:
    """Logical axes -> mesh axes for the samplers' arrays: "items" maps to
    "model" when the extent divides the dimension, else the axis is
    replicated (None), as in the reference's rule table."""
    s = model_extent(mesh)
    return tuple("model" if ax == "items" and dim % s == 0 else None
                 for ax, dim in zip(axes, dims))


def shard_offset(n_local: int, shard: int) -> int:
    """First global index owned by ``shard`` of an evenly split axis."""
    return shard * n_local


def owned(ix: torch.Tensor, shard: int, n_local: int):
    """(is ``ix`` owned by ``shard``?, its local index, clamped into the
    shard) for global indices ``ix`` of an evenly split axis."""
    base = shard_offset(n_local, shard)
    return (ix >= base) & (ix < base + n_local), (ix - base).clamp(
        0, n_local - 1)


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Sum of per-shard partials, on ``device`` (the mesh's first)."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


@dataclasses.dataclass(frozen=True)
class ShardedRows:
    """A row-sharded (M, ...) tensor: ``parts[s]`` holds rows
    [s * M/S, (s+1) * M/S) on ``mesh.devices[s]``."""

    mesh: object
    parts: Tuple[torch.Tensor, ...]

    @property
    def rows_per_shard(self) -> int:
        return self.parts[0].shape[0]

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0]
        return torch.Size((p.shape[0] * len(self.parts),) + tuple(p.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def full(self) -> torch.Tensor:
        """All rows, gathered on the mesh's first device."""
        return torch.cat([p.to(self.device) for p in self.parts])


Rows = Union[torch.Tensor, ShardedRows]


def shard_rows(x: Rows, mesh) -> Rows:
    """Place an (M, ...) matrix on ``mesh``: item-sharded when the mesh
    extent divides M (each part is a view when its device already holds
    ``x``), else replicated as one tensor on the mesh's first device."""
    if isinstance(x, ShardedRows):
        if x.mesh == mesh:
            return x
        x = x.full()
    s = model_extent(mesh)
    if logical_to_spec(mesh, ("items",), x.shape[:1])[0] is None:
        return x.to(mesh.device)
    n = x.shape[0] // s
    return ShardedRows(mesh=mesh, parts=tuple(
        x[i * n:(i + 1) * n].to(d) for i, d in enumerate(mesh.devices)))


def full_rows(x: Rows) -> torch.Tensor:
    """A plain tensor of all rows (gathered when ``x`` is sharded)."""
    return x.full() if isinstance(x, ShardedRows) else x


def row_parts(x: Rows, mesh) -> Tuple[torch.Tensor, ...]:
    """The per-shard row blocks of ``x`` on ``mesh``'s devices; a plain
    ``x`` is split evenly and must have M divisible by the mesh extent."""
    s = model_extent(mesh)
    if isinstance(x, ShardedRows) and x.mesh == mesh:
        return x.parts
    x = full_rows(x)
    if x.shape[0] % s:
        raise ValueError(f"the mesh 'model' extent {s} must divide "
                         f"M={x.shape[0]}")
    n = x.shape[0] // s
    return tuple(x[i * n:(i + 1) * n].to(d)
                 for i, d in enumerate(mesh.devices))


def gather_row(Z: Rows, j: torch.Tensor) -> torch.Tensor:
    """Row ``Z[j]`` of a (possibly row-sharded) (M, R) matrix; ``j`` a
    scalar or batched (N,) global row index.  Sharded: every shard looks
    up the rows it owns, zeros elsewhere, and the partials are summed."""
    if not isinstance(Z, ShardedRows):
        return Z[j]
    parts = []
    for s, (part, dev) in enumerate(zip(Z.parts, Z.mesh.devices)):
        own, loc = owned(j.to(dev), s, Z.rows_per_shard)
        parts.append(torch.where(own[..., None], part[loc], 0.0))
    return psum(parts, Z.device)


def gather_rows(Z: Rows, items: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked subset rows ``Z[items] * mask`` with padding rows zeroed:
    ``items`` (..., k_pad) global indices (-1 on padding), ``mask``
    (..., k_pad) -> (..., k_pad, R).  Bit-identical between the plain
    gather and the sharded one (see the module docstring)."""
    if not isinstance(Z, ShardedRows):
        return Z[items.clamp_min(0)] * mask[..., None].to(Z.dtype)
    parts = []
    for s, (part, dev) in enumerate(zip(Z.parts, Z.mesh.devices)):
        own, loc = owned(items.to(dev), s, Z.rows_per_shard)
        own = own & mask.to(dev)
        parts.append(part[loc] * own[..., None].to(part.dtype))
    return psum(parts, Z.device)


def scatter_rows(Z: Rows, idx: torch.Tensor, rows: torch.Tensor) -> Rows:
    """``Z[idx] <- rows``, copy-on-write (``Z`` is left as it was, so a
    pinned catalog state never changes).  Sharded: each shard copies its
    part and applies only the updates it owns, so rows never leave their
    device.  ``idx`` must be unique."""
    if not isinstance(Z, ShardedRows):
        z = Z.clone()
        z[idx.to(z.device)] = rows.to(z.device, z.dtype)
        return z
    new = []
    for s, (part, dev) in enumerate(zip(Z.parts, Z.mesh.devices)):
        own, loc = owned(idx.to(dev), s, Z.rows_per_shard)
        p = part.clone()
        p[loc[own]] = rows.to(dev, part.dtype)[own]
        new.append(p)
    return ShardedRows(mesh=Z.mesh, parts=tuple(new))


def scatter_rows_sharded(Z: Rows, idx: torch.Tensor, rows: torch.Tensor,
                         mesh) -> Rows:
    """``scatter_rows`` with ``Z`` placed on ``mesh`` first (a plain
    functional scatter when Z does not divide the mesh)."""
    return scatter_rows(shard_rows(Z, mesh), idx, rows)
