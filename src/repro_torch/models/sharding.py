"""Row gathers (port of the plain branch of ``repro/models/sharding.py``).

The reference fetches rows of a possibly item-sharded matrix by a masked
psum across the mesh; the port runs on one device, so only the plain
gather exists (the sharded one is a later slice of the port).
"""
from __future__ import annotations

import torch


def gather_row(Z: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Row ``Z[j]`` of an (M, R) matrix; ``j`` a scalar or batched (N,)
    row index."""
    return Z[j]
