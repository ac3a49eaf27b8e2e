"""Sampler meshes (port of ``repro/launch/mesh.py::make_sampler_mesh``).

The reference shards the catalog ("items") axis over the "model" axis of
a JAX mesh and runs each sharded round as one ``shard_map``.  The port's
mesh is single-controller: an ordered list of S shard devices on one
"model" axis.  One process drives every shard; a ``shard_map`` body
becomes a loop over the shards, each working on the tensors it holds on
its own device, and the cross-shard sums land on the first device
(``models/sharding.py``).  A device may be named more than once, which
places several shards on one card (or on the CPU): that is how the tests
and ``chip_smoke.py`` run S = 2 on a host with one device.  On a host
with several cards, ``make_sampler_mesh(S)`` takes ``cuda:0`` ..
``cuda:S-1``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S shard devices on the one "model" axis, shard s on
    ``devices[s]``; replicated state and cross-shard sums live on
    ``devices[0]``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("model",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"model": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_sampler_mesh(n_devices: Optional[int] = None,
                      devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A 1-D ("model",) mesh for item-axis-sharded NDPP sampling.

    ``devices``: the shard devices in order (repeats allowed, e.g.
    ``["cuda:0", "cuda:0"]`` or ``["cpu"] * 2``); ``n_devices`` takes the
    first n of them.  Without ``devices`` the mesh is the first
    ``n_devices`` CUDA devices (all of them by default), and asking for
    more than the host has raises, as the reference does.
    """
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_sampler_mesh places shards on CUDA devices by default "
                "and none is available; pass devices=['cpu', ...] to build "
                "a mesh on the CPU")
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"asked for {n} devices, host has {count}")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"asked for {n_devices} devices, "
                                 f"{len(devs)} given")
            devs = devs[:n_devices]
    if not devs:
        raise ValueError("a sampler mesh needs at least one device")
    return Mesh(devices=tuple(devs))
