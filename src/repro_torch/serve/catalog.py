"""Versioned dynamic catalog: streaming item insert, update and delete
(port of ``repro/serve/catalog.py``, without telemetry).

``Catalog`` keeps three pieces of state consistent:

  * the live spectral state ``sp``: Z rows embedded through a frozen Youla
    transform (``core.youla.youla_transform_np``), so a row edit touches
    one row of Z while ``Z X Z^T`` stays an exact factorization of the
    live kernel;
  * the live dual proposal (tree + R x R dual eigens), maintained in
    O(B (block + log M) R^2) per mutation batch (``core.dynamic``),
    bit-equal to a rebuild;
  * the proposal snapshot served to samplers: the live proposal, except
    that deletes may defer the reinstall within a ``staleness`` budget
    (the snapshot then dominates the live kernel and acceptance against
    the live kernel keeps draws exact; only the rejection rate degrades).

Every mutation bumps the monotone ``version`` and ``state()`` returns an
immutable ``CatalogState`` that an engine can pin.  JAX arrays are
immutable by nature; here every mutation is copy-on-write (Z, the dual
rows and the node stack are copied, then written), so a pinned state never
changes under an in-flight request.  At M = 2^20, R = 200 the copy is the
5.24 GB node stack plus 0.84 GB each of Z and dual rows per batch.

Insertions land in the zero-padded slack (freed slots reused lowest
first); when the slack runs out the capacity doubles and the tree is
rebuilt from scratch.

With ``mesh=`` the catalog is item-sharded: Z and the tree live split
over the mesh, each mutation batch is routed to the shards owning its
rows (``models.sharding.scatter_rows_sharded``,
``core.tree.update_rows_sharded``) and sampling runs the sharded rounds,
all bit-identical to the unsharded catalog.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.dynamic import (
    DualProposal,
    build_dual_proposal,
    expected_trials_dynamic,
    sample_dynamic_many,
    update_proposal,
)
from ..core.rejection import RejectionSample
from ..core.types import SpectralNDPP
from ..core.youla import youla_transform_np
from ..device import DeviceLike, resolve_device
from ..models import sharding as msh


@dataclasses.dataclass(frozen=True)
class CatalogState:
    """Immutable snapshot of a catalog version (what engines pin).

    Attributes:
      version: monotone catalog version (bumped by every mutation batch).
      proposal_version: version the proposal snapshot was built at
        (== ``version`` unless deletes were deferred).
      sp: live spectral state, Z at capacity rows (dead and slack rows are
        exact zeros): the acceptance target.
      proposal: the ``DualProposal`` snapshot requests sample from.
      m: live item count.
    """

    version: int
    proposal_version: int
    sp: SpectralNDPP
    proposal: DualProposal
    m: int

    @property
    def stale(self) -> bool:
        return self.proposal_version != self.version

    def expected_trials(self) -> float:
        """E[#trials] of a draw under this state (grows while stale)."""
        return float(expected_trials_dynamic(self.proposal, self.sp))


class Catalog:
    """Mutable dynamic catalog over a low-rank NDPP kernel.

    Args:
      V, B: (M, K) item factors; D: (K, K).  The Youla transform of (B, D)
        is computed once, on the host in float64, and frozen: items are
        embedded as ``z = [v, b @ T]`` (a change of D needs a new Catalog).
      block: tree leaf-block size.
      capacity: minimum item capacity, rounded up to a power-of-two number
        of leaf blocks (default: the natural padding of M).
      staleness: how many consecutive delete batches may defer the
        snapshot reinstall (0 = always fresh).
      mesh: item-shard the catalog over the mesh "model" axis
        (``repro_torch.launch.mesh.make_sampler_mesh``); the state then
        lives on the mesh's devices and replicated arrays on its first.
      device: where the state lives without a mesh (default ``cuda``).

    ``telemetry=`` is not ported yet and raises.
    """

    def __init__(self, V, B, D, *, block: int = 64,
                 capacity: Optional[int] = None, staleness: int = 0,
                 mesh=None, telemetry=None, device: DeviceLike = None):
        if telemetry is not None:
            raise NotImplementedError(
                "telemetry= is not ported yet (ROADMAP, Queue 1: "
                "observability and the front door)")
        self.mesh = mesh
        if mesh is not None:
            msh.model_extent(mesh)
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.block = block
        self.staleness = staleness
        v = torch.as_tensor(V, dtype=torch.float32).to(self.device)
        b = torch.as_tensor(B, dtype=torch.float32).to(self.device)
        m, k = v.shape
        b_host = B.detach().cpu().numpy() if isinstance(B, torch.Tensor) \
            else np.asarray(B)
        d_host = D.detach().cpu().numpy() if isinstance(D, torch.Tensor) \
            else np.asarray(D)
        sig, t = youla_transform_np(b_host, d_host)
        self._t = torch.as_tensor(t, dtype=torch.float32).to(self.device)
        self._sigma = torch.as_tensor(sig, dtype=torch.float32).to(self.device)
        cap = self._round_capacity(max(capacity or m, m))
        z = torch.zeros((cap, 2 * k), dtype=torch.float32, device=self.device)
        z[:m] = torch.cat([v, b @ self._t], dim=1)
        self._alive = np.zeros(cap, bool)
        self._alive[:m] = True
        self._version = 0
        self._deferred = 0
        self._install(z)

    # ------------------------------------------------------------- plumbing
    def _round_capacity(self, cap: int) -> int:
        """Round up to a power-of-two leaf-block count (and at least one
        block per shard when meshed, so the tree stays shardable)."""
        n_blocks = 1 << max(0, math.ceil(
            math.log2(max(1, -(-cap // self.block)))))
        if self.mesh is not None:
            n_blocks = max(n_blocks, msh.model_extent(self.mesh))
        return n_blocks * self.block

    def _install(self, z: torch.Tensor):
        """Full (re)build of the live state and dual proposal: catalog
        construction and capacity doubling only."""
        self._sp = SpectralNDPP(Z=z, sigma=self._sigma)
        self._live_prop = build_dual_proposal(self._sp, self.block,
                                              mesh=self.mesh)
        self._sp = self._live_prop.sp      # mesh: the placed copy
        self._snap = self._live_prop
        self._snap_version = self._version
        self._deferred = 0

    def _apply(self, idx: np.ndarray, z_rows: torch.Tensor, *, install: bool):
        """One mutation batch: copy-on-write scatter of the live Z rows, the
        live proposal advanced incrementally, the version bumped, and the
        snapshot reinstalled unless a deferral was asked for and budgeted."""
        idx_t = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        if self.mesh is None:
            z = msh.scatter_rows(self._sp.Z, idx_t, z_rows)
        else:
            z = msh.scatter_rows_sharded(self._sp.Z, idx_t, z_rows,
                                         self.mesh)
        self._sp = SpectralNDPP(Z=z, sigma=self._sigma)
        self._live_prop = update_proposal(self._live_prop, idx_t, z_rows,
                                          self._sp, mesh=self.mesh)
        self._version += 1
        if not install and self._deferred < self.staleness:
            self._deferred += 1
        else:
            self._snap = self._live_prop
            self._snap_version = self._version
            self._deferred = 0

    def _embed(self, v_rows, b_rows) -> torch.Tensor:
        v_rows = torch.atleast_2d(torch.as_tensor(
            v_rows, dtype=torch.float32)).to(self.device)
        b_rows = torch.atleast_2d(torch.as_tensor(
            b_rows, dtype=torch.float32)).to(self.device)
        return torch.cat([v_rows, b_rows @ self._t], dim=1)

    # ------------------------------------------------------------ properties
    @property
    def capacity(self) -> int:
        return int(self._sp.Z.shape[0])

    @property
    def m(self) -> int:
        return int(self._alive.sum())

    @property
    def version(self) -> int:
        return self._version

    def alive_ids(self) -> np.ndarray:
        """Item ids (row indices) currently live, ascending."""
        return np.flatnonzero(self._alive)

    def state(self) -> CatalogState:
        """Immutable snapshot for engines and samplers (no copy)."""
        return CatalogState(version=self._version,
                            proposal_version=self._snap_version,
                            sp=self._sp, proposal=self._snap, m=self.m)

    # ------------------------------------------------------------- mutations
    def insert_items(self, v_rows, b_rows) -> np.ndarray:
        """Insert items with factor rows ``v_rows``/``b_rows`` (B, K).

        Returns the assigned item ids (row indices), taken from the free
        slots lowest first; overflowing the capacity doubles it and
        rebuilds.  Always reinstalls the snapshot: one that predates an
        insert cannot dominate the live kernel.
        """
        z_rows = self._embed(v_rows, b_rows)
        n_new = z_rows.shape[0]
        free = np.flatnonzero(~self._alive)
        if free.size < n_new:
            self._grow(self.m + n_new)
            free = np.flatnonzero(~self._alive)
        ids = free[:n_new]
        self._alive[ids] = True
        self._apply(ids, z_rows, install=True)
        return ids

    def update_items(self, ids: Sequence[int], v_rows, b_rows, *,
                     defer: bool = False):
        """Replace the factor rows of live items ``ids``.

        ``defer=True`` skips the snapshot reinstall (within the staleness
        budget); it keeps draws exact only when every update shrinks its
        row in the proposal norm, which the caller judges.
        """
        ids = np.asarray(ids, np.int64)
        if np.unique(ids).size != ids.size:
            # duplicate row writes resolve in unspecified order, which would
            # desync Z from the tree
            raise ValueError(f"duplicate ids in update batch: {ids.tolist()}")
        self._check_alive(ids, "update")
        self._apply(ids, self._embed(v_rows, b_rows), install=not defer)

    def delete_items(self, ids: Sequence[int]):
        """Delist items: their live rows become exact zeros (rejected with
        probability one from then on) and the slots return to the free
        list.  The snapshot reinstall is deferred within the staleness
        budget: a delete-stale snapshot always dominates the live kernel."""
        ids = np.unique(np.asarray(ids, np.int64))
        self._check_alive(ids, "delete")
        self._alive[ids] = False
        z_rows = torch.zeros((ids.size, self._sp.Z.shape[1]),
                             dtype=torch.float32, device=self.device)
        self._apply(ids, z_rows, install=False)

    def _check_alive(self, ids: np.ndarray, op: str):
        if ids.size and (ids.min() < 0 or ids.max() >= self.capacity):
            raise ValueError(f"{op} of dead/unknown items: ids outside "
                             f"[0, {self.capacity})")
        if not self._alive[ids].all():
            raise ValueError(f"{op} of dead/unknown items: "
                             f"{ids[~self._alive[ids]].tolist()}")

    def refresh(self):
        """Point the snapshot at the live proposal (ends any deferral)."""
        self._snap = self._live_prop
        self._snap_version = self._version
        self._deferred = 0

    def _grow(self, need: int):
        """Doubling rebuild: the capacity doubles until ``need`` fits, Z is
        re-padded and the tree and eigens are rebuilt from scratch."""
        cap = self.capacity
        while cap < need:
            cap *= 2
        cap = self._round_capacity(cap)
        z = torch.zeros((cap, self._sp.Z.shape[1]), dtype=torch.float32,
                        device=self.device)
        z[:self.capacity] = msh.full_rows(self._sp.Z)  # off any mesh first
        alive = np.zeros(cap, bool)
        alive[:self._alive.size] = self._alive
        self._alive = alive
        self._version += 1
        self._install(z)

    # -------------------------------------------------------------- sampling
    def sample_many(self, key, n: int, *, n_spec: Optional[int] = None,
                    max_trials: int = 1000, **kw) -> RejectionSample:
        """Draw ``n`` exact samples from the live kernel through the current
        snapshot (``core.dynamic.sample_dynamic_many``, sharded on the
        catalog's mesh)."""
        st = self.state()
        return sample_dynamic_many(st.proposal, st.sp, key, n, n_spec=n_spec,
                                   max_trials=max_trials, mesh=self.mesh,
                                   **kw)


CatalogLike = Union[Catalog, CatalogState]


def as_state(cat: CatalogLike) -> CatalogState:
    return cat.state() if isinstance(cat, Catalog) else cat
