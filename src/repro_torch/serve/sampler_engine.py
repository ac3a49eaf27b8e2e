"""Slot-based batched serving engine for NDPP sampling (port of
``repro/serve/sampler_engine.py``).

``backend="rejection"`` (default): a fixed pool of ``n_slots`` requests
shares one speculative round per tick; every slot contributes ``n_spec``
i.i.d. proposals (vacant slots ride along as ignored lanes, so the round
width never changes), and a slot retires at its first accepted proposal.
The sampler is a static ``NDPPSampler`` or a dynamic ``Catalog`` /
``CatalogState``: in catalog mode each request pins the ``CatalogState``
current at its admission, ``swap_catalog`` installs a new version between
ticks without draining in-flight slots, and a tick runs one round per
distinct pinned state still in flight.

``backend="mcmc"``: slot = chain.  Every occupied slot is a Metropolis
chain (``core.mcmc``, up/down or fixed-size swap); one batched call
advances the whole pool ``mcmc_steps_per_tick`` steps per tick, and a slot
retires with its chain state at step ``burn_in + thin``.

``mesh=``: the item axis is sharded over a mesh (``launch/mesh.py``); the
engine places the sampler (or catalog state) once, at construction and in
``swap_catalog``, and every tick runs the same round or chain step, whose
row reads go to the owning shards; results equal the unsharded engine's.

``telemetry=``: per-request spans, the reference's metric names and a
flight recorder (``repro_torch.obs``).  It records only from values the
tick's one device-to-host copy already brought to the host, so an
instrumented engine makes the same copies and launches and draws the same
items as a bare one.

Exactness: proposal t of request ``rid`` is drawn from
``fold_in(PRNGKey(seed), t)`` and MH step t of a chain from
``fold_in(chain_key, t)``, so a request's draw does not depend on pool
occupancy, admission order, n_spec or tick size, and equals the reference
engine's for the same seed and state.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import random as trandom
from ..core import mcmc as mcmc_core
from ..core.dynamic import (
    _spec_round_dual_fused,
    auto_n_spec_dynamic,
    shard_proposal,
)
from ..core.rejection import (
    NDPPSampler,
    _spec_round_fused,
    auto_n_spec,
    shard_sampler,
)
from ..core.tree import shard_spectral
from ..core.types import SpectralNDPP
from ..models import sharding as msh
from ..obs import Span, Telemetry, engine_instruments, phase_annotation
from ..obs.prof import phases as prof_phases
from .catalog import Catalog, CatalogState, as_state

#: the greedy start's key: fold_in(PRNGKey(seed), "grdy")
_GREEDY_TAG = 0x67726479

class TickBudgetExhausted(RuntimeError):
    """``run(max_ticks=...)`` ended with work still queued or in flight.

    Attributes:
      unfinished: {rid: span-state dict} for requests still holding slots.
      queued: rids never admitted.
    """

    def __init__(self, msg: str, unfinished: Dict[int, dict],
                 queued: List[int]):
        super().__init__(msg)
        self.unfinished = unfinished
        self.queued = queued


def _host_prng_key(seed: int) -> np.ndarray:
    """Raw uint32 key equal to the reference's 32-bit
    ``jax.random.PRNGKey(seed)`` in the threefry2x32 layout:
    ``[0, seed & 0xFFFFFFFF]`` (the high word of a 32-bit seed is 0)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


@dataclasses.dataclass
class SampleRequest:
    """One sampling request submitted to the engine.

    Attributes:
      rid: caller-chosen request id; keys the ``run()`` result dict.
      seed: PRNG seed — proposal (or MH step) t of this request is always
        drawn from ``fold_in(PRNGKey(seed), t)``, independent of scheduling.
      max_trials: rejection proposal budget (MCMC ignores it and retires
        at step ``burn_in + thin``).
      result: filled by the engine at retire time.
    """

    rid: int
    seed: int = 0
    max_trials: int = 256
    result: Optional["SampleResult"] = None


@dataclasses.dataclass
class SampleResult:
    """A retired request's draw.

    Attributes:
      items: (R,) padded item indices, R = 2K; -1 marks empty slots.
      mask: (R,) validity mask (``items[mask]`` is the sampled subset).
      trials: proposals consumed (rejection) or MH steps taken (MCMC).
      accepted: False iff the rejection budget was exhausted (the last
        proposal is returned anyway); always True for MCMC.
    """

    items: np.ndarray
    mask: np.ndarray
    trials: int
    accepted: bool


class SamplerEngine:
    """Continuous-batching frontend over the NDPP samplers.

    Args:
      sampler: an ``NDPPSampler`` (static rejection), a ``Catalog`` /
        ``CatalogState`` (requests pin the version they were admitted
        under; ``swap_catalog`` installs new versions with zero drain),
        or, for MCMC, a bare ``SpectralNDPP``.  The engine runs on its
        device.
      n_slots: pool size — concurrent in-flight requests per tick.
      n_spec: rejection speculation depth per slot per tick (default
        auto-sizes to ~E[#trials]).
      backend: "rejection" or "mcmc".
      mcmc_burn_in / mcmc_thin: a chain retires with its state at step
        ``burn_in + thin``.
      mcmc_steps_per_tick: MH steps the pool advances per tick (default
        ``min(refresh_every, burn_in + thin)``).
      mcmc_k: None = up/down chain; an integer runs the fixed-size swap
        chain from stochastic-greedy size-k starts.
      mcmc_p_swap: swap-move weight of the up/down chain.
      mcmc_refresh_every: exact O(R^3) inverse-cache refresh period.
      mesh: shard the item axis over the mesh "model" axis.  The engine
        places the sampler or catalog state once (``shard_sampler`` /
        ``shard_spectral`` / ``shard_proposal``, also in ``swap_catalog``)
        and every tick runs the same round or chain step on the placed
        arrays; results equal the unsharded engine's.  M must divide over the mesh and, for a
        static sampler, every shard must own whole leaf blocks.  A
        ``Catalog`` brings its own mesh.
      telemetry: a ``repro_torch.obs.Telemetry``: per-request spans,
        labelled metrics and a flight recorder of recent events.  Free:
        the draws, the device-to-host copies and the launches a tick are
        those of the bare engine.
      on_exhausted: what ``run()`` does when the tick budget ends with
        requests still queued or in flight: "raise" (default,
        ``TickBudgetExhausted``), "warn" or "ignore" (return the partial
        results).  With telemetry a flight event is recorded in every
        mode.
    """

    def __init__(self, sampler: Union[NDPPSampler, SpectralNDPP, Catalog,
                                      CatalogState],
                 n_slots: int = 8, n_spec: Optional[int] = None,
                 backend: str = "rejection", mcmc_burn_in: int = 256,
                 mcmc_thin: int = 16,
                 mcmc_steps_per_tick: Optional[int] = None,
                 mcmc_k: Optional[int] = None, mcmc_p_swap: float = 0.25,
                 mcmc_refresh_every: int = 64, mesh=None,
                 telemetry: Optional[Telemetry] = None,
                 on_exhausted: str = "raise"):
        if backend not in ("rejection", "mcmc"):
            raise ValueError(f"unknown backend {backend!r}")
        if on_exhausted not in ("raise", "warn", "ignore"):
            raise ValueError(f"unknown on_exhausted mode {on_exhausted!r}")
        self.on_exhausted = on_exhausted
        self.backend = backend
        self.mesh = mesh
        self._cat: Optional[CatalogState] = None
        self.sampler: Optional[NDPPSampler] = None
        if isinstance(sampler, (Catalog, CatalogState)):
            # the catalog owns mesh placement: its arrays are already on it
            if isinstance(sampler, Catalog):
                if mesh is not None and sampler.mesh != mesh:
                    raise ValueError(
                        "pass the catalog's own mesh (or none): the catalog "
                        "arrays are already placed on it")
                self.mesh = mesh = sampler.mesh
            self._cat = self._placed(as_state(sampler))
            self.sp = self._cat.sp
        elif isinstance(sampler, NDPPSampler):
            self.sampler = sampler
            self.sp = sampler.sp
        elif isinstance(sampler, SpectralNDPP) and backend == "mcmc":
            self.sp = sampler
        else:
            raise ValueError(
                f"backend={backend!r} needs a preprocessed NDPPSampler or a "
                f"Catalog/CatalogState"
                + (" or a SpectralNDPP" if backend == "mcmc" else "")
                + f", not {type(sampler).__name__}")
        if mesh is not None and self._cat is None:
            s = msh.model_extent(mesh)
            if self.sp.M % s != 0:
                raise ValueError(
                    f"the mesh 'model' extent {s} must divide the catalog "
                    f"size M={self.sp.M}: pad the catalog or shrink the mesh")
            if self.sampler is not None:
                tree = self.sampler.tree
                if tree.W.shape[0] % (s * tree.block) != 0:
                    # an engine that silently replicated the tree (the bulk
                    # of the memory) would be a configuration fault
                    raise ValueError(
                        f"cannot shard the proposal tree: each shard must "
                        f"own whole leaf blocks, i.e. {s} * block="
                        f"{tree.block} must divide M_pad={tree.W.shape[0]}: "
                        f"use a smaller block or shrink the mesh")
                self.sampler = shard_sampler(self.sampler, mesh)
                self.sp = self.sampler.sp
            else:
                self.sp = shard_spectral(self.sp, mesh)
        self.device = self.sp.sigma.device
        self.n_slots = n_slots
        if backend == "rejection":
            self._auto_spec = n_spec is None
            if n_spec is not None:
                self.n_spec = n_spec
            elif self._cat is not None:
                self.n_spec = auto_n_spec_dynamic(self._cat.proposal,
                                                  self._cat.sp)
            else:
                self.n_spec = auto_n_spec(sampler)
        else:
            self.mcmc_burn_in = mcmc_burn_in
            self.mcmc_thin = mcmc_thin
            self.mcmc_k = mcmc_k
            self.mcmc_p_swap = mcmc_p_swap
            self.mcmc_refresh_every = mcmc_refresh_every
            self.mcmc_steps_per_tick = (
                min(mcmc_refresh_every, mcmc_burn_in + mcmc_thin)
                if mcmc_steps_per_tick is None else mcmc_steps_per_tick)
            self._states = mcmc_core.init_empty(self.sp, n_slots)
        self.queue: List[SampleRequest] = []
        self.slot_req: List[Optional[SampleRequest]] = [None] * n_slots
        self.slot_key = np.zeros((n_slots, 2), np.uint32)
        self.slot_trials = np.zeros(n_slots, np.int64)
        # catalog mode: the state each in-flight request samples from,
        # pinned at admission and released at retire
        self.slot_pin: List[Optional[CatalogState]] = [None] * n_slots
        self.finished: Dict[int, SampleResult] = {}
        self.ticks = 0
        self._tel = telemetry
        self._spans: Dict[int, Span] = {}
        if telemetry is not None:
            self._m = engine_instruments(telemetry.registry)
            telemetry.flight.record(
                "engine_start", backend=backend, n_slots=n_slots,
                n_spec=getattr(self, "n_spec", None),
                catalog_version=None if self._cat is None
                else self._cat.version)
            if self._cat is not None:
                self._m.catalog_version.set(self._cat.version)

    # ------------------------------------------------------------- frontend
    def submit(self, req: SampleRequest, span: Optional[Span] = None):
        """Queue a request.  ``span``: a front door hands down the span it
        opened at its own admission point, so that the submit-to-retire
        latency counts from when the request entered the serving stack,
        not from this (possibly later) staging call."""
        self.queue.append(req)
        if self._tel is not None:
            self._spans[req.rid] = span if span is not None else Span(
                rid=req.rid, seed=req.seed, backend=self.backend)
            self._m.submitted.inc(backend=self.backend)
            self._m.queue_depth.set(len(self.queue))
            self._tel.flight.record("submit", rid=req.rid, seed=req.seed)

    def cancel(self, rid: int, outcome: str = "cancelled") -> bool:
        """Abandon a queued (never admitted) request; True iff ``rid`` was
        waiting in the queue.  Its span ends ``shed`` or ``cancelled`` (per
        ``outcome``), never ``retired``, so the queue-wait and latency
        histograms never see it.  In-flight requests always retire
        normally (False)."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                if self._tel is not None:
                    span = self._spans.pop(rid, None)
                    if span is not None:
                        span.abandon(outcome)
                    self._m.abandoned.inc(backend=self.backend,
                                          outcome=outcome)
                    self._m.queue_depth.set(len(self.queue))
                    self._tel.flight.record("abandon", rid=rid,
                                            outcome=outcome)
                return True
        return False

    def swap_catalog(self, cat: Union[Catalog, CatalogState]):
        """Install a new catalog version between ticks, with zero drain.

        Rejection: in-flight slots keep sampling from the state they pinned
        at admission (proposal and acceptance target), so their draws equal
        those of an engine that never swapped; only newly admitted requests
        see the new version, and the automatic ``n_spec`` is re-tuned to
        it.  MCMC: chains follow the live kernel, so every cached inverse
        is re-anchored on the new rows (``mcmc.reanchor``, which drops
        deleted items); step counters, and so key schedules, are kept.
        """
        st = self._placed(as_state(cat))
        if self.backend == "rejection" and self._cat is None:
            raise ValueError("swap_catalog on a rejection engine requires "
                             "it to have been built from a Catalog")
        if self._tel is not None:
            self._m.swaps.inc()
            self._m.catalog_version.set(st.version)
            self._tel.flight.record(
                "catalog_swap", version=st.version,
                from_version=None if self._cat is None
                else self._cat.version,
                stale=st.stale,
                in_flight=[r.rid for r in self.slot_req if r is not None])
        self._cat = st
        self.sp = st.sp
        if self.backend == "mcmc":
            self._states = mcmc_core.reanchor(st.sp, self._states)
        elif self._auto_spec:
            self.n_spec = auto_n_spec_dynamic(st.proposal, st.sp)

    def _placed(self, st: CatalogState) -> CatalogState:
        """``st`` with its proposal and live state placed on the engine's
        mesh (a state already placed there keeps its arrays)."""
        if self.mesh is None:
            return st
        return dataclasses.replace(
            st, sp=shard_spectral(st.sp, self.mesh),
            proposal=shard_proposal(st.proposal, self.mesh))

    def _phase(self, name: str):
        """Profiler range of one engine phase (a no-op without telemetry or
        with ``NDPP_PROFILE`` unset)."""
        return (self._tel.phase(name) if self._tel is not None
                else phase_annotation(name, False))

    def _init_chain_state(self, seed: int) -> mcmc_core.MCMCState:
        """Deterministic per-request chain start: empty for the up/down
        chain, stochastic-greedy size-k for the swap chain (keyed off the
        request's key, apart from the step schedule)."""
        if self.mcmc_k is None:
            return mcmc_core.init_empty(self.sp, 1)
        greedy_key = trandom.fold_in(trandom.PRNGKey(seed, self.device),
                                     _GREEDY_TAG)
        return mcmc_core.init_greedy(self.sp, greedy_key, 1, self.mcmc_k)

    def _admit(self):
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                self.slot_key[slot] = _host_prng_key(req.seed)
                self.slot_trials[slot] = 0
                self.slot_pin[slot] = self._cat
                if self.backend == "mcmc":
                    st = self._init_chain_state(req.seed)
                    self._states = mcmc_core.MCMCState(*(
                        torch.cat([a[:slot], v, a[slot + 1:]])
                        for a, v in zip(self._states, st)))
                if self._tel is not None:
                    span = self._spans[req.rid]
                    span.admit(slot, None if self._cat is None
                               else self._cat.version)
                    self._m.queue_wait.observe(span.queue_wait,
                                               backend=self.backend)
                    self._tel.flight.record(
                        "admit", rid=req.rid, slot=slot, tick=self.ticks,
                        queue_wait_s=round(span.queue_wait, 9))

    def _retire(self, slot: int, result: SampleResult):
        req = self.slot_req[slot]
        req.result = result
        self.finished[req.rid] = result
        self.slot_req[slot] = None
        self.slot_pin[slot] = None
        if self._tel is None:
            return
        span = self._spans.pop(req.rid, None)
        if span is None:
            return
        span.retire(result.trials, result.accepted)
        self._m.retired.inc(backend=self.backend,
                            accepted="true" if result.accepted else "false")
        self._m.trials_total.inc(int(result.trials), backend=self.backend)
        if result.accepted:
            self._m.request_trials.observe(int(result.trials),
                                           backend=self.backend)
        self._m.latency.observe(span.wall, backend=self.backend)
        self._m.ticks_held.observe(span.ticks_held, backend=self.backend)
        self._tel.flight.record(
            "retire", rid=req.rid, slot=slot, trials=int(result.trials),
            accepted=bool(result.accepted), ticks_held=span.ticks_held,
            wall_s=round(span.wall, 9))

    # ----------------------------------------------------------------- core
    def step(self) -> bool:
        """One engine tick: admit from the queue, advance the whole pool,
        retire finished slots.  False if idle."""
        if self._tel is None:
            if self.backend == "mcmc":
                return self._step_mcmc()
            return self._step_rejection()
        t0 = self._tel.now()
        with self._tel.profile_tick(f"ndpp_engine_tick/{self.backend}"):
            progressed = (self._step_mcmc() if self.backend == "mcmc"
                          else self._step_rejection())
        if progressed:
            self._m.ticks.inc(backend=self.backend)
            self._m.tick_seconds.observe(self._tel.now() - t0,
                                         backend=self.backend)
        self._m.slots_occupied.set(sum(r is not None for r in self.slot_req))
        self._m.queue_depth.set(len(self.queue))
        return progressed

    def _step_mcmc(self) -> bool:
        """Advance every chain ``mcmc_steps_per_tick`` MH steps in one call
        (vacant slots carry dummy chains so shapes never change); a slot
        retires with its chain state at step ``burn_in + thin``, read from
        the per-step trace."""
        with self._phase(prof_phases.ADMISSION):
            self._admit()
        if all(r is None for r in self.slot_req):
            return False
        self.ticks += 1
        n_steps = self.mcmc_steps_per_tick
        with self._phase(prof_phases.ROUND_DISPATCH):
            keys = torch.from_numpy(
                self.slot_key.astype(np.int64)).to(self.device)
            kw = dict(n_steps=n_steps, fixed=self.mcmc_k is not None,
                      p_swap=self.mcmc_p_swap,
                      refresh_every=self.mcmc_refresh_every)
            self._states, items_tr, mask_tr, acc_tr = mcmc_core.run_chains(
                self.sp, keys, self._states, **kw)
        # the one device-to-host copy of the tick; the acceptance trace
        # rides along with or without telemetry, so that telemetry adds no
        # copy and no launch
        r = items_tr.shape[-1]
        with self._phase(prof_phases.HARVEST):
            packed = torch.cat([items_tr, mask_tr.long(),
                                acc_tr.long()[..., None]],
                               dim=2).cpu().numpy()
        items_h = packed[..., :r].astype(np.int32)
        mask_h = packed[..., r:2 * r].astype(bool)
        occupied = [s for s in range(self.n_slots)
                    if self.slot_req[s] is not None]
        if self._tel is not None:
            acc_h = packed[..., 2 * r].astype(bool)           # (S, n_steps)
            self._m.mcmc_accept.observe(float(np.mean(acc_h[occupied])))
            self._m.mcmc_steps.inc(n_steps * len(occupied))
            self._m.proposals.inc(n_steps * len(occupied), backend="mcmc")
            self._m.accepts.inc(int(np.sum(acc_h[occupied])), backend="mcmc")
        target = self.mcmc_burn_in + self.mcmc_thin
        for slot in occupied:
            if self._tel is not None:
                span = self._spans[self.slot_req[slot].rid]
                span.ticks_held += 1
                span.chain_steps += n_steps
            before = int(self.slot_trials[slot])
            self.slot_trials[slot] = before + n_steps
            if before + n_steps >= target:
                idx = target - before - 1
                self._retire(slot, SampleResult(
                    items=items_h[slot, idx], mask=mask_h[slot, idx],
                    trials=target, accepted=True))
        return True

    def _step_rejection(self) -> bool:
        """One speculative round per distinct pinned state (one in static
        mode, normally one in catalog mode, ordered by version); every
        round has the full pool's width and a slot harvests only its own
        state's round, so a request's proposals and acceptance tests
        always come from the arrays it was admitted under."""
        with self._phase(prof_phases.ADMISSION):
            self._admit()
        slots = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
        if not slots:
            return False
        self.ticks += 1
        if self._cat is None:
            groups = [(None, slots)]
        else:
            # by pinned-state identity: states of different catalogs could
            # share a version number
            by_pin: Dict[int, List[int]] = {}
            for s in slots:
                by_pin.setdefault(id(self.slot_pin[s]), []).append(s)
            groups = sorted(((self.slot_pin[ss[0]], ss)
                             for ss in by_pin.values()),
                            key=lambda g: g[0].version)
        # one host-to-device copy: key words and trial counts side by side
        host = np.concatenate(
            [self.slot_key.astype(np.int64),
             (self.slot_trials & 0xFFFFFFFF)[:, None]], axis=1)
        dev = torch.from_numpy(host).to(self.device)
        keys, trials = dev[:, :2], dev[:, 2]
        for pin, group in groups:
            with self._phase(prof_phases.ROUND_DISPATCH):
                if pin is None:
                    out = _spec_round_fused(self.sampler, keys, trials,
                                            n_spec=self.n_spec)
                else:
                    out = _spec_round_dual_fused(pin.proposal, pin.sp, keys,
                                                 trials, n_spec=self.n_spec)
            self._harvest(group, *out)
        return True

    def _harvest(self, slots: List[int], items, mask, accept):
        """Retire-or-advance the given slots from one round's outputs."""
        r = items.shape[-1]
        # the one device-to-host copy of the round
        with self._phase(prof_phases.HARVEST):
            packed = torch.cat([items, mask.long(), accept.long()[:, None]],
                               dim=1).cpu().numpy()
        items_h = packed[:, :r].astype(np.int32).reshape(
            self.n_slots, self.n_spec, r)
        mask_h = packed[:, r:2 * r].astype(bool).reshape(
            self.n_slots, self.n_spec, r)
        acc = packed[:, 2 * r].astype(bool).reshape(self.n_slots, self.n_spec)
        round_proposals = 0
        round_accepts = 0
        for slot in slots:
            req = self.slot_req[slot]
            # only proposals inside the request's budget count, so trial
            # accounting matches sample_batched_many even when max_trials
            # is not a multiple of n_spec
            remaining = int(req.max_trials - self.slot_trials[slot])
            usable = min(self.n_spec, remaining)
            row = acc[slot, :usable]
            if self._tel is not None:
                span = self._spans[req.rid]
                span.ticks_held += 1
                span.rounds += 1
                span.proposals += usable
                round_proposals += usable
                round_accepts += int(row.sum())
            if row.any():
                first = int(row.argmax())
                self._retire(slot, SampleResult(
                    items=items_h[slot, first], mask=mask_h[slot, first],
                    trials=int(self.slot_trials[slot]) + first + 1,
                    accepted=True))
            else:
                self.slot_trials[slot] += usable
                if self.slot_trials[slot] >= req.max_trials:
                    self._retire(slot, SampleResult(
                        items=items_h[slot, usable - 1],
                        mask=mask_h[slot, usable - 1],
                        trials=int(self.slot_trials[slot]), accepted=False))
        if self._tel is not None:
            self._m.rounds.inc(backend=self.backend)
            self._m.proposals.inc(round_proposals, backend=self.backend)
            self._m.accepts.inc(round_accepts, backend=self.backend)

    def run(self, max_ticks: int = 10_000) -> Dict[int, SampleResult]:
        """Drain the queue; returns {rid: SampleResult} for every retired
        request.  If the tick budget runs out with requests still queued or
        in flight, ``on_exhausted`` decides: raise ``TickBudgetExhausted``
        listing them with their span state (default), warn, or return the
        partial results; with telemetry a ``tick_budget_exhausted`` flight
        event is recorded first and the recorder dumped to
        ``Telemetry.dump_on_error`` if one is set."""
        for _ in range(max_ticks):
            progressed = self.step()
            if not progressed and not self.queue:
                break
        if self.queue or any(r is not None for r in self.slot_req):
            self._report_exhausted(max_ticks)
        return dict(self.finished)

    def _report_exhausted(self, max_ticks: int):
        unfinished: Dict[int, dict] = {}
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            span = self._spans.get(req.rid)
            unfinished[req.rid] = (
                span.snapshot() if span is not None
                else {"rid": req.rid, "state": "active", "slot": slot,
                      "trials": int(self.slot_trials[slot])})
        queued = [req.rid for req in self.queue]
        if self._tel is not None:
            self._tel.flight.record(
                "tick_budget_exhausted", max_ticks=max_ticks,
                in_flight=sorted(unfinished), queued=queued,
                spans=list(unfinished.values()))
            self._tel.on_error()
        if self.on_exhausted == "ignore":
            return
        msg = (f"run(max_ticks={max_ticks}) exhausted the tick budget with "
               f"{len(unfinished)} request(s) still in flight "
               f"(rids {sorted(unfinished)}, span state {unfinished}) and "
               f"{len(queued)} still queued (rids {queued})")
        if self.on_exhausted == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            return
        raise TickBudgetExhausted(msg, unfinished=unfinished, queued=queued)

    def stats(self) -> dict:
        """Point-in-time engine snapshot (host only); with telemetry, the
        metric snapshot and the flight recorder's depth too."""
        out = {
            "backend": self.backend,
            "ticks": self.ticks,
            "queue_depth": len(self.queue),
            "in_flight": sum(r is not None for r in self.slot_req),
            "finished": len(self.finished),
        }
        if self._cat is not None:
            out["catalog_version"] = self._cat.version
        if self._tel is not None:
            out["metrics"] = self._tel.registry.snapshot()
            out["flight_events"] = len(self._tel.flight)
            out["flight_dropped"] = self._tel.flight.dropped
        return out
