"""Slot-based batched serving engine for NDPP sampling (port of
``repro/serve/sampler_engine.py``, rejection backend, static sampler).

A fixed pool of ``n_slots`` requests shares one speculative round per tick:
every slot contributes ``n_spec`` i.i.d. proposals (vacant slots ride along
as ignored lanes, so the round width never changes), and a slot retires at
its first accepted proposal.  Each tick copies its keys to the device once
and its results ``(items, mask, accept)`` back once.

Exactness: proposal t of request ``rid`` is always drawn from
``fold_in(PRNGKey(seed), t)``, so the draw a request receives is
independent of pool occupancy, admission order, n_spec and tick size — and
equal to the reference engine's for the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.rejection import NDPPSampler, _spec_round_fused, auto_n_spec
from repro_torch.core.types import SpectralNDPP


class TickBudgetExhausted(RuntimeError):
    """``run(max_ticks=...)`` ended with work still queued or in flight.

    Attributes:
      unfinished: {rid: state dict} for requests still holding slots.
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
      seed: PRNG seed — proposal t of this request is always drawn from
        ``fold_in(PRNGKey(seed), t)``, independent of scheduling.
      max_trials: proposal budget.
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
      trials: proposals consumed.
      accepted: False iff the budget was exhausted (the last proposal is
        returned anyway).
    """

    items: np.ndarray
    mask: np.ndarray
    trials: int
    accepted: bool


class SamplerEngine:
    """Continuous-batching frontend over the speculative rejection sampler.

    Args:
      sampler: a preprocessed ``NDPPSampler``; the engine runs on its
        device.
      n_slots: pool size — concurrent in-flight requests per tick.
      n_spec: speculation depth per slot per tick (default auto-sizes to
        ~E[#trials]).

    The reference's other backends and options (``backend="mcmc"``,
    ``mesh=``, ``telemetry=``, a dynamic catalog) are not ported yet and
    raise ``NotImplementedError``.
    """

    def __init__(self, sampler: NDPPSampler, n_slots: int = 8,
                 n_spec: Optional[int] = None, backend: str = "rejection",
                 mesh=None, telemetry=None):
        if backend == "mcmc":
            raise NotImplementedError(
                "backend='mcmc' is not ported yet (ROADMAP, Queue 1: MCMC)")
        if backend != "rejection":
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported yet (ROADMAP, Queue 1: multi-GPU "
                "sharding)")
        if telemetry is not None:
            raise NotImplementedError(
                "telemetry= is not ported yet (ROADMAP, Queue 1: "
                "observability and the front door)")
        if isinstance(sampler, SpectralNDPP):
            raise ValueError("backend='rejection' needs a preprocessed "
                             "NDPPSampler")
        if not isinstance(sampler, NDPPSampler):
            raise NotImplementedError(
                f"{type(sampler).__name__} is not a static NDPPSampler; "
                f"dynamic catalogs are not ported yet (ROADMAP, Queue 1: "
                f"the dynamic catalog)")
        self.backend = backend
        self.sampler = sampler
        self.sp = sampler.sp
        self.n_slots = n_slots
        self.n_spec = auto_n_spec(sampler) if n_spec is None else n_spec
        self.queue: List[SampleRequest] = []
        self.slot_req: List[Optional[SampleRequest]] = [None] * n_slots
        self.slot_key = np.zeros((n_slots, 2), np.uint32)
        self.slot_trials = np.zeros(n_slots, np.int64)
        self.finished: Dict[int, SampleResult] = {}
        self.ticks = 0

    # ------------------------------------------------------------- frontend
    def submit(self, req: SampleRequest):
        """Queue a request."""
        self.queue.append(req)

    def cancel(self, rid: int) -> bool:
        """Abandon a queued (never admitted) request; True iff ``rid`` was
        waiting in the queue.  In-flight requests always retire normally."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                return True
        return False

    def _admit(self):
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                self.slot_key[slot] = _host_prng_key(req.seed)
                self.slot_trials[slot] = 0

    def _retire(self, slot: int, result: SampleResult):
        req = self.slot_req[slot]
        req.result = result
        self.finished[req.rid] = result
        self.slot_req[slot] = None

    # ----------------------------------------------------------------- core
    def step(self) -> bool:
        """One engine tick: admit from the queue, run one speculative round
        for the whole pool, retire finished slots.  False if idle."""
        return self._step_rejection()

    def _step_rejection(self) -> bool:
        self._admit()
        slots = [s for s in range(self.n_slots) if self.slot_req[s] is not None]
        if not slots:
            return False
        self.ticks += 1
        # one host-to-device copy: key words and trial counts side by side
        host = np.concatenate(
            [self.slot_key.astype(np.int64),
             (self.slot_trials & 0xFFFFFFFF)[:, None]], axis=1)
        dev = torch.from_numpy(host).to(self.sampler.device)
        items, mask, accept = _spec_round_fused(
            self.sampler, dev[:, :2], dev[:, 2], n_spec=self.n_spec)
        self._harvest(slots, items, mask, accept)
        return True

    def _harvest(self, slots: List[int], items, mask, accept):
        """Retire-or-advance the given slots from one round's outputs."""
        r = items.shape[-1]
        # the one device-to-host copy of the tick
        packed = torch.cat([items, mask.long(), accept.long()[:, None]],
                           dim=1).cpu().numpy()
        items_h = packed[:, :r].astype(np.int32).reshape(
            self.n_slots, self.n_spec, r)
        mask_h = packed[:, r:2 * r].astype(bool).reshape(
            self.n_slots, self.n_spec, r)
        acc = packed[:, 2 * r].astype(bool).reshape(self.n_slots, self.n_spec)
        for slot in slots:
            req = self.slot_req[slot]
            # only proposals inside the request's budget count, so trial
            # accounting matches sample_batched_many even when max_trials
            # is not a multiple of n_spec
            remaining = int(req.max_trials - self.slot_trials[slot])
            usable = min(self.n_spec, remaining)
            row = acc[slot, :usable]
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

    def run(self, max_ticks: int = 10_000) -> Dict[int, SampleResult]:
        """Drain the queue; returns {rid: SampleResult} for every retired
        request.  If the tick budget runs out with requests still queued or
        in flight, raises ``TickBudgetExhausted``."""
        for _ in range(max_ticks):
            progressed = self.step()
            if not progressed and not self.queue:
                break
        if self.queue or any(r is not None for r in self.slot_req):
            unfinished = {
                req.rid: {"rid": req.rid, "state": "active", "slot": slot,
                          "trials": int(self.slot_trials[slot])}
                for slot, req in enumerate(self.slot_req) if req is not None}
            queued = [req.rid for req in self.queue]
            raise TickBudgetExhausted(
                f"run(max_ticks={max_ticks}) exhausted the tick budget with "
                f"{len(unfinished)} request(s) still in flight (rids "
                f"{sorted(unfinished)}) and {len(queued)} still queued (rids "
                f"{queued})", unfinished=unfinished, queued=queued)
        return dict(self.finished)

    def stats(self) -> dict:
        """Point-in-time engine snapshot (host only)."""
        return {
            "backend": self.backend,
            "ticks": self.ticks,
            "queue_depth": len(self.queue),
            "in_flight": sum(r is not None for r in self.slot_req),
            "finished": len(self.finished),
        }
