"""Admission scheduler: priorities, deadlines, backpressure, multi-pool
(port of ``repro/serve/scheduler.py``).

``SamplerEngine`` is a tick-driven slot pool: callers stage requests into
its FIFO queue and pump ``step()``.  This module adds the admission path
in front of one or more such pools:

  * a single **bounded priority queue** feeds every pool: requests carry
    ``(priority, deadline)`` and are admitted highest-priority-first
    (earliest deadline, then FIFO, break ties);
  * **continuous batching** — at the start of every scheduler tick each
    pool's free slots (including the ones freed by the previous tick's
    retires) are refilled from the queue before the pool advances, so an
    engine never runs a tick with an empty slot while work is waiting;
  * **backpressure** — the queue is bounded; a full queue sheds the new
    request (``on_full="reject"``) or evicts the worst queued one
    (``on_full="evict"``), and a request whose deadline has passed is
    shed at its admission turn instead of occupying a slot.  Every shed
    emits a flight-recorder event and terminates the request's span in
    the ``shed`` state.  A request evicted at ``submit`` is reported in
    the next ``TickReport.shed`` beside that tick's deadline sheds (the
    reference reports it only in ``outcomes``, so its front door never
    answers an evicted caller);
  * **multi-pool** — one scheduler (and one front-door pump task) drives
    any mix of pools: rejection and MCMC backends, static samplers and
    dynamic catalogs (each pool keeps pinning catalog versions per slot
    exactly as before).  A request may target a pool by name or let the
    scheduler route it to the freest pool.

Scheduling invariance (what tests/test_torch_frontdoor.py pins): the
scheduler decides only *when* a request reaches an engine, never what it
samples — proposal/step ``t`` of request ``rid`` is always
``fold_in(PRNGKey(seed), t)`` inside the engines, so for any admission
order the retired draws are bit-identical to submitting the same
``(rid, seed)`` set directly to ``SamplerEngine``, and each rid's
``Outcome`` equals the reference scheduler's on the same trace.  The scheduler's entire correctness burden is
bookkeeping: no request lost or double-retired, priority order respected
at each admission instant, sheds always terminal.

Clocks: the scheduler never reads ``time.*`` directly — deadlines and
queue waits use the injected ``clock`` (default ``repro_torch.obs.now``),
so tests drive a virtual clock and replay traces deterministically.

Telemetry: pass the same ``repro_torch.obs.Telemetry`` the pools were
built with.  The scheduler opens each request's span at *its* submission point
and hands it down to the engine at staging, so the engine's
submit→admit/submit→retire histograms measure the true front-door wait;
scheduler-level decisions (shed, evict, autoscale) stream into its own
``ndpp_sched_*`` instruments in the same registry.  When telemetry is
enabled, the queue-wait p99 over a sliding window can drive the
rejection pools' speculation depth (``autoscale_n_spec=True``): n_spec
doubles while waits exceed ``target_queue_wait`` and halves when the
queue runs far ahead of it — power-of-two steps only, so rounds keep a
handful of constant widths (what CUDA graphs of the round will need).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..obs import LogHistogram, MetricRegistry, Span, Telemetry
from ..obs import now as _obs_now
from .sampler_engine import (
    SampleRequest,
    SampleResult,
    SamplerEngine,
    TickBudgetExhausted,
)

SHED_REASONS = ("deadline", "queue_full", "evicted")


class DuplicateRid(ValueError):
    """A rid already known to the scheduler was submitted again."""


@dataclasses.dataclass
class ServeRequest:
    """One front-door request.

    Attributes:
      rid: caller-chosen id, unique across the scheduler's lifetime.
      seed: PRNG seed — fully determines the draw (see module docstring).
      priority: higher is served first (any int; default 0).
      deadline: absolute scheduler-clock time (seconds) after which the
        request is shed instead of admitted; None = never expires.
      pool: target pool name, or None to let the scheduler route to the
        pool with the most free capacity.
      max_trials: rejection proposal budget (ignored by MCMC pools).
    """

    rid: int
    seed: int = 0
    priority: int = 0
    deadline: Optional[float] = None
    pool: Optional[str] = None
    max_trials: int = 256
    # stamped by the scheduler at submit:
    t_submit: float = 0.0
    seq: int = -1

    def order_key(self) -> Tuple[float, float, int]:
        """Heap key: highest priority, then earliest deadline, then FIFO."""
        return (-self.priority,
                self.deadline if self.deadline is not None else math.inf,
                self.seq)


@dataclasses.dataclass
class Outcome:
    """Terminal record of one request: exactly one per submitted rid.

    ``status`` is ``"done"`` (retired with a draw), ``"shed"`` (dropped
    by the scheduler; ``reason`` says why), or ``"cancelled"`` (withdrawn
    by the caller).
    """

    rid: int
    status: str
    pool: Optional[str] = None
    result: Optional[SampleResult] = None
    reason: Optional[str] = None


@dataclasses.dataclass
class TickReport:
    """What one scheduler tick did (the front-door pump consumes this)."""

    tick: int
    admitted: List[Tuple[int, str]]           # (rid, pool) staged this tick
    retired: Dict[int, SampleResult]
    shed: List[Outcome]                       # this tick's deadline sheds
                                              # after the evictions since
                                              # the tick before
    progressed: bool                          # any engine advanced


def sched_instruments(registry: MetricRegistry):
    """Scheduler instrument set (idempotent, same registry as the pools)."""
    import types

    c, g, h = registry.counter, registry.gauge, registry.histogram
    return types.SimpleNamespace(
        submitted=c("ndpp_sched_submitted_total",
                    "requests submitted to the front door"),
        admitted=c("ndpp_sched_admitted_total",
                   "requests staged into an engine pool", ("pool",)),
        shed=c("ndpp_sched_shed_total",
               "requests shed by the scheduler (deadline expiry, "
               "queue-full rejection, or eviction)", ("reason",)),
        cancelled=c("ndpp_sched_cancelled_total",
                    "queued requests withdrawn by the caller"),
        queue_depth=g("ndpp_sched_queue_depth",
                      "requests waiting in the admission queue"),
        n_spec=g("ndpp_sched_n_spec",
                 "current speculation depth of a rejection pool",
                 ("pool",)),
        queue_wait=h("ndpp_sched_queue_wait_seconds",
                     "scheduler-clock seconds from submit to staging "
                     "(admitted requests only — sheds never pollute this)",
                     start=1e-5, factor=2 ** 0.25),
    )


class Scheduler:
    """Bounded-priority-queue admission scheduler over engine pools.

    Args:
      pools: ``{name: SamplerEngine}`` — the pools one pump drives.  For
        front-door latency accounting and shed spans, build the engines
        with the same ``Telemetry`` passed here.
      max_queue: admission-queue bound (backpressure surface).
      on_full: what a submit against a full queue does — ``"reject"``
        sheds the *new* request (reason ``queue_full``); ``"evict"``
        sheds the *worst* queued request instead if the new one outranks
        it (reason ``evicted``), else sheds the new one.
      clock: monotonic-seconds callable used for deadlines and queue
        waits (default ``repro_torch.obs.now``; tests inject a virtual
        clock).
      telemetry: shared ``repro_torch.obs.Telemetry`` (spans,
        ``ndpp_sched_*`` metrics, flight events).  Defaults to the first
        pool's.
      autoscale_n_spec: let queue-wait p99 drive rejection-pool
        speculation depth (power-of-two steps in
        ``[n_spec_min, n_spec_max]``, evaluated every
        ``autoscale_every`` ticks over a sliding window).  Requires
        telemetry.  Off by default: every distinct n_spec is a new round
        width, and latency-critical deployments may prefer one width.
      target_queue_wait: autoscale SLO knob — p99 queue wait (seconds)
        above which n_spec doubles (halves below a 1/8 of it).
    """

    def __init__(self, pools: Dict[str, SamplerEngine], *,
                 max_queue: int = 1024, on_full: str = "reject",
                 clock: Callable[[], float] = _obs_now,
                 telemetry: Optional[Telemetry] = None,
                 autoscale_n_spec: bool = False,
                 target_queue_wait: float = 0.1,
                 autoscale_every: int = 16,
                 n_spec_min: int = 1, n_spec_max: int = 256):
        if not pools:
            raise ValueError("need at least one engine pool")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if on_full not in ("reject", "evict"):
            raise ValueError(f"unknown on_full policy {on_full!r}")
        self.pools = dict(pools)
        self._pool_names = sorted(self.pools)
        self.max_queue = max_queue
        self.on_full = on_full
        self.clock = clock
        self._tel = telemetry
        if self._tel is None:
            self._tel = next((e._tel for e in self.pools.values()
                              if e._tel is not None), None)
        self.autoscale = autoscale_n_spec
        self.target_queue_wait = target_queue_wait
        self.autoscale_every = autoscale_every
        self.n_spec_min, self.n_spec_max = n_spec_min, n_spec_max
        if self.autoscale and self._tel is None:
            raise ValueError("autoscale_n_spec needs telemetry (the "
                             "decision input is the queue-wait histogram)")
        self._heap: List[Tuple[Tuple[float, float, int], ServeRequest]] = []
        self._seq = 0
        self._n_queued = 0
        # rid -> "queued" | "inflight" | "done" | "shed" | "cancelled"
        self._known: Dict[int, str] = {}
        self._inflight: Dict[str, Set[int]] = {n: set() for n in self.pools}
        self.outcomes: Dict[int, Outcome] = {}
        self.spans: Dict[int, Span] = {}
        # evictions made by submit(), handed to the next TickReport
        self._evicted: List[Outcome] = []
        self.ticks = 0
        # sliding autoscale window on the same lattice as the registry
        # histogram; reset after every autoscale evaluation
        self._win = LogHistogram(start=1e-5, factor=2 ** 0.25)
        if self._tel is not None:
            self._m = sched_instruments(self._tel.registry)
            for name, eng in sorted(self.pools.items()):
                if eng.backend == "rejection":
                    self._m.n_spec.set(eng.n_spec, pool=name)
            self._tel.flight.record(
                "sched_start", pools={n: e.backend
                                      for n, e in sorted(self.pools.items())},
                max_queue=max_queue, on_full=on_full,
                autoscale=self.autoscale)

    # ------------------------------------------------------------- frontend
    def submit(self, req: ServeRequest) -> bool:
        """Enqueue a request; returns False iff it was shed immediately
        by queue-full backpressure (its ``Outcome`` is still recorded —
        every submitted rid ends in exactly one terminal state)."""
        if req.rid in self._known:
            raise DuplicateRid(
                f"rid {req.rid} already {self._known[req.rid]} — rids must "
                f"be unique for the scheduler's lifetime")
        if req.pool is not None and req.pool not in self.pools:
            raise ValueError(f"unknown pool {req.pool!r}; have "
                             f"{self._pool_names}")
        req.t_submit = self.clock()
        req.seq = self._seq
        self._seq += 1
        if self._tel is not None:
            backend = (self.pools[req.pool].backend
                       if req.pool is not None else "auto")
            self.spans[req.rid] = Span(rid=req.rid, seed=req.seed,
                                       backend=backend)
            self._m.submitted.inc()
            self._tel.flight.record(
                "sched_submit", rid=req.rid, seed=req.seed,
                priority=req.priority, deadline=req.deadline, pool=req.pool)
        if self._n_queued >= self.max_queue:
            victim = req
            if self.on_full == "evict":
                worst = self._worst_queued()
                if worst is not None and req.order_key() < worst.order_key():
                    self._evicted.append(self._shed(worst, "evicted"))
                    victim = None
            if victim is not None:
                self._shed(req, "queue_full", dequeue=False)
                return False
        self._known[req.rid] = "queued"
        self._n_queued += 1
        heapq.heappush(self._heap, (req.order_key(), req))
        if self._tel is not None:
            self._m.queue_depth.set(self._n_queued)
        return True

    def cancel(self, rid: int) -> bool:
        """Withdraw a still-queued request.  Returns False for rids that
        are in flight, finished, or unknown — a request that reached a
        slot always retires normally."""
        if self._known.get(rid) != "queued":
            return False
        self._known[rid] = "cancelled"
        self._n_queued -= 1          # heap entry is skipped lazily
        self.outcomes[rid] = Outcome(rid=rid, status="cancelled")
        if self._tel is not None:
            span = self.spans.get(rid)
            if span is not None:
                span.abandon("cancelled")
            self._m.cancelled.inc()
            self._m.queue_depth.set(self._n_queued)
            self._tel.flight.record("sched_cancel", rid=rid)
        return True

    def swap_catalog(self, pool: str, cat) -> None:
        """Install a new catalog version on one pool between ticks (the
        engine's zero-drain semantics are unchanged)."""
        self.pools[pool].swap_catalog(cat)

    # ----------------------------------------------------------------- core
    def tick(self) -> TickReport:
        """One scheduler tick: shed/admit from the priority queue into
        every pool's free slots, then advance every active pool one
        engine tick and collect its retires."""
        t_now = self.clock()
        self.ticks += 1
        shed, self._evicted = self._evicted, []
        admitted: List[Tuple[int, str]] = []
        free = {}
        for name in self._pool_names:
            eng = self.pools[name]
            free[name] = (sum(r is None for r in eng.slot_req)
                          - len(eng.queue))
        # admission: pop best-first; expired requests shed at their turn,
        # requests for a full specific pool are held back for this tick
        holdback = []
        while self._heap and any(f > 0 for f in free.values()):
            key, req = heapq.heappop(self._heap)
            if self._known.get(req.rid) != "queued":
                continue  # cancelled while queued — entry removed lazily
            if req.deadline is not None and t_now > req.deadline:
                shed.append(self._shed(req, "deadline"))
                continue
            name = self._route(req, free)
            if name is None:
                holdback.append((key, req))
                continue
            free[name] -= 1
            admitted.append((req.rid, name))
            self._stage(req, name, t_now)
        for entry in holdback:
            heapq.heappush(self._heap, entry)
        # advance: every pool with work steps once; slots freed by these
        # retires are refilled at the next tick's admission phase
        retired: Dict[int, SampleResult] = {}
        progressed = False
        for name in self._pool_names:
            eng = self.pools[name]
            if not (eng.queue or any(r is not None for r in eng.slot_req)):
                continue
            progressed = eng.step() or progressed
            inflight = self._inflight[name]
            for rid in [r for r in inflight if r in eng.finished]:
                inflight.discard(rid)
                res = eng.finished[rid]
                retired[rid] = res
                self._known[rid] = "done"
                self.outcomes[rid] = Outcome(rid=rid, status="done",
                                             pool=name, result=res)
        if self._tel is not None:
            self._m.queue_depth.set(self._n_queued)
            if self.autoscale and self.ticks % self.autoscale_every == 0:
                self._autoscale()
        return TickReport(tick=self.ticks, admitted=admitted,
                          retired=retired, shed=shed, progressed=progressed)

    def busy(self) -> bool:
        """True while anything is queued or holds a slot."""
        return self._n_queued > 0 or any(self._inflight.values())

    def run(self, max_ticks: int = 10_000) -> Dict[int, Outcome]:
        """Drain synchronously (the front door pumps ``tick()`` itself);
        returns ``outcomes``.  Raises ``TickBudgetExhausted`` like the
        engine's ``run`` if the budget ends with work outstanding."""
        for _ in range(max_ticks):
            if not self.busy():
                break
            self.tick()
        if self.busy():
            unfinished = {
                rid: (self.spans[rid].snapshot() if rid in self.spans
                      else {"rid": rid, "state": self._known.get(rid)})
                for name in self._pool_names
                for rid in sorted(self._inflight[name])}
            queued = sorted(r for r, s in self._known.items()
                            if s == "queued")
            if self._tel is not None:
                self._tel.flight.record(
                    "tick_budget_exhausted", max_ticks=max_ticks,
                    in_flight=sorted(unfinished), queued=queued)
                self._tel.on_error()
            raise TickBudgetExhausted(
                f"scheduler.run(max_ticks={max_ticks}) exhausted with "
                f"{len(unfinished)} in flight and {len(queued)} queued",
                unfinished=unfinished, queued=queued)
        return dict(self.outcomes)

    # -------------------------------------------------------------- internals
    def _route(self, req: ServeRequest, free: Dict[str, int]) \
            -> Optional[str]:
        if req.pool is not None:
            return req.pool if free[req.pool] > 0 else None
        # freest pool, name-sorted tiebreak — deterministic for replay
        best = max(self._pool_names, key=lambda n: (free[n], n))
        return best if free[best] > 0 else None

    def _stage(self, req: ServeRequest, name: str, t_now: float) -> None:
        eng = self.pools[name]
        span = self.spans.get(req.rid)
        if span is not None:
            span.backend = eng.backend
        eng.submit(SampleRequest(rid=req.rid, seed=req.seed,
                                 max_trials=req.max_trials), span=span)
        self._known[req.rid] = "inflight"
        self._inflight[name].add(req.rid)
        self._n_queued -= 1
        if self._tel is not None:
            wait = t_now - req.t_submit
            self._m.admitted.inc(pool=name)
            self._m.queue_wait.observe(wait)
            self._win.observe(wait)
            self._tel.flight.record(
                "sched_admit", rid=req.rid, pool=name, tick=self.ticks,
                priority=req.priority, queue_wait_s=round(wait, 9))

    def _shed(self, req: ServeRequest, reason: str, *,
              dequeue: bool = True) -> Outcome:
        assert reason in SHED_REASONS, reason
        self._known[req.rid] = "shed"
        if dequeue:
            self._n_queued -= 1      # any heap entry is skipped lazily
        out = Outcome(rid=req.rid, status="shed", reason=reason)
        self.outcomes[req.rid] = out
        if self._tel is not None:
            span = self.spans.get(req.rid)
            if span is not None and span.state == "queued":
                span.abandon("shed")
            self._m.shed.inc(reason=reason)
            self._m.queue_depth.set(self._n_queued)
            self._tel.flight.record(
                "sched_shed", rid=req.rid, reason=reason,
                priority=req.priority, deadline=req.deadline,
                tick=self.ticks)
        return out

    def _worst_queued(self) -> Optional[ServeRequest]:
        worst = None
        for key, req in self._heap:
            if self._known.get(req.rid) != "queued":
                continue
            if worst is None or key > worst.order_key():
                worst = req
        return worst

    def _autoscale(self) -> None:
        """Queue-wait p99 drives rejection-pool speculation depth.

        Doubling n_spec halves the expected ticks-to-accept of a
        rejection request (more proposals per tick), at the cost of a
        wider per-tick batch; when the p99 wait over the last window
        clears ``target_queue_wait`` the scheduler buys latency with
        compute, and when the queue runs far ahead it gives the compute
        back.  Power-of-two steps bound the number of round widths.
        """
        if self._win.count == 0:
            return
        p99 = self._win.percentile(99)
        self._win = LogHistogram(start=1e-5, factor=2 ** 0.25)
        for name in self._pool_names:
            eng = self.pools[name]
            if eng.backend != "rejection":
                continue
            old = eng.n_spec
            if p99 > self.target_queue_wait:
                eng.n_spec = min(self.n_spec_max, old * 2)
            elif p99 < self.target_queue_wait / 8:
                eng.n_spec = max(self.n_spec_min, old // 2)
            if eng.n_spec != old:
                self._m.n_spec.set(eng.n_spec, pool=name)
                self._tel.flight.record(
                    "n_spec_resize", pool=name, old=old, new=eng.n_spec,
                    queue_wait_p99_s=round(p99, 9), tick=self.ticks)

    # ------------------------------------------------------------ telemetry
    def stats(self) -> dict:
        """Point-in-time scheduler snapshot (host-only, cheap)."""
        by_status: Dict[str, int] = {}
        for s in self._known.values():
            by_status[s] = by_status.get(s, 0) + 1
        return {
            "ticks": self.ticks,
            "queued": self._n_queued,
            "in_flight": {n: len(s) for n, s in self._inflight.items()},
            "requests": by_status,
            "pools": {n: {"backend": e.backend,
                          "n_spec": getattr(e, "n_spec", None)}
                      for n, e in sorted(self.pools.items())},
        }
