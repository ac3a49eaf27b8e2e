"""Deterministic load for the port's serving front door: virtual clock +
traces (the port's copy of ``tests/_load.py``, over
``repro_torch.serve.scheduler``).

The scheduler never reads ``time.*`` — it calls its injected ``clock``.
``VirtualClock`` exploits that: tests advance time explicitly, so a
recorded arrival trace replays *bit-identically* on any host at any
speed (no sleeps, no wall-clock flake).  ``poisson_trace`` draws a
seeded Poisson-process-style arrival trace (exponential gaps, mixed
priorities/deadlines/pools), and ``replay`` pushes a trace through a
``Scheduler`` with the clock slaved to the arrival stamps: each event is
submitted exactly at its arrival time, the scheduler ticks between
arrivals, and the function returns the terminal ``outcomes``.

This is the serve-replay harness tests/test_torch_frontdoor.py builds
on: the engines key every proposal/step off ``fold_in(PRNGKey(seed), t)``,
so for any fixed trace the retired draws must equal a direct
``SamplerEngine`` submission of the same (rid, seed) set — the trace
machinery here only decides *when* requests arrive, never what they
sample.  It imports nothing of JAX or ``repro``, so the card's tests can
use it too; ``poisson_trace`` draws the arrivals of ``_load.poisson_trace``
for the same seed (``tests/test_torch_frontdoor.py`` holds them equal).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.scheduler import Outcome, Scheduler, ServeRequest


class VirtualClock:
    """Injectable monotonic clock driven by the test, not the host."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.t += dt
        return self.t


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One trace event: submit ``req`` when the clock reaches ``t``."""

    t: float
    req: ServeRequest


def poisson_trace(seed: int, n: int, *, rate: float = 200.0,
                  pools: Sequence[Optional[str]] = (None,),
                  priorities: Sequence[int] = (0,),
                  deadline_frac: float = 0.0,
                  deadline_range: Tuple[float, float] = (0.005, 0.1),
                  rid_base: int = 0,
                  max_trials: int = 256) -> List[Arrival]:
    """Seeded Poisson-ish arrival trace: exponential inter-arrival gaps.

    Args:
      seed: trace seed — same seed, same trace, any host.
      n: number of arrivals.
      rate: mean arrivals per virtual second.
      pools: pool names sampled uniformly per request (None = routed).
      priorities: priority levels sampled uniformly per request.
      deadline_frac: fraction of requests given a deadline, drawn
        uniformly from ``t + deadline_range``.
      rid_base: rids are ``rid_base + i`` (trace order), seeds are
        derived from the trace seed so draws differ per request.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    t = np.cumsum(gaps)
    out = []
    for i in range(n):
        deadline = None
        if deadline_frac > 0 and rng.random() < deadline_frac:
            deadline = float(t[i] + rng.uniform(*deadline_range))
        out.append(Arrival(
            t=float(t[i]),
            req=ServeRequest(
                rid=rid_base + i,
                seed=int(rng.integers(0, 2 ** 31)),
                priority=int(rng.choice(priorities)),
                deadline=deadline,
                pool=pools[int(rng.integers(len(pools)))],
                max_trials=max_trials)))
    return out


def replay(sched: Scheduler, clock: VirtualClock, trace: Sequence[Arrival],
           *, tick_dt: float = 0.002, max_ticks: int = 50_000,
           cancel_at: Optional[Dict[int, float]] = None
           ) -> Dict[int, Outcome]:
    """Drive ``sched`` through ``trace`` on the virtual clock.

    Between arrivals the scheduler ticks every ``tick_dt`` virtual
    seconds; after the last arrival it drains.  ``cancel_at`` maps
    rid → virtual time at which the caller withdraws it (applied at the
    first clock stamp past that time).  Fully deterministic: same
    (sched config, trace, tick_dt) → same admission schedule, and —
    the invariant under test — the *draws* are identical for every
    schedule anyway.
    """
    if clock is not sched.clock:
        raise ValueError("replay needs the scheduler built on this clock")
    cancel_at = dict(cancel_at or {})
    ticks = 0

    def fire_cancels():
        for rid in [r for r, tc in cancel_at.items() if clock.t >= tc]:
            del cancel_at[rid]
            sched.cancel(rid)

    for arr in sorted(trace, key=lambda a: (a.t, a.req.rid)):
        while clock.t + tick_dt <= arr.t:
            clock.advance(tick_dt)
            fire_cancels()
            if sched.busy():
                sched.tick()
                ticks += 1
                if ticks > max_ticks:
                    raise RuntimeError(f"replay exceeded {max_ticks} ticks")
        if arr.t > clock.t:
            clock.advance(arr.t - clock.t)
        fire_cancels()
        sched.submit(arr.req)
    while sched.busy():
        clock.advance(tick_dt)
        fire_cancels()
        sched.tick()
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError(f"replay exceeded {max_ticks} ticks")
    return dict(sched.outcomes)
