"""Per-request span lifecycle: submit → admit → per-tick occupancy → retire
(port of ``repro/obs/spans.py``).

A ``Span`` is the host-side record of one request's trip through the
serving engine.  It owns its own ``time.perf_counter`` stamps: the
engine and the scheduler never read a clock themselves (``serve/`` and
``core/`` hold no ``time.*`` call, which the repository's lint enforces);
the engine calls ``admit()``/``retire()`` where it is already on the host
and bumps the occupancy counters (``ticks_held``, ``rounds``,
``proposals``, ``chain_steps``) from Python ints it already holds.  No
span operation touches a tensor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional


def now() -> float:
    """The one clock the serving path uses (monotonic seconds).

    Kept here so that engine and scheduler code holds no ``time.*`` call:
    they call this (through ``Telemetry.now`` or an injected clock)."""
    return time.perf_counter()


@dataclasses.dataclass
class Span:
    """Lifecycle record for one engine request.

    States: ``queued`` (constructed at submit) → ``active`` (``admit``) →
    ``retired`` (``retire``); a request abandoned before admission ends
    ``shed`` (the scheduler dropped it: deadline expiry or queue-full
    backpressure) or ``cancelled`` (the caller withdrew it) through
    ``abandon()``.  Abandoned spans never pass through ``admit``, so the
    queue-wait and latency histograms, which observe only at admit and
    retire, never see a request that was not served.  Timestamps are
    monotonic host seconds.
    """

    TERMINAL_ABANDONED = ("shed", "cancelled")

    rid: int
    seed: int
    backend: str
    t_submit: float = dataclasses.field(default_factory=lambda: now())
    t_admit: Optional[float] = None
    t_retire: Optional[float] = None
    slot: Optional[int] = None
    pinned_version: Optional[int] = None
    state: str = "queued"
    ticks_held: int = 0       # engine ticks this request occupied a slot
    rounds: int = 0           # speculative rounds participated in (rejection)
    proposals: int = 0        # proposals scored within budget (rejection)
    chain_steps: int = 0      # MH steps advanced (mcmc)
    trials: Optional[int] = None
    accepted: Optional[bool] = None

    # ------------------------------------------------------------ transitions
    def admit(self, slot: int, version: Optional[int] = None) -> None:
        self.t_admit = now()
        self.slot = slot
        self.pinned_version = version
        self.state = "active"

    def retire(self, trials: int, accepted: bool) -> None:
        self.t_retire = now()
        self.trials = int(trials)
        self.accepted = bool(accepted)
        self.state = "retired"

    def abandon(self, outcome: str = "cancelled") -> None:
        """Terminal state of a request dropped before admission:
        ``"shed"`` (by the scheduler) or ``"cancelled"`` (by the caller).
        Only a queued request can be abandoned; an admitted one always
        retires."""
        if outcome not in self.TERMINAL_ABANDONED:
            raise ValueError(
                f"abandon outcome must be one of {self.TERMINAL_ABANDONED}, "
                f"got {outcome!r}")
        if self.state != "queued":
            raise ValueError(
                f"only queued requests can be abandoned; rid={self.rid} "
                f"is {self.state!r}")
        self.t_retire = now()
        self.state = outcome

    # -------------------------------------------------------------- durations
    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds from submit to admit (None while queued)."""
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def service_time(self) -> Optional[float]:
        """Seconds from admit to retire (None until retired)."""
        if self.t_admit is None or self.t_retire is None:
            return None
        return self.t_retire - self.t_admit

    @property
    def wall(self) -> Optional[float]:
        """End-to-end seconds from submit to retire (None until retired)."""
        if self.t_retire is None:
            return None
        return self.t_retire - self.t_submit

    def snapshot(self) -> dict:
        """JSON-safe state dump (flight-recorder events, error messages)."""
        return {
            "rid": self.rid,
            "seed": self.seed,
            "backend": self.backend,
            "state": self.state,
            "slot": self.slot,
            "pinned_version": self.pinned_version,
            "ticks_held": self.ticks_held,
            "rounds": self.rounds,
            "proposals": self.proposals,
            "chain_steps": self.chain_steps,
            "trials": self.trials,
            "accepted": self.accepted,
            "queue_wait_s": self.queue_wait,
            "wall_s": self.wall,
        }
