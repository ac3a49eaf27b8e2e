"""Runtime telemetry for the port's serving stack (port of
``repro/obs/__init__.py``).

``repro_torch.obs`` is the one place the port reads clocks and
accumulates runtime statistics.  Its contract:

  * **host-only**: metrics, spans and the flight recorder are plain
    Python state; recording never builds a tensor and never copies from
    the device;
  * **free**: the engine records only from values that its tick's one
    device-to-host copy already brought to the host, so an instrumented
    engine draws the same items with the same copies and launches
    (``tests/test_torch_obs.py``; ``chip_smoke.py``'s ``serve`` phase
    counts both with the profiler on the card);
  * **paper-aligned**: ``ndpp_request_trials`` against Theorem 2's
    bound, per-round acceptance (``ndpp_accepts_total /
    ndpp_proposals_total``), MCMC acceptance fractions.

The instrument names, labels and histogram lattices are the reference's,
so one dashboard reads both.  The reference's ``ndpp_compiles_total``,
``ndpp_dispatches_total`` and ``ndpp_transfer_bytes_total`` are left out
until the port counts them (the accounting of ``obs/prof``): an
instrument that is exposed but never counted would read as zero.  ``Telemetry`` bundles a ``MetricRegistry``,
a ``FlightRecorder`` and the profiler gate for the engine;
``RegistryObserver`` adapts the same registry to the duck-typed observer
hooks of the batch samplers.
"""
from __future__ import annotations

import types
from typing import Optional

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    LogHistogram,
    MetricRegistry,
)
from .recorder import FlightRecorder
from .spans import Span, now
from .trace import (
    PHASE_PREFIX,
    PROFILE_ENV,
    phase_annotation,
    profiling_enabled,
    tick_annotation,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "LogHistogram", "MetricRegistry",
    "FlightRecorder", "Span", "now", "Telemetry", "RegistryObserver",
    "engine_instruments", "PROFILE_ENV", "PHASE_PREFIX",
    "profiling_enabled", "tick_annotation", "phase_annotation",
]


def engine_instruments(registry: MetricRegistry) -> types.SimpleNamespace:
    """Declare the engine's instrument set on ``registry`` (idempotent).

    Shared by ``SamplerEngine`` and ``RegistryObserver`` so the batch
    samplers and the serving engine stream into the same metric names.
    Histogram lattices: latencies use quarter-octave buckets (factor
    2^0.25, ≤19% relative error); trial counts use half-octave buckets
    starting at 1 — Theorem 2 bounds E[trials] by 2^(K/2), i.e. exactly
    K buckets of headroom.
    """
    c, g, h = registry.counter, registry.gauge, registry.histogram
    t = dict(start=1e-5, factor=2 ** 0.25)
    return types.SimpleNamespace(
        submitted=c("ndpp_requests_submitted_total",
                    "requests submitted to the engine", ("backend",)),
        retired=c("ndpp_requests_retired_total",
                  "requests retired, by acceptance",
                  ("backend", "accepted")),
        abandoned=c("ndpp_requests_abandoned_total",
                    "queued requests dropped before admission "
                    "(outcome: shed | cancelled) — these never reach the "
                    "queue-wait or latency histograms",
                    ("backend", "outcome")),
        ticks=c("ndpp_ticks_total", "engine ticks that advanced the pool",
                ("backend",)),
        rounds=c("ndpp_spec_rounds_total",
                 "speculative rejection rounds executed", ("backend",)),
        proposals=c("ndpp_proposals_total",
                    "proposals scored (rejection) / MH steps taken (mcmc)",
                    ("backend",)),
        accepts=c("ndpp_accepts_total",
                  "proposals accepted (rejection) / MH moves accepted "
                  "(mcmc)", ("backend",)),
        trials_total=c("ndpp_trials_total",
                       "trials consumed by retired requests — the "
                       "numerator of measured E[trials]", ("backend",)),
        swaps=c("ndpp_catalog_swaps_total",
                "catalog versions installed via swap_catalog"),
        mcmc_steps=c("ndpp_mcmc_steps_total",
                     "MH steps advanced across all chains"),
        queue_depth=g("ndpp_queue_depth", "requests waiting for a slot"),
        slots_occupied=g("ndpp_slots_occupied",
                         "slots holding an in-flight request"),
        catalog_version=g("ndpp_catalog_version",
                          "catalog version the engine currently serves"),
        latency=h("ndpp_request_latency_seconds",
                  "submit→retire wall seconds", ("backend",), **t),
        queue_wait=h("ndpp_queue_wait_seconds",
                     "submit→admit wall seconds", ("backend",), **t),
        tick_seconds=h("ndpp_tick_seconds",
                       "wall seconds per engine tick", ("backend",), **t),
        request_trials=h("ndpp_request_trials",
                         "trials-to-accept per accepted request (mean of "
                         "this is measured E[trials]; Theorem 2 bounds it "
                         "by 2^(K/2) for ONDPP kernels)", ("backend",),
                         start=1.0, factor=2 ** 0.5),
        ticks_held=h("ndpp_request_ticks_held",
                     "engine ticks a request occupied a slot",
                     ("backend",), start=1.0, factor=2.0),
        mcmc_accept=h("ndpp_mcmc_accept_fraction",
                      "per-sync MH acceptance fraction across occupied "
                      "chains", (), start=1e-3, factor=2 ** 0.25),
    )


class Telemetry:
    """Engine-facing bundle: registry + flight recorder + profiler gate.

    Args:
      registry: share one across engines, or default to a fresh one.
      flight: flight recorder (default: fresh, ``flight_capacity`` events).
      dump_on_error: path the flight recorder is dumped to (JSONL) when
        the engine hits an error path (e.g. tick-budget exhaustion).
      profile: wrap tick dispatch in ``torch.profiler.record_function``
        ranges; default reads ``NDPP_PROFILE=1`` once at construction.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 flight: Optional[FlightRecorder] = None,
                 flight_capacity: int = 1024,
                 dump_on_error: Optional[str] = None,
                 profile: Optional[bool] = None):
        self.registry = MetricRegistry() if registry is None else registry
        self.flight = (FlightRecorder(flight_capacity) if flight is None
                       else flight)
        self.dump_on_error = dump_on_error
        self.profile = (profiling_enabled() if profile is None
                        else bool(profile))

    # host clock, re-exported so engine code never imports ``time``
    now = staticmethod(now)

    def profile_tick(self, name: str):
        return tick_annotation(name, self.profile)

    def phase(self, name: str):
        """Profiler scope for one engine phase (``ndpp_phase/<name>``).

        Phase names come from ``repro_torch.obs.prof.phases``; a no-op unless
        profiling was enabled at construction.
        """
        return phase_annotation(name, self.profile)

    def on_error(self) -> Optional[str]:
        """Dump the flight recorder to ``dump_on_error`` (if configured)."""
        if self.dump_on_error is None:
            return None
        self.flight.dump(self.dump_on_error)
        return self.dump_on_error


class RegistryObserver:
    """Duck-typed observer feeding batch-sampler stats into a registry.

    The batch samplers (``core.rejection.drive_rounds``,
    ``core.dynamic.sample_dynamic_many``, ``core.mcmc.sample_mcmc``)
    accept an ``observer`` and call these hooks with plain Python numbers
    they already hold after their round's one device-to-host copy:
    ``core`` imports nothing of ``repro_torch.obs``, and the hooks never
    see a tensor.
    """

    def __init__(self, registry: MetricRegistry, backend: str = "rejection"):
        self.registry = registry
        self.backend = backend
        self._m = engine_instruments(registry)
        self._profile = profiling_enabled()

    def phase(self, name: str):
        """Profiler scope around a sampler phase (``drive_rounds`` uses
        this duck-typed hook for its round-dispatch/harvest sections)."""
        return phase_annotation(name, self._profile)

    def on_round(self, *, n_active: int, n_spec: int, proposals: int,
                 accepts: int) -> None:
        """One speculative round: pool size, fan-out, outcome counts."""
        self._m.rounds.inc(backend=self.backend)
        self._m.proposals.inc(proposals, backend=self.backend)
        self._m.accepts.inc(accepts, backend=self.backend)

    def on_retire(self, *, trials: int, accepted: bool) -> None:
        """One request leaving the pending set (accepted or exhausted)."""
        self._m.retired.inc(backend=self.backend,
                            accepted="true" if accepted else "false")
        self._m.trials_total.inc(trials, backend=self.backend)
        if accepted:
            self._m.request_trials.observe(trials, backend=self.backend)

    def on_mcmc(self, *, steps: int, n_chains: int,
                accept_fraction: float) -> None:
        """One MCMC run: total MH steps and mean acceptance fraction."""
        self._m.mcmc_steps.inc(steps)
        self._m.proposals.inc(steps, backend="mcmc")
        self._m.accepts.inc(steps * accept_fraction, backend="mcmc")
        self._m.mcmc_accept.observe(accept_fraction)
