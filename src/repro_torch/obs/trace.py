"""Profiler ranges, gated by an environment flag (port of
``repro/obs/trace.py``).

``NDPP_PROFILE=1`` makes the engine wrap every tick, and every named
phase inside a tick (``obs/prof/phases.py``), in a
``torch.profiler.record_function`` range, so tick and phase boundaries
show up by name in a ``torch.profiler`` trace.  With the flag unset (the
default) the context managers are one shared no-op object: nothing a
tick, and no profiler import.

This module is the one place the port opens a ``record_function`` range
for the engine: every range goes through the same gate, so an always-on
range cannot leak profiler overhead into production ticks.
"""
from __future__ import annotations

import contextlib
import os

PROFILE_ENV = "NDPP_PROFILE"

#: prefix under which engine phase ranges appear in captured traces
PHASE_PREFIX = "ndpp_phase/"


def profiling_enabled() -> bool:
    """True iff ``NDPP_PROFILE=1`` in the environment."""
    return os.environ.get(PROFILE_ENV, "") == "1"


class _NullContext(contextlib.AbstractContextManager):
    """Reusable no-op context (cheaper than nullcontext() per tick)."""

    def __exit__(self, *exc):
        return False


_NULL = _NullContext()


def annotation(name: str, enabled: bool):
    """The gated ``record_function`` constructor (see the module doc).

    ``enabled`` is resolved once by the caller (from
    ``profiling_enabled()`` at construction), not per call: the disabled
    path returns the shared no-op context and never imports the profiler.
    """
    if not enabled:
        return _NULL
    from torch.profiler import record_function

    return record_function(name)


def tick_annotation(name: str, enabled: bool):
    """A context manager naming one engine tick for the profiler."""
    return annotation(name, enabled)


def phase_annotation(name: str, enabled: bool):
    """A context manager naming one engine phase (``ndpp_phase/<name>``),
    its name from ``repro_torch.obs.prof.phases``."""
    if not enabled:
        return _NULL
    return annotation(PHASE_PREFIX + name, True)
