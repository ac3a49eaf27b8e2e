"""The engine phase catalog: the names the profiler ranges use (port of
``repro/obs/prof/phases.py``, its host phases only).

**Host phases** (``HOST_PHASES``) are ``torch.profiler.record_function``
ranges that host code opens around sections of an engine tick.  They
exist only under ``NDPP_PROFILE=1`` (``repro_torch.obs.trace.
phase_annotation``) and appear in a captured trace as
``ndpp_phase/<name>``:

  ``admission``       queue → slot assignment, host-side key builds
  ``round_dispatch``  handing one speculative round (or MCMC chain
                      advance) to the device: the kernel launches and
                      the torch operations around them
  ``harvest``         the tick's one device-to-host copy that brings the
                      round's outputs to the host: the only phase in which
                      waiting on the device is sanctioned

The reference's device scopes (``DEVICE_SCOPES``: ``jax.named_scope``
regions inside its compiled hot paths, such as ``ndpp.tree_descent``) are
not mapped in the port yet: the port's rounds are eager torch operations
and hand-written kernels, and their counterpart (ranges or NVTX marks
inside the round, with a trace parser that attributes device time to
them) goes with the rest of ``obs/prof/`` (``ROADMAP.md``, Queue 1 item
5b).
"""
from __future__ import annotations

# host phases ---------------------------------------------------------------
ADMISSION = "admission"
ROUND_DISPATCH = "round_dispatch"
HARVEST = "harvest"

HOST_PHASES = {
    ADMISSION: "queue drain into free slots (host-only key builds)",
    ROUND_DISPATCH: "round or chain dispatch for the whole pool",
    HARVEST: "the tick's one device-to-host copy",
}

#: host phases inside which a blocking device read is sanctioned
BLOCKING_ALLOWED = frozenset({HARVEST})
