"""Performance observatory of the port: for now only the phase catalog
(``phases``).  The reference's capture and parse of traces, dispatch and
transfer accounting, cost model and bench schema (``repro/obs/prof/``)
go with the port's bench (``ROADMAP.md``, Queue 1 item 5b)."""
from __future__ import annotations

from . import phases

__all__ = ["phases"]
