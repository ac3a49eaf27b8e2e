"""Flight recorder: a bounded ring buffer of recent engine events (port of
``repro/obs/recorder.py``).

Every record is a small JSON-safe dict (event name, the caller's fields,
host timestamps); the buffer keeps the last ``capacity`` of them, so a
long-running engine carries a constant-memory trace of its recent
history (span transitions, catalog swaps, sheds) that can be dumped as
JSONL on demand or when something goes wrong (``run()``'s tick budget
dumps it before raising).

Timestamps: ``t`` is monotonic seconds since the recorder was built
(orders events, survives clock steps), ``ts`` is unix wall time (lines
up with outside logs).  Recording never touches a tensor.
"""
from __future__ import annotations

import collections
import json
import time
from typing import Iterator, List, Optional


def _json_default(obj):
    """Demote stray numpy (or 0-d tensor) scalars and arrays to Python
    types."""
    item = getattr(obj, "item", None)
    if callable(item) and getattr(obj, "ndim", None) in (0, None):
        return obj.item()
    tolist = getattr(obj, "tolist", None)
    if callable(tolist):
        return obj.tolist()
    return str(obj)


class FlightRecorder:
    """Bounded in-memory event log with JSONL export."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf = collections.deque(maxlen=capacity)
        self._seq = 0
        self._t0 = time.perf_counter()

    def record(self, event: str, **fields) -> dict:
        """Append one event; returns the stored record."""
        rec = {
            "seq": self._seq,
            "t": round(time.perf_counter() - self._t0, 9),
            "ts": time.time(),
            "event": event,
        }
        rec.update(fields)
        self._seq += 1
        self._buf.append(rec)
        return rec

    # ------------------------------------------------------------------ reads
    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[dict]:
        return iter(self._buf)

    @property
    def total(self) -> int:
        """Events ever recorded (>= len(self) once the ring wraps)."""
        return self._seq

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound."""
        return self._seq - len(self._buf)

    def events(self, event: Optional[str] = None) -> List[dict]:
        """Buffered records oldest first, optionally filtered by name."""
        if event is None:
            return list(self._buf)
        return [r for r in self._buf if r["event"] == event]

    # ---------------------------------------------------------------- exports
    def dumps(self) -> str:
        """The buffer as JSONL (one event a line, oldest first)."""
        return "".join(json.dumps(r, default=_json_default) + "\n"
                       for r in self._buf)

    def dump(self, path: str) -> int:
        """Write the buffer as JSONL to ``path``; returns events written."""
        with open(path, "w") as f:
            f.write(self.dumps())
        return len(self._buf)
