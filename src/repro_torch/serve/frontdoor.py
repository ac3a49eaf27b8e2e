"""Async serving front door: one pump task over the admission scheduler
(port of ``repro/serve/frontdoor.py``).

``FrontDoor`` is the request-level API in front of ``Scheduler``: callers
``await door.sample(seed=..., priority=..., deadline_in=...)`` from any
asyncio task, and a single background *pump* task drives every engine
pool — continuous batching comes for free because the pump runs
``Scheduler.tick()`` (refill-then-advance) in a loop, and the scheduler
refills each pool's freed slots before it advances it.

Concurrency model: the scheduler and engines are single-threaded by
design (the engine tick loop owns every launch); the front door
serializes all access to them on the event loop, and torch runs only on
the loop's thread.  A tick blocks the loop for its one host sync; the
pump yields between ticks and sleeps only while idle.  ``sample()`` just
enqueues and parks on a future the pump resolves at retire — a shed or
cancelled request rejects the future with ``ShedError`` /
``asyncio.CancelledError``, so every awaiting caller observes exactly the
request's terminal ``Outcome``.  That includes a request evicted by a
later, higher-ranked submit: the scheduler hands it to the next tick's
``TickReport.shed`` (in the reference the evicted caller waits forever).

The optional HTTP adapter (``serve_http``) is a stdlib
``ThreadingHTTPServer`` bridging request threads onto the event loop via
``asyncio.run_coroutine_threadsafe``: its threads never touch a tensor
(a draw reaches them as host numpy arrays), and they read the registry
and the scheduler's snapshot on the loop too, so a read never races the
pump's writes (the reference reads both on the handler thread):

  POST /v1/sample   {"seed": 7, "priority": 1, "deadline_in": 0.5, ...}
                    → 200 draw JSON | 503 shed | 400 bad request
                      | 409 duplicate rid | 504 no answer in timeout_s
  GET  /v1/metrics  → Prometheus text exposition of the shared registry
  GET  /v1/stats    → scheduler + pool snapshot JSON

Determinism note: none of this changes *what* is sampled — draws are
``fold_in``-keyed by (seed, t) inside the engines, so the async pump and
the HTTP hop only affect latency, never results (pinned by the replay
harness in tests/test_torch_frontdoor.py).
"""
from __future__ import annotations

import asyncio
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from .sampler_engine import SampleResult
from .scheduler import (
    DuplicateRid,
    Outcome,
    Scheduler,
    ServeRequest,
)


class ShedError(RuntimeError):
    """The scheduler dropped this request before it reached a slot."""

    def __init__(self, outcome: Outcome):
        super().__init__(f"request {outcome.rid} shed "
                         f"({outcome.reason or outcome.status})")
        self.outcome = outcome


class FrontDoor:
    """Asyncio front door over a ``Scheduler`` (in-process RPC handle).

    Args:
      scheduler: the admission scheduler (owns the pools).
      idle_interval: pump sleep (seconds) while no pool has work — keeps
        an idle front door from spinning; an active one yields to the
        loop between ticks but never sleeps.

    Use as an async context manager (starts/stops the pump), or call
    ``start()``/``drain()`` explicitly.
    """

    def __init__(self, scheduler: Scheduler, *, idle_interval: float = 0.002):
        self.scheduler = scheduler
        self.idle_interval = idle_interval
        self._futures: Dict[int, asyncio.Future] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self._auto_rid = 1 << 48      # auto-assigned ids live far above
        self._running = False         # any sane caller-chosen rid space

    # ------------------------------------------------------------ lifecycle
    async def __aenter__(self) -> "FrontDoor":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.drain()

    def start(self) -> None:
        if self._pump_task is None or self._pump_task.done():
            self._running = True
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())

    async def drain(self) -> None:
        """Let in-flight work finish, then stop the pump."""
        while self.scheduler.busy():
            await asyncio.sleep(self.idle_interval)
        self._running = False
        if self._pump_task is not None:
            await self._pump_task
            self._pump_task = None

    # -------------------------------------------------------------- frontend
    async def sample(self, seed: int, *, rid: Optional[int] = None,
                     priority: int = 0, deadline_in: Optional[float] = None,
                     pool: Optional[str] = None,
                     max_trials: int = 256) -> SampleResult:
        """Submit one request and await its draw.

        ``deadline_in`` is relative seconds on the scheduler clock (the
        absolute deadline is stamped at submission).  Raises ``ShedError``
        if the scheduler drops the request (queue full / deadline) and
        ``asyncio.CancelledError`` if ``cancel()`` withdraws it.
        """
        if rid is None:
            rid = self._auto_rid
            self._auto_rid += 1
        deadline = (None if deadline_in is None
                    else self.scheduler.clock() + deadline_in)
        # submit before registering the future: a DuplicateRid must not
        # clobber the original request's future, and with no await
        # between the two the pump cannot retire the rid in between
        ok = self.scheduler.submit(ServeRequest(
            rid=rid, seed=seed, priority=priority, deadline=deadline,
            pool=pool, max_trials=max_trials))
        if not ok:
            raise ShedError(self.scheduler.outcomes[rid])
        fut = asyncio.get_running_loop().create_future()
        self._futures[rid] = fut
        try:
            return await fut
        finally:
            self._futures.pop(rid, None)

    def cancel(self, rid: int) -> bool:
        """Withdraw a queued request; its awaiting caller sees
        ``asyncio.CancelledError``."""
        if not self.scheduler.cancel(rid):
            return False
        fut = self._futures.get(rid)
        if fut is not None and not fut.done():
            fut.cancel()
        return True

    async def handle_rpc(self, body: dict) -> dict:
        """One JSON-in/JSON-out sample call (the HTTP adapter's payload).

        Runs entirely on the event loop, so rid assignment and outcome
        lookup need no cross-thread care.  Raises ``KeyError``/
        ``ValueError`` for malformed bodies, ``ShedError`` on shed,
        ``DuplicateRid`` on rid reuse.
        """
        rid = body.get("rid")
        if rid is None:
            rid = self._auto_rid
            self._auto_rid += 1
        rid = int(rid)
        await self.sample(
            int(body["seed"]), rid=rid,
            priority=int(body.get("priority", 0)),
            deadline_in=body.get("deadline_in"),
            pool=body.get("pool"),
            max_trials=int(body.get("max_trials", 256)))
        return _result_json(rid, self.scheduler.outcomes[rid])

    async def metrics_text(self) -> Optional[str]:
        """The shared registry's text exposition, read on the event loop
        (None without telemetry)."""
        tel = self.scheduler._tel
        return None if tel is None else tel.registry.expose()

    async def stats(self) -> dict:
        """The scheduler's snapshot, read on the event loop."""
        return self.scheduler.stats()

    # ---------------------------------------------------------------- pump
    async def _pump(self) -> None:
        """The one task that advances every pool: tick, resolve futures,
        yield.  Runs until ``drain()`` clears ``_running``."""
        while self._running:
            if not self.scheduler.busy():
                await asyncio.sleep(self.idle_interval)
                continue
            rep = self.scheduler.tick()
            for rid, res in rep.retired.items():
                fut = self._futures.get(rid)
                if fut is not None and not fut.done():
                    fut.set_result(res)
            for out in rep.shed:     # deadline sheds and evictions
                fut = self._futures.get(out.rid)
                if fut is not None and not fut.done():
                    fut.set_exception(ShedError(out))
            # yield so submitters interleave with ticks even under load
            await asyncio.sleep(0)


# --------------------------------------------------------------- HTTP front
def _result_json(rid: int, out: Outcome) -> dict:
    res = out.result
    return {
        "rid": rid,
        "pool": out.pool,
        "items": np.asarray(res.items)[np.asarray(res.mask)].tolist(),
        "trials": int(res.trials),
        "accepted": bool(res.accepted),
    }


class _FrontDoorHandler(BaseHTTPRequestHandler):
    """Stdlib HTTP adapter — request threads bridge onto the event loop."""

    # set by serve_http on the server object:
    #   server.door (FrontDoor), server.loop (asyncio loop), server.timeout_s

    def log_message(self, *args):  # quiet by default; obs owns the signal
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, payload: dict) -> None:
        self._reply(code, json.dumps(payload).encode(), "application/json")

    def _on_loop(self, coro):
        """Run ``coro`` on the front door's event loop and wait for it;
        past ``timeout_s`` it is cancelled and ``TimeoutError`` raised."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.server.loop)
        try:
            return fut.result(timeout=self.server.timeout_s)
        except TimeoutError:
            fut.cancel()
            raise

    def do_GET(self) -> None:
        door: FrontDoor = self.server.door
        if self.path == "/v1/metrics":
            text = self._on_loop(door.metrics_text())
            if text is None:
                self._reply_json(404, {"error": "no telemetry attached"})
                return
            self._reply(200, text.encode(), "text/plain; version=0.0.4")
        elif self.path == "/v1/stats":
            self._reply_json(200, self._on_loop(door.stats()))
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:
        door: FrontDoor = self.server.door
        if self.path != "/v1/sample":
            self._reply_json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except ValueError as e:
            self._reply_json(400, {"error": f"bad request body: {e!r}"})
            return
        try:
            payload = self._on_loop(door.handle_rpc(body))
        except ShedError as e:
            self._reply_json(503, {"rid": e.outcome.rid, "shed": True,
                                   "reason": e.outcome.reason})
            return
        except DuplicateRid as e:
            self._reply_json(409, {"error": str(e)})
            return
        except (KeyError, TypeError, ValueError) as e:
            self._reply_json(400, {"error": f"bad request body: {e!r}"})
            return
        except TimeoutError:
            self._reply_json(504, {"error": f"no answer within "
                                            f"{self.server.timeout_s} s"})
            return
        self._reply_json(200, payload)


def serve_http(door: FrontDoor, loop: asyncio.AbstractEventLoop, *,
               host: str = "127.0.0.1", port: int = 0,
               timeout_s: float = 60.0) -> ThreadingHTTPServer:
    """Start the stdlib HTTP adapter (not started automatically).

    Returns the server; run ``server.serve_forever()`` in a thread and
    ``server.shutdown()`` to stop.  ``port=0`` binds an ephemeral port
    (``server.server_address``).  The event loop must be the one running
    the front-door pump.
    """
    srv = ThreadingHTTPServer((host, port), _FrontDoorHandler)
    srv.door = door
    srv.loop = loop
    srv.timeout_s = timeout_s
    return srv
