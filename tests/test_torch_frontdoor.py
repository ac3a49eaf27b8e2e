"""The port's admission scheduler and asyncio/HTTP front door against the
reference's.

The scheduler decides only *when* a request reaches an engine, never what
it samples: proposal/step t of request ``rid`` is keyed
``fold_in(PRNGKey(seed), t)`` inside the engines.  So on the same arrival
trace (``tests/_torch_load.py``, the port's copy of ``tests/_load.py``,
on a virtual clock) every rid must get the same ``Outcome`` (status, shed
reason, pool, items, mask, trials, accepted) from the port's ``Scheduler``
as from the reference's, fed bit-identical sampler state; every done draw
must equal a direct submission to the port's engine; and where both sides
read the same clock the metric exposition is the same text, the
accounting instruments of ``obs/prof`` aside (not in the port yet).  The
reference runs in the golden key layout, the port's default
(``_torch_port.golden_key_layout``).

Then the port alone, as ``tests/test_frontdoor.py`` holds the reference:
priority order, deadline and queue-full sheds with their flight events
and spans, duplicate rids, a hypothesis chaos run in which no request is
lost, the asyncio ``FrontDoor`` and the HTTP adapter on loopback, every
wait bounded by a timeout.
"""
import asyncio
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - CI installs the real hypothesis
    from _hypothesis_fallback import given, settings, strategies as st

import _load
import _torch_load
from _torch_load import Arrival, VirtualClock, poisson_trace, replay
from _torch_port import (
    exposition,
    golden_key_layout,
    port_sampler,
    share_obs_clock,
)
from repro.core import preprocess as jax_preprocess
from repro.obs import Telemetry as JaxTelemetry
from repro.serve.sampler_engine import SamplerEngine as JaxEngine
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro.serve.scheduler import ServeRequest as JaxServeRequest
from repro_torch.obs import Telemetry
from repro_torch.serve.frontdoor import FrontDoor, ShedError, serve_http
from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine
from repro_torch.serve.scheduler import (
    SHED_REASONS,
    DuplicateRid,
    Scheduler,
    ServeRequest,
)

M, K = 8, 4
MCMC_KW = dict(backend="mcmc", mcmc_burn_in=32, mcmc_thin=8,
               mcmc_steps_per_tick=8)
TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def samplers():
    import jax.numpy as jnp

    r = np.random.default_rng(7)
    v = jnp.asarray(r.normal(size=(M, K)) * 0.6, jnp.float32)
    b = jnp.asarray(r.normal(size=(M, K)) * 0.6, jnp.float32)
    d = jnp.asarray(r.normal(size=(K, K)), jnp.float32)
    ref = jax_preprocess(v, b, d, block=2)
    return ref, port_sampler(ref)


@pytest.fixture()
def shared_clock(monkeypatch):
    """One virtual clock read by both sides' spans, engines, schedulers and
    flight recorders."""
    return share_obs_clock(monkeypatch, VirtualClock(100.0))


def make_pools(engine_cls, sampler, tel=None, *, n_spec=4, pools="both"):
    out = {}
    if pools in ("both", "rej"):
        out["rej"] = engine_cls(sampler, n_slots=3, n_spec=n_spec,
                                telemetry=tel)
    if pools in ("both", "mcmc"):
        out["mcmc"] = engine_cls(sampler, n_slots=2, telemetry=tel,
                                 **MCMC_KW)
    return out


def direct_draws(sampler, reqs_by_backend):
    """The same (rid, seed, max_trials) sets submitted straight to fresh
    port engines: the draws every scheduled path must reproduce."""
    out = {}
    for backend, reqs in reqs_by_backend.items():
        if not reqs:
            continue
        eng = (SamplerEngine(sampler, n_slots=3, n_spec=4)
               if backend == "rejection"
               else SamplerEngine(sampler, n_slots=2, **MCMC_KW))
        for r in reqs:
            eng.submit(SampleRequest(rid=r.rid, seed=r.seed,
                                     max_trials=r.max_trials))
        out.update(eng.run(max_ticks=5000))
    return out


def assert_same_draw(a, b, rid):
    assert np.array_equal(np.asarray(a.items), np.asarray(b.items)), rid
    assert np.array_equal(np.asarray(a.mask), np.asarray(b.mask)), rid
    assert (int(a.trials), bool(a.accepted)) == (int(b.trials),
                                                 bool(b.accepted)), rid


def assert_same_outcomes(got, want):
    """Rid by rid: status, reason, pool and the draw."""
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        assert (g.status, g.reason, g.pool) == (w.status, w.reason,
                                                w.pool), rid
        assert (g.result is None) == (w.result is None), rid
        if w.result is not None:
            assert_same_draw(g.result, w.result, rid)


def check_against_direct(sampler, sched, outcomes, reqs):
    """Every done outcome equals a direct submission to a port engine of
    the backend it was routed to."""
    reqs = {r.rid: r for r in reqs}
    by_backend = {"rejection": [], "mcmc": []}
    for rid, out in outcomes.items():
        if out.status == "done":
            by_backend[sched.pools[out.pool].backend].append(reqs[rid])
    truth = direct_draws(sampler, by_backend)
    assert sorted(truth) == sorted(
        r for r, o in outcomes.items() if o.status == "done")
    for rid, res in truth.items():
        assert_same_draw(outcomes[rid].result, res, rid)
    return len(truth)


def replay_both(samplers, trace_kw, *, pools="both", telemetry=True,
                clock=None, sched_kw=None, **replay_kw):
    """The same trace through the reference's scheduler and the port's,
    each on its own virtual clock (or on ``clock``, shared, reset between
    the two).  Returns (port outcomes, reference outcomes, port scheduler,
    reference scheduler, port telemetry, reference telemetry)."""
    ref, got = samplers
    sched_kw = sched_kw or {}
    runs = []
    for side in ("reference", "port"):
        if clock is not None:
            clock.t = 100.0
        c = clock if clock is not None else VirtualClock()
        if side == "reference":
            tel = JaxTelemetry() if telemetry else None
            sched = JaxScheduler(make_pools(JaxEngine, ref, tel, pools=pools),
                                 clock=c, telemetry=tel, **sched_kw)
            trace = _load.poisson_trace(**trace_kw)
            with golden_key_layout():
                out = _load.replay(sched, c, trace, **replay_kw)
        else:
            tel = Telemetry() if telemetry else None
            sched = Scheduler(make_pools(SamplerEngine, got, tel, pools=pools),
                              clock=c, telemetry=tel, **sched_kw)
            trace = _torch_load.poisson_trace(**trace_kw)
            out = _torch_load.replay(sched, c, trace, **replay_kw)
        runs.append((out, sched, tel, trace))
    (want, ref_sched, ref_tel, _), (out, sched, tel, trace) = runs
    return out, want, sched, ref_sched, tel, ref_tel, trace


# ------------------------------------------------------------- the harness
def test_poisson_trace_equals_reference_trace():
    kw = dict(n=40, rate=300.0, pools=(None, "rej", "mcmc"),
              priorities=(0, 1, 2), deadline_frac=0.3,
              deadline_range=(0.05, 0.5), rid_base=7, max_trials=64)
    for seed in (0, 13, 2 ** 20):
        got = poisson_trace(seed, **kw)
        want = _load.poisson_trace(seed, **kw)
        assert len(got) == len(want) == 40
        for g, w in zip(got, want):
            assert g.t == w.t
            for name in ("rid", "seed", "priority", "deadline", "pool",
                         "max_trials"):
                assert getattr(g.req, name) == getattr(w.req, name), name


# ----------------------------------------- replays against the reference
@pytest.mark.parametrize("pools,trace_kw", [
    ("rej", dict(seed=11, n=24, rate=500.0, priorities=(0, 1, 2))),
    ("mcmc", dict(seed=12, n=8, rate=300.0)),
    ("both", dict(seed=13, n=20, rate=400.0, pools=(None, "rej", "mcmc"),
                  priorities=(0, 5), deadline_frac=0.25,
                  deadline_range=(0.002, 0.05))),
], ids=["rejection", "mcmc", "mixed"])
def test_replay_equals_reference_scheduler(samplers, shared_clock, pools,
                                           trace_kw):
    """Each rid's Outcome equals the reference scheduler's on the same
    trace, every done draw equals direct submission to the port's engine,
    and the exposition (both sides on one virtual clock) is the same
    text."""
    out, want, sched, _, tel, ref_tel, trace = replay_both(
        samplers, trace_kw, pools=pools, clock=shared_clock)
    assert_same_outcomes(out, want)
    n = check_against_direct(samplers[1], sched, out,
                             [a.req for a in trace])
    assert n == sum(o.status == "done" for o in out.values()) > 0
    if pools == "both":
        assert {o.pool for o in out.values() if o.pool} == {"rej", "mcmc"}
    assert exposition(tel.registry) == exposition(ref_tel.registry)
    assert "ndpp_sched_admitted_total" in exposition(tel.registry)


def test_replay_with_cancellations_equals_reference(samplers):
    """Cancelling queued requests mid-trace: the same rids end cancelled on
    both sides, with a span and a flight event to match, and no other
    draw moves."""
    cancel_rids = [7, 11, 15]
    trace = poisson_trace(19, 18, rate=2000.0)        # bursty: deep queue
    cancel_at = {rid: trace[rid].t + 1e-4 for rid in cancel_rids}
    out, want, sched, _, tel, _, trace = replay_both(
        samplers, dict(seed=19, n=18, rate=2000.0), pools="rej",
        cancel_at=cancel_at)
    assert_same_outcomes(out, want)
    assert sorted(r for r, o in out.items()
                  if o.status == "cancelled") == cancel_rids
    for rid in cancel_rids:
        assert sched.spans[rid].state == "cancelled"
        assert any(e["rid"] == rid for e in tel.flight.events("sched_cancel"))
    check_against_direct(samplers[1], sched, out,
                         [a.req for a in trace if a.req.rid not in cancel_rids])


def test_replay_schedule_invariant(samplers):
    """The same request set under three arrival schedules and tick
    cadences retires the same draws."""
    base = poisson_trace(17, 16, rate=400.0, pools=("rej",))
    draws = []
    for rate_scale, tick_dt in ((1.0, 0.002), (0.1, 0.002), (1.0, 0.01)):
        clock = VirtualClock()
        sched = Scheduler(make_pools(SamplerEngine, samplers[1]), clock=clock)
        trace = [Arrival(t=a.t / rate_scale,
                         req=ServeRequest(rid=a.req.rid, seed=a.req.seed,
                                          pool=a.req.pool))
                 for a in base]
        outcomes = replay(sched, clock, trace, tick_dt=tick_dt)
        draws.append({rid: outcomes[rid].result for rid in outcomes})
    for other in draws[1:]:
        assert sorted(other) == sorted(draws[0])
        for rid in draws[0]:
            assert_same_draw(draws[0][rid], other[rid], rid)


def test_autoscale_sequence_equals_reference(samplers):
    """Queue-wait p99 drives n_spec in power-of-two steps: the port's
    sequence of n_spec by tick, its resize events and every outcome equal
    the reference's; the draws equal direct submission."""
    ref, got = samplers

    def run(sched_cls, engine_cls, tel_cls, req_cls, sampler):
        tel, clock = tel_cls(), VirtualClock()
        eng = engine_cls(sampler, n_slots=2, n_spec=2, telemetry=tel)
        sched = sched_cls({"rej": eng}, clock=clock, telemetry=tel,
                          autoscale_n_spec=True, target_queue_wait=0.05,
                          autoscale_every=2, n_spec_min=1, n_spec_max=8)
        for i in range(30):
            sched.submit(req_cls(rid=i, seed=i))
        clock.advance(1.0)        # the whole queue is 1 s old: p99 >> target
        seen = []
        while sched.busy():
            clock.advance(0.001)
            sched.tick()
            seen.append(eng.n_spec)
        resizes = [{k: e[k] for k in ("pool", "old", "new", "tick")}
                   for e in tel.flight.events("n_spec_resize")]
        return seen, resizes, dict(sched.outcomes), sched, tel, eng

    with golden_key_layout():
        want = run(JaxScheduler, JaxEngine, JaxTelemetry, JaxServeRequest,
                   ref)
    seen, resizes, out, sched, tel, eng = run(Scheduler, SamplerEngine,
                                              Telemetry, ServeRequest, got)
    assert seen == want[0] and resizes == want[1]
    assert max(seen) > 2 and max(seen) <= 8
    assert all(s & (s - 1) == 0 for s in seen)
    assert tel.registry.get("ndpp_sched_n_spec").value(pool="rej") == \
        eng.n_spec
    assert_same_outcomes(out, want[2])
    check_against_direct(got, sched, out,
                         [ServeRequest(rid=i, seed=i) for i in range(30)])


# ------------------------------------------------------ admission, sheds
def test_priority_order_exact_single_pool(samplers):
    """All requests queued up front on one pool: admission in exactly
    (-priority, seq) order, as the reference's."""
    def admitted(sched_cls, engine_cls, req_cls, sampler):
        sched = sched_cls({"rej": engine_cls(sampler, n_slots=2, n_spec=4)})
        reqs = [req_cls(rid=i, seed=i, priority=(i * 7) % 5)
                for i in range(12)]
        for r in reqs:
            sched.submit(r)
        order = []
        while sched.busy():
            order += [rid for rid, _ in sched.tick().admitted]
        assert all(o.status == "done" for o in sched.outcomes.values())
        return order, [r.rid for r in sorted(
            reqs, key=lambda r: (-r.priority, r.seq))]

    order, expected = admitted(Scheduler, SamplerEngine, ServeRequest,
                               samplers[1])
    assert order == expected
    with golden_key_layout():
        assert admitted(JaxScheduler, JaxEngine, JaxServeRequest,
                        samplers[0])[0] == order


def test_deadline_shed_has_flight_event_and_span(samplers):
    tel, clock = Telemetry(), VirtualClock()
    sched = Scheduler({"rej": SamplerEngine(samplers[1], n_slots=2, n_spec=4,
                                            telemetry=tel)},
                      clock=clock, telemetry=tel)
    sched.submit(ServeRequest(rid=0, seed=1, deadline=0.5))
    sched.submit(ServeRequest(rid=1, seed=2))
    clock.advance(1.0)                      # rid 0 expires in the queue
    outcomes = sched.run()
    assert outcomes[0].status == "shed" and outcomes[0].reason == "deadline"
    assert outcomes[1].status == "done"
    assert sched.spans[0].state == "shed"
    assert sched.spans[0].queue_wait is None    # histograms never saw it
    shed_ev = tel.flight.events("sched_shed")
    assert [e["rid"] for e in shed_ev] == [0]
    assert shed_ev[0]["reason"] == "deadline"
    assert tel.registry.get("ndpp_sched_shed_total").value(
        reason="deadline") == 1
    assert tel.registry.get(
        "ndpp_sched_queue_wait_seconds").data().count == 1


def test_queue_full_reject_and_evict(samplers):
    got = samplers[1]
    tel = Telemetry()
    sched = Scheduler({"rej": SamplerEngine(got, n_slots=1, n_spec=4,
                                            telemetry=tel)},
                      max_queue=2, on_full="reject", telemetry=tel)
    assert sched.submit(ServeRequest(rid=0, seed=0))
    assert sched.submit(ServeRequest(rid=1, seed=1))
    assert not sched.submit(ServeRequest(rid=2, seed=2))
    assert (sched.outcomes[2].status, sched.outcomes[2].reason) == (
        "shed", "queue_full")
    assert sched.spans[2].state == "shed"
    assert sched.run()[0].status == "done"

    tel = Telemetry()
    sched = Scheduler({"rej": SamplerEngine(got, n_slots=1, n_spec=4,
                                            telemetry=tel)},
                      max_queue=2, on_full="evict", telemetry=tel)
    sched.submit(ServeRequest(rid=0, seed=0, priority=1))
    sched.submit(ServeRequest(rid=1, seed=1, priority=0))   # the worst
    assert sched.submit(ServeRequest(rid=2, seed=2, priority=5))
    assert (sched.outcomes[1].status, sched.outcomes[1].reason) == (
        "shed", "evicted")
    # a low-priority submit against a full queue still bounces itself
    assert not sched.submit(ServeRequest(rid=3, seed=3, priority=-1))
    assert sched.outcomes[3].reason == "queue_full"
    outcomes = sched.run()
    assert {r: o.status for r, o in outcomes.items()} == {
        0: "done", 1: "shed", 2: "done", 3: "shed"}
    assert [e["rid"] for e in tel.flight.events("sched_shed")] == [1, 3]
    assert all(o.reason in SHED_REASONS for o in outcomes.values()
               if o.status == "shed")
    with pytest.raises(ValueError):
        Scheduler({"rej": SamplerEngine(got, n_slots=1)}, on_full="drop")


def test_duplicate_rid_rejected(samplers):
    sched = Scheduler({"rej": SamplerEngine(samplers[1], n_slots=2,
                                            n_spec=4)})
    sched.submit(ServeRequest(rid=5, seed=1))
    with pytest.raises(DuplicateRid):
        sched.submit(ServeRequest(rid=5, seed=2))
    sched.run()
    with pytest.raises(DuplicateRid):      # rids stay unique after retire
        sched.submit(ServeRequest(rid=5, seed=3))
    with pytest.raises(ValueError, match="unknown pool"):
        sched.submit(ServeRequest(rid=6, seed=3, pool="nope"))


@settings(max_examples=5, deadline=None)
@given(trace_seed=st.integers(0, 2 ** 16), max_queue=st.integers(2, 8),
       on_full=st.sampled_from(["reject", "evict"]),
       deadline_frac=st.floats(0.0, 0.5))
def test_chaos_no_request_lost(samplers, trace_seed, max_queue, on_full,
                               deadline_frac):
    """Random priorities, deadlines, bursts and cancels against a tiny
    queue: every submitted rid ends in exactly one terminal state, none is
    retired twice, every shed has a flight event and a shed span, and the
    served draws equal direct submission."""
    got = samplers[1]
    clock, tel = VirtualClock(), Telemetry()
    sched = Scheduler({"rej": SamplerEngine(got, n_slots=2, n_spec=4,
                                            telemetry=tel)},
                      clock=clock, telemetry=tel, max_queue=max_queue,
                      on_full=on_full)
    trace = poisson_trace(trace_seed, 20, rate=3000.0,
                          priorities=(-1, 0, 3), deadline_frac=deadline_frac,
                          deadline_range=(0.001, 0.02))
    retired_seen, submitted = [], []
    rng = np.random.default_rng(trace_seed + 1)
    for arr in trace:
        clock.advance(max(0.0, arr.t - clock.t))
        sched.submit(arr.req)
        submitted.append(arr.req.rid)
        with pytest.raises(DuplicateRid):
            sched.submit(ServeRequest(rid=arr.req.rid, seed=0))
        if rng.random() < 0.2:
            sched.cancel(int(rng.choice(submitted)))
        if sched.busy() and rng.random() < 0.5:
            clock.advance(0.002)
            retired_seen += list(sched.tick().retired)
    while sched.busy():
        clock.advance(0.002)
        retired_seen += list(sched.tick().retired)

    outcomes = sched.outcomes
    assert sorted(outcomes) == sorted(submitted)          # none lost
    assert len(retired_seen) == len(set(retired_seen))    # none retired 2x
    assert sorted(retired_seen) == sorted(
        r for r, o in outcomes.items() if o.status == "done")
    for rid, out in outcomes.items():
        assert out.status in ("done", "shed", "cancelled")
        if out.status == "done":
            assert out.result is not None and out.pool == "rej"
        else:
            assert sched.spans[rid].state == out.status
        if out.status == "shed":
            assert out.reason in SHED_REASONS
            assert any(e["rid"] == rid
                       for e in tel.flight.events("sched_shed"))
    check_against_direct(got, sched, outcomes, [a.req for a in trace])


# ------------------------------------------------------------- front door
def _wait(coro):
    return asyncio.wait_for(coro, TIMEOUT_S)


def test_frontdoor_async_matches_direct(samplers):
    got = samplers[1]

    async def main():
        tel = Telemetry()
        sched = Scheduler(make_pools(SamplerEngine, got, tel), telemetry=tel,
                          max_queue=64)
        async with FrontDoor(sched, idle_interval=0.001) as door:
            rej = [door.sample(100 + i, rid=i, pool="rej") for i in range(6)]
            mc = [door.sample(200 + i, rid=50 + i, pool="mcmc")
                  for i in range(3)]
            res = await _wait(asyncio.gather(*rej, *mc))
        return {i: r for i, r in zip(list(range(6)) + list(range(50, 53)),
                                     res)}

    out = asyncio.run(main())
    reqs = ([ServeRequest(rid=i, seed=100 + i) for i in range(6)] +
            [ServeRequest(rid=50 + i, seed=200 + i) for i in range(3)])
    truth = direct_draws(got, {"rejection": reqs[:6], "mcmc": reqs[6:]})
    assert sorted(truth) == sorted(out)
    for rid in truth:
        assert_same_draw(out[rid], truth[rid], rid)


def test_frontdoor_shed_and_cancel_surface_as_exceptions(samplers):
    got = samplers[1]

    async def main():
        tel = Telemetry()
        sched = Scheduler({"rej": SamplerEngine(got, n_slots=1, n_spec=4,
                                                telemetry=tel)},
                          telemetry=tel, max_queue=3)
        door = FrontDoor(sched, idle_interval=0.001)
        # the pump is not started yet: everything below is deterministic
        t1 = asyncio.ensure_future(door.sample(2, rid=1))
        t2 = asyncio.ensure_future(door.sample(3, rid=2))
        t3 = asyncio.ensure_future(door.sample(4, rid=3))
        await asyncio.sleep(0)               # all three enqueue
        with pytest.raises(ShedError) as ei:   # 4th submit: queue full
            await _wait(door.sample(5, rid=4))
        assert ei.value.outcome.reason == "queue_full"
        assert door.cancel(3)                # still queued: withdrawable
        assert not door.cancel(3)
        with pytest.raises(asyncio.CancelledError):
            await _wait(t3)
        door.start()
        r1, r2 = await _wait(asyncio.gather(t1, t2))
        assert r1.accepted in (True, False) and r2 is not None
        with pytest.raises(ShedError) as ei:
            await _wait(door.sample(1, rid=0, deadline_in=-1.0))
        assert ei.value.outcome.reason == "deadline"
        with pytest.raises(DuplicateRid):    # rids stay unique after shed
            await _wait(door.sample(9, rid=0))
        await _wait(door.drain())
        assert sched.outcomes[0].status == "shed"
        assert sched.outcomes[3].status == "cancelled"
        assert sched.spans[3].state == "cancelled"
        assert sched.outcomes[4].reason == "queue_full"

    asyncio.run(main())


def test_eviction_reported_in_next_tick(samplers):
    """A request evicted by a later submit is in the next tick's
    ``TickReport.shed`` (beside that tick's deadline sheds) and in no
    later one: the pump resolves futures from the reports alone."""
    tel = Telemetry()
    sched = Scheduler({"rej": SamplerEngine(samplers[1], n_slots=2,
                                            n_spec=4, telemetry=tel)},
                      max_queue=2, on_full="evict", telemetry=tel)
    sched.submit(ServeRequest(rid=0, seed=0, priority=1))
    sched.submit(ServeRequest(rid=1, seed=1, priority=0))
    assert sched.submit(ServeRequest(rid=2, seed=2, priority=5))
    assert sched.submit(ServeRequest(rid=3, seed=3, priority=2,
                                     deadline=-1.0))       # evicts rid 0
    rep = sched.tick()
    assert [(o.rid, o.status, o.reason) for o in rep.shed] == [
        (1, "shed", "evicted"), (0, "shed", "evicted"),
        (3, "shed", "deadline")]
    reps = []
    while sched.busy():
        reps.append(sched.tick())
    assert not any(r.shed for r in reps)
    assert {r: o.status for r, o in sched.outcomes.items()} == {
        0: "shed", 1: "shed", 2: "done", 3: "shed"}


def test_frontdoor_evicted_caller_gets_shed_error(samplers):
    """Under ``on_full="evict"`` the evicted caller's ``await`` ends in
    ``ShedError`` (reason ``evicted``) within the timeout, and the request
    that displaced it gets the direct draw."""
    got = samplers[1]

    async def main():
        tel = Telemetry()
        sched = Scheduler({"rej": SamplerEngine(got, n_slots=1, n_spec=4,
                                                telemetry=tel)},
                          telemetry=tel, max_queue=2, on_full="evict")
        door = FrontDoor(sched, idle_interval=0.001)
        # the pump is not started yet: everything below is deterministic
        t0 = asyncio.ensure_future(door.sample(10, rid=0, priority=1))
        t1 = asyncio.ensure_future(door.sample(11, rid=1, priority=0))
        await asyncio.sleep(0)               # both enqueue: the queue is full
        t2 = asyncio.ensure_future(door.sample(12, rid=2, priority=5))
        await asyncio.sleep(0)               # rid 2 evicts rid 1
        assert sched.outcomes[1].reason == "evicted" and not t1.done()
        door.start()
        with pytest.raises(ShedError) as ei:
            await _wait(t1)
        assert (ei.value.outcome.rid, ei.value.outcome.reason) == (
            1, "evicted")
        res = await _wait(asyncio.gather(t0, t2))
        await _wait(door.drain())
        assert sched.spans[1].state == "shed"
        return res

    r0, r2 = asyncio.run(main())
    truth = direct_draws(got, {"rejection": [ServeRequest(rid=0, seed=10),
                                             ServeRequest(rid=2, seed=12)]})
    assert_same_draw(r0, truth[0], 0)
    assert_same_draw(r2, truth[2], 2)


def _http_call(url, method, path, body=None):
    """(status, body bytes) of one request, an error status included."""
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url + path, data=data, method=method)
    try:
        with urllib.request.urlopen(r, timeout=TIMEOUT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_evicted_request_answers_503(samplers):
    """``serve_http`` over an ``on_full="evict"`` scheduler: a POST
    evicted by a higher-priority one is answered 503 with reason
    ``evicted`` within the timeout, the other 200 with the direct draw;
    a POST that the pump does not answer within ``timeout_s`` gets 504."""
    got = samplers[1]

    async def main():
        tel = Telemetry()
        sched = Scheduler({"rej": SamplerEngine(got, n_slots=1, n_spec=4,
                                                telemetry=tel)},
                          telemetry=tel, max_queue=1, on_full="evict")
        loop = asyncio.get_running_loop()
        door = FrontDoor(sched, idle_interval=0.001)   # pump not started
        srvs = [serve_http(door, loop, timeout_s=t)
                for t in (TIMEOUT_S, 0.2)]
        threads = [threading.Thread(target=s.serve_forever, daemon=True)
                   for s in srvs]
        for t in threads:
            t.start()
        url, url_short = ("http://%s:%d" % s.server_address for s in srvs)

        def ask(u, body):
            return loop.run_in_executor(None, _http_call, u, "POST",
                                        "/v1/sample", body)

        async def until(pred):
            while not pred():
                await asyncio.sleep(0.001)

        def queued(n):
            return until(lambda: sched.stats()["queued"] == n)

        try:
            code, raw = await _wait(ask(url_short, {"seed": 9, "rid": 9,
                                                    "priority": -1}))
            assert code == 504 and "error" in json.loads(raw)
            await _wait(queued(1))           # rid 9 stays queued
            assert sched.cancel(9)
            low = ask(url, {"seed": 21, "rid": 1, "priority": 0})
            await _wait(queued(1))
            high = ask(url, {"seed": 22, "rid": 2, "priority": 5})
            await _wait(until(lambda: 1 in sched.outcomes))
            door.start()
            (c1, raw1), (c2, raw2) = await _wait(asyncio.gather(low, high))
            await _wait(door.drain())
        finally:
            for s, t in zip(srvs, threads):
                s.shutdown()
                s.server_close()
                t.join(TIMEOUT_S)
        return (c1, json.loads(raw1)), (c2, json.loads(raw2))

    (c1, b1), (c2, b2) = asyncio.run(main())
    assert c1 == 503 and (b1["rid"], b1["reason"]) == (1, "evicted")
    truth = direct_draws(got, {"rejection": [ServeRequest(rid=2, seed=22)]})
    assert c2 == 200 and b2["items"] == np.asarray(truth[2].items)[
        np.asarray(truth[2].mask)].tolist()


def test_frontdoor_http_adapter(samplers):
    """``serve_http`` on 127.0.0.1, port 0: a draw equal to direct
    submission (200), a duplicate rid (409), a bad body (400), a shed
    request (503), stats, an unknown path (404) and the metrics text."""
    got = samplers[1]

    async def main():
        tel = Telemetry()
        sched = Scheduler(make_pools(SamplerEngine, got, tel), telemetry=tel,
                          max_queue=32)
        loop = asyncio.get_running_loop()
        async with FrontDoor(sched, idle_interval=0.001) as door:
            srv = serve_http(door, loop, timeout_s=TIMEOUT_S)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            host, port = srv.server_address
            assert host == "127.0.0.1" and port > 0

            def call(method, path, body=None):
                data = (json.dumps(body).encode()
                        if body is not None else None)
                r = urllib.request.Request(f"http://{host}:{port}{path}",
                                           data=data, method=method)
                try:
                    with urllib.request.urlopen(r, timeout=TIMEOUT_S) as resp:
                        raw = resp.read()
                        return resp.status, raw
                except urllib.error.HTTPError as e:
                    return e.code, e.read()

            async def ask(method, path, body=None):
                return await _wait(loop.run_in_executor(
                    None, call, method, path, body))

            try:
                code, raw = await ask("POST", "/v1/sample",
                                      {"seed": 42, "rid": 1, "pool": "rej"})
                body = json.loads(raw)
                assert code == 200 and body["rid"] == 1
                assert body["pool"] == "rej"
                truth = direct_draws(got, {"rejection": [
                    ServeRequest(rid=1, seed=42)]})[1]
                assert body["items"] == np.asarray(truth.items)[
                    np.asarray(truth.mask)].tolist()
                assert (body["trials"], body["accepted"]) == (
                    truth.trials, truth.accepted)
                code, _ = await ask("POST", "/v1/sample",
                                    {"seed": 42, "rid": 1})
                assert code == 409                    # duplicate rid
                code, _ = await ask("POST", "/v1/sample", {"nope": 1})
                assert code == 400
                code, raw = await ask("POST", "/v1/sample",
                                      {"seed": 3, "rid": 2,
                                       "deadline_in": -1.0})
                assert code == 503 and json.loads(raw)["reason"] == "deadline"
                code, raw = await ask("GET", "/v1/stats")
                assert code == 200 and json.loads(raw)["requests"]["done"] == 1
                code, _ = await ask("GET", "/v1/nothing")
                assert code == 404
                code, raw = await ask("GET", "/v1/metrics")
                text = raw.decode()
                assert code == 200
                assert "ndpp_sched_submitted_total 2" in text
                assert 'ndpp_requests_retired_total{backend="rejection"' \
                    in text
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(TIMEOUT_S)

    asyncio.run(main())


def test_http_concurrent_clients_stress(samplers):
    """More client threads than cores, the interpreter's switch interval
    shortened: each of 24 concurrent POSTs is answered once with the direct
    draw, and the metrics and stats reads in between (served on the event
    loop, as the pump's writes are) all succeed."""
    import concurrent.futures
    import os
    import sys

    got = samplers[1]
    n_threads = 2 * (os.cpu_count() or 4)
    reqs = [(300 + i, 7_000 + i) for i in range(24)]

    async def main():
        tel = Telemetry()
        sched = Scheduler(make_pools(SamplerEngine, got, tel, pools="rej"),
                          telemetry=tel, max_queue=64)
        loop = asyncio.get_running_loop()
        async with FrontDoor(sched, idle_interval=0.001) as door:
            srv = serve_http(door, loop, timeout_s=TIMEOUT_S)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            url = "http://%s:%d" % srv.server_address

            def post(rid, seed):
                body = json.dumps({"rid": rid, "seed": seed}).encode()
                r = urllib.request.Request(url + "/v1/sample", data=body,
                                           method="POST")
                with urllib.request.urlopen(r, timeout=TIMEOUT_S) as resp:
                    return resp.status, json.loads(resp.read())

            def get(path):
                with urllib.request.urlopen(url + path,
                                            timeout=TIMEOUT_S) as resp:
                    return resp.status, resp.read()

            pool = concurrent.futures.ThreadPoolExecutor(n_threads)
            old = sys.getswitchinterval()
            sys.setswitchinterval(1e-5)
            try:
                jobs = [loop.run_in_executor(pool, post, rid, seed)
                        for rid, seed in reqs]
                jobs += [loop.run_in_executor(pool, get, path)
                         for path in ("/v1/metrics", "/v1/stats") * 8]
                answers = await _wait(asyncio.gather(*jobs))
            finally:
                sys.setswitchinterval(old)
                srv.shutdown()
                srv.server_close()
                pool.shutdown(wait=True)
                thread.join(TIMEOUT_S)
            assert not thread.is_alive()
        return answers

    answers = asyncio.run(main())
    assert all(code == 200 for code, _ in answers)
    truth = direct_draws(got, {"rejection": [ServeRequest(rid=r, seed=s)
                                             for r, s in reqs]})
    for (rid, _), (_, body) in zip(reqs, answers):
        t = truth[rid]
        assert body["rid"] == rid
        assert body["items"] == np.asarray(t.items)[
            np.asarray(t.mask)].tolist(), rid
