"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``).

- The metric primitives are plain Python on both sides: the same bucket
  index for every value, the same percentiles and merges, and for the
  same observations the same Prometheus text, byte for byte, and the same
  snapshot.
- The flight recorder and spans on one virtual clock (the modules'
  ``time`` replaced): the same JSONL dump and span snapshots.
- Instrumentation is free: an engine with telemetry draws what the same
  engine without it draws, and what the reference engine with telemetry
  draws, with the same instrument values (exposition text equal where
  both read one clock; the accounting instruments of ``obs/prof``, not in
  the port yet, aside) and the same flight events.
- ``RegistryObserver`` through the batch samplers (rejection, dynamic
  catalog, MCMC): the registry the reference's observer fills, from the
  same draws.
- The catalog's mutation and swap events, ``on_exhausted`` in its three
  modes, and the profiler gate, off by default.
"""
import json
import math
import warnings

import numpy as np
import pytest
import torch

import repro.obs as jobs
from _torch_load import VirtualClock
from _torch_port import (
    exposition,
    golden_key_layout,
    port_catalog_state,
    port_sampler,
    port_spectral,
    share_obs_clock,
)
from repro.core import preprocess as jax_preprocess
from repro.serve.sampler_engine import SampleRequest as JaxRequest
from repro.serve.sampler_engine import SamplerEngine as JaxEngine
from repro_torch import random as trandom
from repro_torch.obs import (
    FlightRecorder,
    LogHistogram,
    MetricRegistry,
    RegistryObserver,
    Span,
    Telemetry,
    trace,
)
from repro_torch.obs.prof import phases
from repro_torch.serve.sampler_engine import (
    SampleRequest,
    SamplerEngine,
    TickBudgetExhausted,
)

M, K = 32, 4
MCMC_KW = dict(backend="mcmc", mcmc_burn_in=32, mcmc_thin=8,
               mcmc_steps_per_tick=8)


@pytest.fixture(scope="module")
def samplers():
    import jax.numpy as jnp

    r = np.random.default_rng(7)
    v = jnp.asarray(r.normal(size=(M, K)) * 0.6, jnp.float32)
    b = jnp.asarray(r.normal(size=(M, K)) * 0.6, jnp.float32)
    d = jnp.asarray(r.normal(size=(K, K)), jnp.float32)
    ref = jax_preprocess(v, b, d, block=4)
    return ref, port_sampler(ref)


@pytest.fixture()
def clock(monkeypatch):
    """One virtual clock behind both sides' spans and flight recorders."""
    return share_obs_clock(monkeypatch, VirtualClock(100.0))


def events(tel):
    """Flight events without their stamps, the reference's compile events
    (its compile counter is not in the port) dropped."""
    return [{k: v for k, v in e.items() if k not in ("seq", "t", "ts")}
            for e in tel.flight.events() if e["event"] != "compile"]


def assert_same_results(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid].items,
                                      np.asarray(want[rid].items))
        np.testing.assert_array_equal(got[rid].mask,
                                      np.asarray(want[rid].mask))
        assert (int(got[rid].trials), bool(got[rid].accepted)) == (
            int(want[rid].trials), bool(want[rid].accepted)), rid


# ---------------------------------------------------------------- histograms
@pytest.mark.parametrize("factor", [2.0, 2 ** 0.5, 2 ** 0.25, 10.0])
def test_histogram_edges_equal_reference(factor):
    """The same lattice: every edge opens its own bucket, the value just
    below it closes the one before, and any value lands where the
    reference puts it."""
    h = LogHistogram(start=1e-5, factor=factor)
    ref = jobs.LogHistogram(start=1e-5, factor=factor)
    for i in range(-40, 41):
        lo, hi = h.bucket_edges(i)
        assert (lo, hi) == ref.bucket_edges(i)
        assert h.bucket_index(lo) == i
        assert h.bucket_index(math.nextafter(hi, 0.0)) == i
    vals = np.random.default_rng(3).lognormal(-4.0, 4.0, size=500)
    assert [h.bucket_index(v) for v in vals] == [ref.bucket_index(v)
                                                 for v in vals]
    assert LogHistogram(1.0, 2.0).bucket_index(4.0) == 2
    with pytest.raises(ValueError):
        LogHistogram(start=0.0)
    with pytest.raises(ValueError):
        LogHistogram(factor=1.0)


def test_histogram_percentiles_and_merge_equal_reference():
    r = np.random.default_rng(0)
    a_vals = r.lognormal(0.0, 2.0, size=200)
    b_vals = np.concatenate([r.lognormal(1.0, 1.0, size=300), [2.0 ** -80]])
    made = []
    for mod in (jobs, None):
        cls = jobs.LogHistogram if mod is jobs else LogHistogram
        a, b = cls(1e-6, 2 ** 0.25), cls(1e-6, 2 ** 0.25)
        for v in a_vals:
            a.observe(v)
        for v in b_vals:
            b.observe(v)
        made.append((a, b, a.merge(b)))
    (ra, rb, rm), (a, b, m) = made
    for got, want in ((a, ra), (b, rb), (m, rm)):
        assert got.to_dict() == want.to_dict()
        for q in (0.0, 10.0, 50.0, 90.0, 99.0, 100.0):
            assert got.percentile(q) == want.percentile(q)
        assert got.mean() == want.mean()
    assert m.count == 501 and m.underflow == 1
    exact = np.sort(np.concatenate([a_vals, b_vals]))
    assert exact[-1] == m.percentile(100)
    k = math.ceil(0.5 * exact.size) - 1
    assert exact[k] <= m.percentile(50) <= exact[k] * 2 ** 0.25
    assert math.isnan(LogHistogram().percentile(50))
    with pytest.raises(ValueError):
        m.percentile(101)
    with pytest.raises(ValueError):
        a.merge(LogHistogram(1e-6, 4.0))


def _fill(reg):
    c = reg.counter("req_total", "requests", labels=("backend",))
    c.inc(backend="rejection")
    c.inc(2.5, backend="mcmc")
    reg.gauge("depth", "queue depth").set(4)
    reg.gauge("bare").set(-1.25)
    h = reg.histogram("lat", "latency", labels=("backend",),
                      start=1e-3, factor=2.0)
    for v in (0.25, 0.5, 2.0 ** -80, 7.0, 1e-3):
        h.observe(v, backend="rejection")
    h.observe(3e-2, backend="mcmc")
    reg.histogram("empty", "never observed")
    return reg


def test_exposition_and_snapshot_equal_reference():
    reg, ref = _fill(MetricRegistry()), _fill(jobs.MetricRegistry())
    text = reg.expose()
    assert text == ref.expose()
    assert reg.snapshot() == ref.snapshot()
    json.dumps(reg.snapshot())
    assert 'lat_bucket{backend="rejection",le="0.512"} 4' in text
    assert 'lat_bucket{backend="rejection",le="+Inf"} 5' in text
    c = reg.counter("req_total", labels=("backend",))
    assert c.total() == 3.5 and c.value(backend="mcmc") == 2.5
    with pytest.raises(ValueError):
        c.inc(backend="rejection", extra="nope")
    with pytest.raises(ValueError):
        c.inc(-1, backend="mcmc")
    with pytest.raises(ValueError):
        reg.gauge("req_total")
    with pytest.raises(ValueError):
        reg.histogram("lat", labels=("backend",), start=1.0, factor=2.0)


# ------------------------------------------------------- recorder and spans
def test_flight_recorder_ring_and_dump_equal_reference(clock, tmp_path):
    recs = [FlightRecorder(capacity=4), jobs.FlightRecorder(capacity=4)]
    for i in range(7):
        clock.t += 0.125
        for fr in recs:
            fr.record("tick", n=i)
    for fr in recs:
        fr.record("retire", rid=1, trials=np.int64(9), items=np.arange(3))
    fr, ref = recs
    assert (len(fr), fr.total, fr.dropped) == (4, 8, 4)
    assert [e["n"] for e in fr.events("tick")] == [4, 5, 6]
    assert fr.dumps() == ref.dumps()
    path = tmp_path / "flight.jsonl"
    assert fr.dump(str(path)) == 4
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines[-1]["trials"] == 9 and lines[-1]["items"] == [0, 1, 2]
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_span_states_equal_reference(clock):
    spans = [Span(rid=3, seed=7, backend="rejection"),
             jobs.Span(rid=3, seed=7, backend="rejection")]
    assert spans[0].state == "queued" and spans[0].queue_wait is None
    clock.t += 0.5
    for s in spans:
        s.admit(slot=2, version=5)
        s.ticks_held += 2
    clock.t += 0.25
    for s in spans:
        s.retire(trials=9, accepted=True)
    assert spans[0].snapshot() == spans[1].snapshot()
    assert (spans[0].queue_wait, spans[0].service_time, spans[0].wall) == (
        0.5, 0.25, 0.75)
    for outcome in Span.TERMINAL_ABANDONED:
        s = Span(rid=1, seed=0, backend="mcmc")
        s.abandon(outcome)
        assert s.state == outcome and s.queue_wait is None
        assert s.service_time is None and s.t_retire is not None
        with pytest.raises(ValueError, match="only queued"):
            s.abandon(outcome)
    s = Span(rid=2, seed=0, backend="rejection")
    with pytest.raises(ValueError, match="outcome must be one of"):
        s.abandon("lost")
    s.admit(slot=0)
    with pytest.raises(ValueError, match="only queued"):
        s.abandon("cancelled")
    json.dumps(s.snapshot())


# ------------------------------------------------- instrumentation is free
def _drive(engine_cls, request_cls, sampler, tel, clock, n=10, cancel=(),
           **kw):
    """Submit ``n`` requests, withdraw ``cancel``, then step to the end with
    the clock advanced 10 ms a tick."""
    eng = engine_cls(sampler, n_slots=4, telemetry=tel, **kw)
    for i in range(n):
        clock.t += 0.001
        eng.submit(request_cls(rid=i, seed=i, max_trials=200))
    for rid, outcome in cancel:
        assert eng.cancel(rid, outcome=outcome)
    while eng.step():
        clock.t += 0.01
    return eng, eng.run()


@pytest.mark.parametrize("backend", ["rejection", "mcmc"])
def test_engine_telemetry_equals_reference_and_bare(samplers, clock,
                                                    backend):
    ref, got = samplers
    kw = dict(MCMC_KW) if backend == "mcmc" else dict(n_spec=2)
    cancel = ((8, "cancelled"), (9, "shed"))
    bare_eng, bare = _drive(SamplerEngine, SampleRequest, got, None, clock,
                            cancel=cancel, **kw)
    clock.t = 100.0
    with golden_key_layout():
        ref_tel = jobs.Telemetry()
        _, want = _drive(JaxEngine, JaxRequest, ref, ref_tel, clock,
                         cancel=cancel, **kw)
    clock.t = 100.0
    tel = Telemetry()
    eng, inst = _drive(SamplerEngine, SampleRequest, got, tel, clock,
                       cancel=cancel, **kw)
    assert sorted(inst) == list(range(8))
    assert_same_results(inst, bare)
    assert_same_results(inst, want)
    assert eng.ticks == bare_eng.ticks
    assert exposition(tel.registry) == exposition(ref_tel.registry)
    assert events(tel) == events(ref_tel)
    reg = tel.registry
    assert reg.get("ndpp_requests_retired_total").total() == 8
    assert reg.get("ndpp_requests_abandoned_total").value(
        backend=backend, outcome="shed") == 1
    # the histograms count only the served requests
    assert reg.get("ndpp_queue_wait_seconds").data(backend=backend).count == 8
    assert reg.get("ndpp_request_latency_seconds").data(
        backend=backend).count == 8
    if backend == "rejection":
        tri = reg.get("ndpp_request_trials").data(backend=backend)
        assert tri.total == sum(r.trials for r in inst.values()
                                if r.accepted)
    else:
        frac = reg.get("ndpp_mcmc_accept_fraction").data()
        assert frac.count > 0 and 0.0 <= frac.vmax <= 1.0
    st = eng.stats()
    assert st["finished"] == 8 and st["metrics"] == reg.snapshot()
    assert st["flight_events"] == len(tel.flight)


def test_engine_without_telemetry_records_nothing(samplers):
    eng = SamplerEngine(samplers[1], n_slots=2)
    eng.submit(SampleRequest(rid=0, seed=0), span=None)
    eng.run()
    assert "metrics" not in eng.stats() and eng._spans == {}


# ---------------------------------------------------------------- observers
def _observed(fn_port, fn_ref, backend="rejection"):
    reg, ref_reg = MetricRegistry(), jobs.MetricRegistry()
    got = fn_port(RegistryObserver(reg, backend))
    with golden_key_layout():
        want = fn_ref(jobs.RegistryObserver(ref_reg, backend))
    assert exposition(reg) == exposition(ref_reg)
    return got, want, reg


def _fields_equal(got, want, names=("items", "mask", "trials", "accepted")):
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_rejection_observer_equals_registry_observer(samplers):
    import jax

    from repro.core.rejection import sample_batched_many as jax_many
    from repro_torch.core.rejection import sample_batched_many

    ref, got = samplers
    kw = dict(n_spec=2, max_trials=40)
    res, want, reg = _observed(
        lambda obs: sample_batched_many(got, trandom.PRNGKey(3), 16,
                                        observer=obs, **kw),
        lambda obs: jax_many(ref, jax.random.PRNGKey(3), 16, observer=obs,
                             **kw))
    _fields_equal(res, want)
    _fields_equal(res, sample_batched_many(got, trandom.PRNGKey(3), 16, **kw))
    acc = res.accepted.numpy()
    tri = reg.get("ndpp_request_trials").data(backend="rejection")
    assert tri.count == int(acc.sum())
    assert tri.total == float(res.trials.numpy()[acc].sum())


def test_dynamic_observer_equals_registry_observer():
    import jax
    import jax.numpy as jnp

    from repro.core.dynamic import sample_dynamic_many as jax_dynamic
    from repro.serve.catalog import Catalog as JaxCatalog
    from repro_torch.core.dynamic import sample_dynamic_many

    rng = np.random.default_rng(11)
    v, b = (rng.normal(size=(2, 24, K)) * 0.3).astype(np.float32)
    d = rng.normal(size=(K, K)).astype(np.float32)
    cat = JaxCatalog(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d), block=4,
                     staleness=2)
    cat.delete_items([9, 14])
    ref_st = cat.state()
    st = port_catalog_state(ref_st)
    kw = dict(n_spec=2, max_trials=50, grow=2, max_spec=8)
    res, want, reg = _observed(
        lambda obs: sample_dynamic_many(st.proposal, st.sp,
                                        trandom.PRNGKey(5), 16, observer=obs,
                                        **kw),
        lambda obs: jax_dynamic(ref_st.proposal, ref_st.sp,
                                jax.random.PRNGKey(5), 16, observer=obs,
                                **kw))
    _fields_equal(res, want)
    _fields_equal(res, sample_dynamic_many(st.proposal, st.sp,
                                           trandom.PRNGKey(5), 16, n_spec=2,
                                           max_trials=50))
    assert reg.get("ndpp_spec_rounds_total").total() > 0
    assert reg.get("ndpp_requests_retired_total").total() == 16


@pytest.mark.parametrize("k", [None, 3])
def test_mcmc_observer_equals_registry_observer(samplers, k):
    import jax

    from repro.core.mcmc import sample_mcmc as jax_mcmc
    from repro_torch.core.mcmc import sample_mcmc

    ref, _ = samplers
    sp = port_spectral(ref.sp)
    kw = dict(k=k, n_chains=4, burn_in=16, thin=4)
    res, want, reg = _observed(
        lambda obs: sample_mcmc(sp, trandom.PRNGKey(1), 8, observer=obs,
                                **kw),
        lambda obs: jax_mcmc(ref.sp, jax.random.PRNGKey(1), 8, observer=obs,
                             **kw), backend="mcmc")
    _fields_equal(res, want, ("items", "mask", "steps"))
    assert reg.get("ndpp_mcmc_steps_total").total() == 4 * (16 + 4 * 2)


# ----------------------------------------------------- catalog, exhaustion
def test_catalog_mutation_and_swap_events_equal_reference(clock):
    import jax.numpy as jnp

    from repro.serve.catalog import Catalog as JaxCatalog
    from repro_torch.serve.catalog import Catalog

    r = np.random.default_rng(11)
    v = (r.normal(size=(24, K)) * 0.5).astype(np.float32)
    b = (r.normal(size=(24, K)) * 0.5).astype(np.float32)
    d = r.normal(size=(K, K)).astype(np.float32)
    tels, cats = [], []
    for side in ("port", "reference"):
        tel = Telemetry() if side == "port" else jobs.Telemetry()
        cat = (Catalog(v, b, d, block=4, staleness=2, telemetry=tel,
                       device="cpu") if side == "port"
               else JaxCatalog(jnp.asarray(v), jnp.asarray(b),
                               jnp.asarray(d), block=4, staleness=2,
                               telemetry=tel))
        ids = cat.insert_items(v[:3] * 0.9, b[:3] * 0.9)
        cat.update_items(ids[:2], v[:2] * 0.8, b[:2] * 0.8, defer=True)
        cat.delete_items(ids[:1])
        cat.refresh()
        cat.insert_items(np.tile(v[:1], (12, 1)) * 0.5,
                         np.tile(b[:1], (12, 1)) * 0.5)       # grows
        tels.append(tel)
        cats.append(cat)
    (tel, ref_tel), (cat, ref_cat) = tels, cats
    assert events(tel) == events(ref_tel)
    ops = [e["event"] for e in events(tel)]
    for want in ("catalog_build", "catalog_insert", "catalog_update",
                 "catalog_delete", "catalog_refresh", "catalog_grow"):
        assert want in ops, ops
    assert tel.registry.expose() == ref_tel.registry.expose()
    assert tel.registry.get("ndpp_catalog_items").value() == cat.m

    # the engine's swap event: version provenance and in-flight rids
    eng = SamplerEngine(cat, n_slots=2, n_spec=4, telemetry=tel)
    ref_eng = JaxEngine(ref_cat, n_slots=2, n_spec=4, telemetry=ref_tel)
    for e in (eng, ref_eng):
        for i in range(4):
            e.submit((SampleRequest if e is eng else JaxRequest)(
                rid=i, seed=i, max_trials=400))
    eng.step()
    with golden_key_layout():
        ref_eng.step()
    for c in cats:
        c.delete_items([0])
    old = eng._cat.version
    eng.swap_catalog(cat)
    ref_eng.swap_catalog(ref_cat)
    swap = tel.flight.events("catalog_swap")
    assert len(swap) == 1 and swap[0]["from_version"] == old
    assert swap[0]["version"] == cat.version > old
    assert tel.registry.get("ndpp_catalog_version").value() == cat.version
    # the two catalogs agree only to float32 rounding (Z = [V, B T]), so
    # their draws, and the engine events that carry them, may differ
    assert ([e for e in events(tel) if e["event"].startswith("catalog")]
            == [e for e in events(ref_tel)
                if e["event"].startswith("catalog")])
    assert sorted(eng.run()) == [0, 1, 2, 3]


def test_on_exhausted_modes(samplers, tmp_path):
    got = samplers[1]
    dump = tmp_path / "flight.jsonl"
    tel = Telemetry(dump_on_error=str(dump))
    # one 16-step tick leaves every admitted chain in flight
    eng = SamplerEngine(got, n_slots=2, telemetry=tel, backend="mcmc",
                        mcmc_burn_in=64, mcmc_thin=8, mcmc_steps_per_tick=16)
    for i in range(8):
        eng.submit(SampleRequest(rid=i, seed=i))
    with pytest.raises(TickBudgetExhausted) as ei:
        eng.run(max_ticks=1)
    err = ei.value
    assert sorted(err.unfinished) == [0, 1] and err.queued == list(range(2, 8))
    for state in err.unfinished.values():
        assert state["state"] == "active" and state["ticks_held"] == 1
    ev = tel.flight.events("tick_budget_exhausted")
    assert len(ev) == 1 and ev[0]["queued"] == err.queued
    assert any(json.loads(line)["event"] == "tick_budget_exhausted"
               for line in dump.read_text().splitlines())

    eng = SamplerEngine(got, n_slots=2, on_exhausted="warn")
    for i in range(8):
        eng.submit(SampleRequest(rid=i, seed=i))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        partial = eng.run(max_ticks=1)
    assert len(w) == 1 and issubclass(w[0].category, RuntimeWarning)
    assert "still queued" in str(w[0].message) and len(partial) < 8

    eng = SamplerEngine(got, n_slots=2, on_exhausted="ignore")
    for i in range(8):
        eng.submit(SampleRequest(rid=i, seed=i))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(eng.run(max_ticks=1)) < 8
    assert len(eng.run()) == 8            # the rest drains afterwards
    with pytest.raises(ValueError, match="on_exhausted"):
        SamplerEngine(got, on_exhausted="explode")


# ------------------------------------------------------------ profiler gate
def test_profile_gate_defaults_off(monkeypatch):
    monkeypatch.delenv(trace.PROFILE_ENV, raising=False)
    assert Telemetry().profile is False
    assert (trace.PROFILE_ENV, trace.PHASE_PREFIX) == (
        jobs.PROFILE_ENV, jobs.PHASE_PREFIX)
    tel = Telemetry(profile=False)
    cm = tel.profile_tick("ndpp_engine_tick/rejection")
    with cm:
        pass
    # disabled ranges are one shared no-op object
    assert cm is tel.profile_tick("other") is tel.phase(phases.HARVEST)
    monkeypatch.setenv(trace.PROFILE_ENV, "1")
    tel = Telemetry()
    assert tel.profile is True
    rng = tel.phase(phases.ROUND_DISPATCH)
    assert isinstance(rng, torch.profiler.record_function)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with rng:
            torch.ones(2) + 1
    assert any(e.key == trace.PHASE_PREFIX + phases.ROUND_DISPATCH
               for e in prof.key_averages())
    assert set(phases.HOST_PHASES) == {"admission", "round_dispatch",
                                       "harvest"}
    assert phases.BLOCKING_ALLOWED == {phases.HARVEST}


def test_observer_phase_hooks_named_from_the_catalog(samplers, monkeypatch):
    """``RegistryObserver.phase`` opens ``ndpp_phase/<name>`` ranges under
    the gate, and the engine opens the three host phases each tick."""
    monkeypatch.setenv(trace.PROFILE_ENV, "1")
    eng = SamplerEngine(samplers[1], n_slots=2, n_spec=2,
                        telemetry=Telemetry())
    eng.submit(SampleRequest(rid=0, seed=0))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run()
        with RegistryObserver(MetricRegistry()).phase("harvest"):
            pass
    keys = {e.key for e in prof.key_averages()}
    for name in phases.HOST_PHASES:
        assert trace.PHASE_PREFIX + name in keys, keys
    assert "ndpp_engine_tick/rejection" in keys
