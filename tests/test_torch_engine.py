"""The port's SamplerEngine against the reference engine.

Both engines serve the same requests from bit-identical sampler state
(carried across with ``sampler_from_numpy``); every request id must get
the same ``SampleResult`` (items, mask, trials, accepted), including a
``max_trials`` that is not a multiple of ``n_spec`` and exhausted
requests, and the result must not depend on the pool size.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import golden_key_layout, port_sampler
from repro.core import preprocess as jax_preprocess
from repro.serve.sampler_engine import SampleRequest as JaxRequest
from repro.serve.sampler_engine import SamplerEngine as JaxEngine
from repro_torch.core.types import SpectralNDPP
from repro_torch.launch.mesh import make_sampler_mesh
from repro_torch.serve.sampler_engine import (
    SampleRequest,
    SamplerEngine,
    TickBudgetExhausted,
    _host_prng_key,
)

M, K = 8, 4
SEEDS = [5, 17, 23, 40, 41, 99, 1000, 2**31 - 1, 7, 8, 9, 10]


@pytest.fixture(scope="module")
def samplers():
    rng = np.random.default_rng(77)
    v = jnp.asarray(rng.normal(size=(M, K)) * 0.6, jnp.float32)
    b = jnp.asarray(rng.normal(size=(M, K)) * 0.6, jnp.float32)
    d = jnp.asarray(rng.normal(size=(K, K)), jnp.float32)
    ref = jax_preprocess(v, b, d, block=2)
    return ref, port_sampler(ref)


def serve(engine_cls, request_cls, sampler, n_slots, max_trials=7,
          n_spec=4):
    eng = engine_cls(sampler, n_slots=n_slots, n_spec=n_spec)
    for rid, seed in enumerate(SEEDS):
        eng.submit(request_cls(rid=rid, seed=seed, max_trials=max_trials))
    return eng.run()


def assert_same_results(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        g, w = got[rid], want[rid]
        np.testing.assert_array_equal(g.items, np.asarray(w.items))
        np.testing.assert_array_equal(g.mask, np.asarray(w.mask))
        assert (g.trials, g.accepted) == (int(w.trials), bool(w.accepted)), rid


@pytest.mark.parametrize("max_trials", [7, 2])
def test_engine_matches_reference_engine(samplers, max_trials):
    ref, got = samplers
    with golden_key_layout():
        want = serve(JaxEngine, JaxRequest, ref, 4, max_trials)
        res = serve(SamplerEngine, SampleRequest, got, 4, max_trials)
    assert_same_results(res, want)
    if max_trials == 2:          # the budget path really ran
        assert not all(r.accepted for r in res.values())


def test_results_do_not_depend_on_pool_size(samplers):
    _, got = samplers
    base = serve(SamplerEngine, SampleRequest, got, 4)
    for n_slots in (1, 3, 5):
        assert_same_results(serve(SamplerEngine, SampleRequest, got, n_slots),
                            base)
    assert_same_results(
        serve(SamplerEngine, SampleRequest, got, 4, n_spec=2), base)


def test_run_returns_every_request_and_budget_raises(samplers):
    _, got = samplers
    eng = SamplerEngine(got, n_slots=2, n_spec=4)
    for rid in range(6):
        eng.submit(SampleRequest(rid=rid, seed=rid))
    assert eng.cancel(5) and not eng.cancel(5)
    with pytest.raises(TickBudgetExhausted) as info:
        eng.run(max_ticks=1)
    assert info.value.queued == [2, 3, 4]
    out = eng.run()
    assert sorted(out) == [0, 1, 2, 3, 4]
    assert eng.stats()["finished"] == 5 and eng.stats()["in_flight"] == 0


def test_host_key_matches_reference():
    from repro.serve.sampler_engine import _host_prng_key as jax_host_key

    for seed in (0, 1, 7, 2**31 - 1, 123456):
        assert (_host_prng_key(seed) == jax_host_key(seed)).all()


def test_unported_options_raise(samplers):
    _, got = samplers
    # mesh= is ported: the reference's two configuration errors remain
    with pytest.raises(ValueError, match="must divide the catalog size"):
        SamplerEngine(got, backend="mcmc",
                      mesh=make_sampler_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="whole leaf blocks"):
        SamplerEngine(got, mesh=make_sampler_mesh(devices=["cpu"] * 8))
    # telemetry= is ported (tests/test_torch_obs.py): an unknown
    # on_exhausted mode is the reference's configuration error
    with pytest.raises(ValueError, match="on_exhausted"):
        SamplerEngine(got, on_exhausted="explode")
    with pytest.raises(ValueError):
        SamplerEngine(object())
    with pytest.raises(ValueError):
        SamplerEngine(SpectralNDPP(Z=got.sp.Z, sigma=got.sp.sigma))
