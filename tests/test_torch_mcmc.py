"""The port's MCMC chains against the reference and against enumeration.

Tolerances, each with its reason:
- ``randint`` is integer arithmetic: bit-exact with ``jax.random.randint``;
- the O(K^2) ratio formulas and score matrices against float64 dense
  determinants: rel 1e-4 (ratios) and 1e-3 (score matrices), as
  ``tests/test_mcmc.py`` holds the reference;
- chain traces, greedy starts and engine results, on carried-across state
  and the same keys, must be equal: the port's float32 ratios and inverses
  round differently from XLA's, so a step could differ only where
  ``u < min(ratio, 1)`` is a near tie (none on these seeds);
- the stationary distributions: the chi-square and TV bars of
  ``tests/_exactness.py``;
- ``score_all``'s plain version against the reference's einsum: rtol 1e-5
  (the float32 tolerance of ``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _exactness import (
    assert_chi_square_close,
    enumerate_subset_probs,
    histogram,
    tv_to_probs,
)
from _torch_port import golden_key_layout, port_mcmc_states, port_spectral
from repro.core import mcmc as jax_mcmc
from repro.core.youla import spectral_from_params as jax_spectral
from repro.kernels.mcmc_score.ref import score_all_ref as jax_score_all_ref
from repro.serve.sampler_engine import SampleRequest as JaxRequest
from repro.serve.sampler_engine import SamplerEngine as JaxEngine
from repro_torch import random as trandom
from repro_torch.core import mcmc
from repro_torch.core.types import dense_l_spectral
from repro_torch.kernels.mcmc_score import ops as score_ops
from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

M, K = 8, 4
N_SAMPLES = 6000


@pytest.fixture(scope="module")
def jax_sp():
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(M, K)) * 0.6, jnp.float32)
    b = jnp.asarray(rng.normal(size=(M, K)) * 0.6, jnp.float32)
    d = jnp.asarray(rng.normal(size=(K, K)), jnp.float32)
    return jax_spectral(v, b, d)


@pytest.fixture(scope="module")
def sp(jax_sp):
    return port_spectral(jax_sp)


@pytest.fixture(scope="module")
def wide():
    """M = 16 items for the trace comparisons (the reference's spectral
    form, carried across)."""
    rng = np.random.default_rng(16)
    v = jnp.asarray(rng.normal(size=(16, K)) * 0.5, jnp.float32)
    b = jnp.asarray(rng.normal(size=(16, K)) * 0.5, jnp.float32)
    d = jnp.asarray(rng.normal(size=(K, K)), jnp.float32)
    ref = jax_spectral(v, b, d)
    return ref, port_spectral(ref)


def _state_for(sp, subsets):
    r = sp.Z.shape[1]
    items = -np.ones((len(subsets), r), np.int64)
    mask = np.zeros((len(subsets), r), bool)
    for c, subset in enumerate(subsets):
        for s, it in enumerate(subset):
            items[c, s], mask[c, s] = it, True
    st = mcmc.MCMCState(torch.as_tensor(items), torch.as_tensor(mask),
                        torch.eye(r).repeat(len(subsets), 1, 1),
                        torch.zeros(len(subsets), dtype=torch.int64))
    return mcmc.refresh(sp, st)


def _det(L, y):
    y = sorted(y)
    return np.linalg.det(L[np.ix_(y, y)]) if y else 1.0


@pytest.mark.parametrize("lo,hi", [(0, 16), (0, 1 << 20), (0, 1000003),
                                   (-5, 7), (3, 3), (0, 2**31 - 1),
                                   (-2**31, 2**31 - 1)])
def test_randint_bit_exact(lo, hi):
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(3), 64)
        want = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (5,), lo, hi))(keys))
        one = np.asarray(jax.random.randint(keys[0], (), lo, hi))
    tkeys = torch.as_tensor(np.asarray(keys).astype(np.int64))
    np.testing.assert_array_equal(trandom.randint(tkeys, (5,), lo, hi).numpy(),
                                  want)
    assert int(trandom.randint(tkeys[0], (), lo, hi)) == int(one)


def test_ratios_match_dense_determinants(sp):
    L = dense_l_spectral(sp).double().numpy()
    y = [1, 3, 6]
    st = _state_for(sp, [y])
    one = lambda i: torch.tensor([i])  # noqa: E731
    assert float(mcmc.add_ratio(sp, st, one(0))) == pytest.approx(
        _det(L, y + [0]) / _det(L, y), rel=1e-4)
    assert float(mcmc.remove_ratio(st, one(1))) == pytest.approx(
        _det(L, [1, 6]) / _det(L, y), rel=1e-4)
    assert float(mcmc.swap_ratio(sp, st, one(2), one(5))) == pytest.approx(
        _det(L, [1, 3, 5]) / _det(L, y), rel=1e-4)


def test_score_matrices_match_dense(sp):
    L = dense_l_spectral(sp).double().numpy()
    y = [1, 3, 6]
    st = _state_for(sp, [y])
    adds = score_ops.score_all(sp.Z, mcmc.score_matrix(sp, st))[0].numpy()
    a_sw = mcmc.swap_score_matrix(sp, st, torch.tensor([0]))  # slot 0: item 1
    swaps = score_ops.score_all(sp.Z, a_sw)[0].numpy()
    base = _det(L, y)
    for j in range(M):
        if j in y:
            continue
        assert adds[j] == pytest.approx(_det(L, y + [j]) / base, rel=1e-3)
        assert swaps[j] == pytest.approx(_det(L, [3, 6, j]) / base, rel=1e-3)


@pytest.mark.parametrize("c,m,r", [(1, 8, 8), (3, 37, 8), (8, 100, 16)])
def test_score_all_ref_matches_reference(c, m, r):
    rng = np.random.default_rng(c * 100 + m)
    z = rng.normal(size=(m, r)).astype(np.float32)
    a = rng.normal(size=(c, r, r)).astype(np.float32)
    got = score_ops.score_all(torch.as_tensor(z), torch.as_tensor(a)).numpy()
    want = np.asarray(jax_score_all_ref(jnp.asarray(z), jnp.asarray(a)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_cache_updates_track_fresh_inverse(sp):
    """A long random add/remove/swap walk keeps the rank-1-updated inverse
    within float32 drift of a fresh inverse."""
    st = mcmc.init_empty(sp, 3)
    x = sp.x_matrix()
    keys = trandom.split(trandom.PRNGKey(0), 3)
    steps = torch.arange(200)[None, :].repeat(3, 1)
    noise = mcmc._step_noise(keys, steps, M, sp.Z.shape[1])
    for t in range(200):
        st, _ = mcmc._mh_step(sp.Z, x, st, mcmc._Noise(*(f[:, t] for f in noise)),
                              fixed=False, p_swap=0.3)
    fresh = mcmc.refresh(sp, st)
    assert float((st.minv - fresh.minv).abs().max()) < 1e-3
    sign, _ = torch.linalg.slogdet(mcmc._padded_l(sp.Z, x, st.items, st.mask))
    assert bool((sign > 0).all())


@pytest.mark.parametrize("fixed", [False, True])
def test_run_chains_traces_match_reference(wide, fixed):
    """C = 4 chains, 256 steps in two calls of 128 (the refresh period 64
    divides both), M = 16: every step's subset and acceptance equal the
    reference's.  The fixed-size chain starts from the reference's greedy
    states, carried across."""
    ref_sp, sp = wide
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(8), 4)
        if fixed:
            states0 = jax_mcmc.init_greedy(ref_sp, jax.random.PRNGKey(2), 4, 3)
        else:
            states0 = jax.vmap(lambda _: jax_mcmc.init_empty(ref_sp))(
                jnp.arange(4))
        want = []
        st = states0
        for _ in range(2):
            st, it, mk, ac = jax_mcmc.run_chains(ref_sp, keys, st,
                                                 n_steps=128, fixed=fixed)
            want.append((np.asarray(it), np.asarray(mk), np.asarray(ac)))
    tkeys = torch.as_tensor(np.asarray(keys).astype(np.int64))
    st = port_mcmc_states(states0)
    for w_it, w_mk, w_ac in want:
        st, it, mk, ac = mcmc.run_chains(sp, tkeys, st, n_steps=128,
                                         fixed=fixed)
        np.testing.assert_array_equal(ac.numpy(), w_ac)
        np.testing.assert_array_equal(mk.numpy(), w_mk)
        np.testing.assert_array_equal(torch.where(mk, it, -1).numpy(),
                                      np.where(w_mk, w_it, -1))
    assert int(st.step[0]) == 256
    assert 0.05 < float(np.mean([w[2].mean() for w in want])) < 0.95


def test_mcmc_updown_stationarity(sp):
    probs = enumerate_subset_probs(dense_l_spectral(sp).double().numpy())
    res = mcmc.sample_mcmc(sp, trandom.PRNGKey(0), N_SAMPLES, n_chains=128,
                           burn_in=384, thin=8)
    assert 0.05 < float(res.accept_rate) < 0.95
    emp = histogram(res.items.numpy(), res.mask.numpy())
    assert set(emp) <= set(probs)
    assert tv_to_probs(emp, probs, N_SAMPLES) < 0.06
    assert_chi_square_close(emp, probs, N_SAMPLES, n_sigma=6.0)


def test_mcmc_swap_stationarity_kndpp(sp):
    kk = 3
    probs = enumerate_subset_probs(dense_l_spectral(sp).double().numpy(),
                                   size=kk)
    res = mcmc.sample_mcmc(sp, trandom.PRNGKey(1), N_SAMPLES, k=kk,
                           n_chains=128, burn_in=384, thin=8)
    assert bool((res.mask.sum(1) == kk).all())
    emp = histogram(res.items.numpy(), res.mask.numpy())
    assert set(emp) <= set(probs)
    assert tv_to_probs(emp, probs, N_SAMPLES) < 0.06
    assert_chi_square_close(emp, probs, N_SAMPLES, n_sigma=6.0)


def test_greedy_init_matches_reference(wide):
    """Greedy starts equal the reference's (items and masks), each of size
    k with det(L_Y) > 0 and a consistent cached inverse (atol 1e-3, as the
    reference's test)."""
    ref_sp, sp = wide
    with golden_key_layout():
        want = jax_mcmc.init_greedy(ref_sp, jax.random.PRNGKey(2), 16, 3)
    got = mcmc.init_greedy(sp, trandom.PRNGKey(2), 16, 3)
    np.testing.assert_array_equal(got.items.numpy(), np.asarray(want.items))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert bool((got.mask.sum(1) == 3).all())
    x = sp.x_matrix()
    ly = mcmc._padded_l(sp.Z, x, got.items, got.mask)
    sign, _ = torch.linalg.slogdet(ly)
    assert bool((sign > 0).all())
    np.testing.assert_allclose((got.minv @ ly).numpy(),
                               np.broadcast_to(np.eye(sp.Z.shape[1]),
                                               ly.shape), atol=1e-3)


def _serve(engine_cls, request_cls, sp, n_slots, steps_per_tick, k=None):
    eng = engine_cls(sp, n_slots=n_slots, backend="mcmc", mcmc_burn_in=64,
                     mcmc_thin=8, mcmc_steps_per_tick=steps_per_tick,
                     mcmc_k=k)
    for i in range(7):
        eng.submit(request_cls(rid=i, seed=100 + i))
    return eng.run()


@pytest.mark.parametrize("k", [None, 3])
def test_engine_mcmc_matches_reference(wide, k):
    """backend='mcmc': every rid equals the reference engine's, and the
    draw does not depend on tick size or pool size."""
    ref_sp, sp = wide
    with golden_key_layout():
        want = _serve(JaxEngine, JaxRequest, ref_sp, 3, 32, k)
    got = _serve(SamplerEngine, SampleRequest, sp, 3, 32, k)
    assert sorted(got) == list(range(7))
    for i in range(7):
        np.testing.assert_array_equal(got[i].items, np.asarray(want[i].items))
        np.testing.assert_array_equal(got[i].mask, np.asarray(want[i].mask))
        assert got[i].accepted and got[i].trials == 72 == want[i].trials
        if k is not None:
            assert int(got[i].mask.sum()) == k
    other = _serve(SamplerEngine, SampleRequest, sp, 2, 16, k)
    for i in range(7):
        np.testing.assert_array_equal(other[i].items, got[i].items)
        np.testing.assert_array_equal(other[i].mask, got[i].mask)
