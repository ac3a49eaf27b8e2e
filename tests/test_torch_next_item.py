"""The port's greedy MAP, next-item scores, conditional completions, MPR and
``NextItemServer`` against the reference (Gartrell et al. 2021 §4.2;
Appendix B.1).

On seeded kernels at M <= 16 the same inputs go through ``repro`` and
``repro_torch``: the conditional inner matrix W_J and the scores over all
items (rtol 1e-5, float32), greedy MAP's picks (equal, on a kernel whose
top two gains stay apart at every step), the completion masks under the
same keys (equal, one key and a stack, both key layouts) and their law
(chi-square against enumeration at M = 8, ``tests/_exactness.py``), the
hold-one-out percentiles and both MPRs (equal), ``randint`` with a
per-key bound (bit-equal to ``jax.vmap(jax.random.randint)``) and the
server's calls end to end.  On the CPU the scores go through the
``bilinear`` kernel's plain version and the draws through the
``cholesky_scan`` kernel's.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _exactness import assert_chi_square_close, histogram
from _torch_port import golden_key_layout
from repro.core import bilinear as jbil
from repro.core import map_inference as jmap
from repro.core.types import NDPPParams as JaxParams
from repro.core.types import dense_l as jax_dense_l
from repro.serve.next_item import NextItemServer as JaxServer
from repro_torch import random as trandom
from repro_torch.convert import baskets_from_numpy, params_from_numpy
from repro_torch.core import bilinear as tbil
from repro_torch.core import map_inference as tmap
from repro_torch.core.types import ONDPPParams
from repro_torch.serve.next_item import MPRReport, NextItemServer

RTOL, ATOL = 1e-5, 1e-6
M, K = 16, 4


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else a)


def _factors(m, k, seed, scale):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(m, k)) * scale).astype(np.float32),
            (rng.normal(size=(m, k)) * scale).astype(np.float32),
            rng.normal(size=(k, k)).astype(np.float32))


@pytest.fixture(scope="module")
def kernel():
    v, b, d = _factors(M, K, 808, 0.6)
    return (JaxParams(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d)),
            params_from_numpy(v, b, d, device="cpu"))


def _pad(obs, k_pad=5):
    items = np.full(k_pad, -1, np.int64)
    items[: len(obs)] = obs
    mask = np.zeros(k_pad, np.float32)
    mask[: len(obs)] = 1.0
    return ((jnp.asarray(items, jnp.int32), jnp.asarray(mask)),
            (torch.from_numpy(items), torch.from_numpy(mask)))


@pytest.fixture(scope="module")
def baskets():
    """30 padded baskets of 2-4 items (one empty) over the M items."""
    rng = np.random.default_rng(99)
    items = np.zeros((30, 4), np.int64)
    mask = np.zeros((30, 4), np.float32)
    for i in range(1, 30):
        size = int(rng.integers(2, 5))
        items[i, :size] = rng.choice(M, size=size, replace=False)
        mask[i, :size] = 1.0
    return ((jnp.asarray(items, jnp.int32), jnp.asarray(mask)),
            baskets_from_numpy(items, mask, device="cpu"))


# ---------------------------------------------------------- key schedule
@pytest.mark.parametrize("partitionable", [False, True])
def test_randint_per_key_bound_equals_vmapped_reference(partitionable):
    bounds = np.array([0, 1, 2, 3, 5, 7, 8, 100, 65535, 65536, 70001,
                       2 ** 31 - 1, -5, 1 << 20] * 4, np.int32)
    with jax.threefry_partitionable(partitionable):
        keys = jax.random.split(jax.random.PRNGKey(7), bounds.size)
        want = np.asarray(jax.vmap(
            lambda k, b: jax.random.randint(k, (), 0, b))(keys,
                                                          jnp.asarray(bounds)))
        want3 = np.asarray(jax.vmap(
            lambda k, b: jax.random.randint(k, (3,), 2, b))(
                keys, jnp.asarray(bounds)))
    with trandom.threefry_partitionable(partitionable):
        tk = trandom.as_key(np.asarray(keys))
        got = trandom.randint(tk, (), 0, torch.from_numpy(bounds))
        got3 = trandom.randint(tk, (3,), 2, torch.from_numpy(bounds)[:, None])
    assert np.array_equal(_np(got), want)
    assert np.array_equal(_np(got3), want3)


# ------------------------------------------------------------ the scores
def test_conditional_inner_matrix_equal(kernel):
    jp, tp = kernel
    (ji, jm), (ti, tm) = _pad([3, 11, 7])
    jz, jx = jmap._zx(jp)
    tz, tx = tmap._zx(tp)
    np.testing.assert_array_equal(_np(tx), np.asarray(jx))
    want = np.asarray(jbil.conditional_inner_matrix(jz[jnp.maximum(ji, 0)],
                                                    jm, jx))
    got = _np(tbil.conditional_inner_matrix(tz[ti.clamp_min(0)], tm, tx))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # W_J is not symmetric: the left factor is X Z_J^T
    assert np.abs(got - got.T).max() > 1e-2
    np.testing.assert_allclose(
        _np(tbil.conditional_scores(tz, tz[ti.clamp_min(0)], tm, tx)),
        np.asarray(jbil.conditional_scores(jz, jz[jnp.maximum(ji, 0)], jm,
                                           jx)), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("obs", [[], [4], [3, 11, 7], [0, 15, 2, 9, 5]])
def test_next_item_scores_equal(kernel, obs):
    jp, tp = kernel
    (ji, jm), (ti, tm) = _pad(obs)
    want = np.asarray(jmap.next_item_scores(jp, ji, jm))
    got = _np(tmap.next_item_scores(tp, ti, tm))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[obs]).all() and np.isneginf(got).sum() == len(obs)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-5)


def test_greedy_map_equal(kernel):
    jp, tp = kernel
    k = 6
    want = np.asarray(jmap.greedy_map(jp, k))
    # no near-ties: at each step the best gain is clear of the second
    obs = []
    for pick in want:
        (ji, jm), _ = _pad(obs, k)
        s = np.sort(np.asarray(jmap.next_item_scores(jp, ji, jm)))
        assert s[-1] - s[-2] > 1e-3 * abs(s[-1])
        obs.append(int(pick))
    got = tmap.greedy_map(tp, k)
    assert got.dtype == torch.int64
    assert np.array_equal(_np(got), want)


# ---------------------------------------------------------- completions
@pytest.mark.parametrize("partitionable", [False, True])
def test_conditional_sample_equal_masks(kernel, partitionable):
    jp, tp = kernel
    (ji, jm), (ti, tm) = _pad([1, 6, 12])
    with jax.threefry_partitionable(partitionable):
        keys = jax.random.split(jax.random.PRNGKey(3), 64)
        want = np.asarray(jax.vmap(
            lambda k: jmap.conditional_sample(jp, ji, jm, k))(keys))
        want0 = np.asarray(jmap.conditional_sample(jp, ji, jm, keys[0]))
    with trandom.threefry_partitionable(partitionable):
        tk = trandom.as_key(np.asarray(keys))
        got = tmap.conditional_sample(tp, ti, tm, tk)
        got0 = tmap.conditional_sample(tp, ti, tm, tk[0])
    assert got.shape == (64, M) and got0.shape == (M,)
    assert np.array_equal(_np(got), want)
    assert np.array_equal(_np(got0), want0)
    assert not _np(got)[:, [1, 6, 12]].any()
    assert want.any(axis=1).sum() > 10  # the draws really take items


def test_conditional_sample_matches_enumeration():
    """Completions S drawn with probability ∝ det(L_{J u S}): chi-square
    against the enumerated conditional at M = 8."""
    m, k = 8, 4
    v, b, d = _factors(m, k, 808, 0.6)
    tp = params_from_numpy(v, b, d, device="cpu")
    dense = np.asarray(jax_dense_l(JaxParams(*(jnp.asarray(a) for a in
                                               (v, b, d)))), np.float64)
    obs = (1, 6)
    rest = [i for i in range(m) if i not in obs]
    probs = {}
    for r in range(len(rest) + 1):
        for s in itertools.combinations(rest, r):
            ji = list(obs) + list(s)
            probs[s] = max(np.linalg.det(dense[np.ix_(ji, ji)]), 0.0)
    norm = sum(probs.values())
    probs = {s: p / norm for s, p in probs.items()}
    n = 4000
    _, (ti, tm) = _pad(obs)
    taken = _np(tmap.conditional_sample(
        tp, ti, tm, trandom.split(trandom.PRNGKey(3), n)))
    assert not taken[:, list(obs)].any()
    emp = histogram(np.broadcast_to(np.arange(m), taken.shape), taken)
    assert set(emp) <= set(probs)
    assert_chi_square_close(emp, probs, n)


# -------------------------------------------------------------------- MPR
def test_held_out_percentiles_and_mpr_equal(kernel, baskets):
    jp, tp = kernel
    (jitems, jmask), tb = baskets
    key = jax.random.PRNGKey(7)
    with golden_key_layout():
        want, usable = jmap._held_out_percentiles(
            lambda b, m: jmap.next_item_scores(jp, b, m), jitems, jmask, key)
        want_mpr = float(jmap.mean_percentile_rank(jp, jitems, jmask, key))
    got, t_usable = tmap._held_out_percentiles(
        lambda b, m: tmap.next_item_scores(tp, b, m), tb.items, tb.mask,
        np.asarray(key))
    assert np.array_equal(_np(t_usable), np.asarray(usable))
    assert not _np(t_usable)[0]  # the empty basket is left out
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    got_mpr = float(tmap.mean_percentile_rank(tp, tb.items, tb.mask,
                                              np.asarray(key)))
    np.testing.assert_allclose(got_mpr, want_mpr, rtol=1e-6)


def test_mpr_frequency_baseline_equal(baskets):
    (jitems, jmask), tb = baskets
    # ties in frequency are broken by item id
    freq = np.array([5, 1, 1, 3, 0, 7, 2, 2, 9, 1, 0, 4, 4, 6, 8, 3],
                    np.float32)
    key = jax.random.PRNGKey(11)
    with golden_key_layout():
        want = float(jmap.mpr_frequency_baseline(jnp.asarray(freq), jitems,
                                                 jmask, key))
    got = float(tmap.mpr_frequency_baseline(torch.from_numpy(freq),
                                            tb.items, tb.mask,
                                            np.asarray(key)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------- the server
def test_next_item_server_equals_reference(kernel, baskets):
    jp, tp = kernel
    (jitems, jmask), tb = baskets
    srv, jsrv = NextItemServer(tp, k_pad=6), JaxServer(jp, k_pad=6)
    assert srv.M == M and srv.device == torch.device("cpu")
    basket = [2, 9]
    s, js = _np(srv.scores(basket)), np.asarray(jsrv.scores(basket))
    fin = np.isfinite(js)
    assert np.array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], js[fin], rtol=1e-4, atol=1e-5)
    assert np.array_equal(srv.top_k(basket, 5), jsrv.top_k(basket, 5))
    assert len(srv.top_k(basket, 40)) == M - 2
    key = jax.random.PRNGKey(21)
    with golden_key_layout():
        want_one = jsrv.complete(basket, key)
        want_many = jsrv.complete_many(basket, key, 24)
        want_rep = jsrv.evaluate_mpr(jl_baskets(jitems, jmask), key)
    assert np.array_equal(srv.complete(basket, np.asarray(key)), want_one)
    got_many = srv.complete_many(basket, np.asarray(key), 24)
    assert len(got_many) == 24
    for g, w in zip(got_many, want_many):
        assert np.array_equal(g, w)
        assert not set(g) & set(basket)
    rep = srv.evaluate_mpr(tb, np.asarray(key))
    assert isinstance(rep, MPRReport) and rep.n_baskets == 30
    np.testing.assert_allclose(rep.model, want_rep.model, rtol=1e-6)
    np.testing.assert_allclose(rep.frequency, want_rep.frequency, rtol=1e-6)
    with pytest.raises(ValueError, match="k_pad"):
        srv.scores(list(range(7)))
    with pytest.raises(ValueError, match="item ids"):
        srv.scores([M])


def jl_baskets(items, mask):
    from repro.core.learning import Baskets

    return Baskets(items, mask)


def test_next_item_server_takes_ondpp_params():
    v, b, _ = _factors(M, K, 5, 0.5)
    sigma = np.array([0.7, 0.2], np.float32)
    on = ONDPPParams(*(torch.from_numpy(a) for a in (v, b, sigma)))
    srv = NextItemServer(on)
    assert torch.equal(srv.params.D, on.to_general().D)
    assert srv.top_k([], 3).shape == (3,)
