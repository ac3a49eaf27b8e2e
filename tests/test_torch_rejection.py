"""The port's speculative rejection sampler against the reference.

With the reference sampler's state carried across (``sampler_from_numpy``)
the port must reproduce the reference's draws exactly — items, masks,
trial counts and accept flags — both live and as pinned in
``tests/golden/rejection.json``.  On its own preprocessing it must sample
the exact NDPP distribution (chi-square against enumeration, as
``tests/test_batched_sampler.py``) at Theorem 2's trial rate.
"""
import contextlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _exactness import assert_chi_square_close, enumerate_subset_probs, histogram
from _torch_port import golden_key_layout, port_sampler
from repro.core import init_ondpp
from repro.core import preprocess as jax_preprocess
from repro.core import sample_batched_many as jax_sample_batched_many
from repro.core import rejection as jax_rejection
from repro.core.rejection import det_ratio_exact as jax_det_ratio_exact
from repro.core.rejection import log_det_ratio_batch as jax_log_det_ratio_batch
from repro_torch import random as trandom
from repro_torch.core import (
    NDPPParams,
    construct_tree,
    d_from_sigma,
    dense_l,
    det_ratio_exact,
    expected_trials,
    log_det_ratio_batch,
    preprocess,
    proposal_eigens,
    sample,
    sample_batch,
    sample_batched,
    sample_batched_many,
    spectral_from_params,
)
from repro_torch.core.rejection import NDPPSampler, drive_rounds
from repro_torch.core.rejection import _spec_round_impl as _spec_round

GOLDEN = pathlib.Path(__file__).parent / "golden" / "rejection.json"


def golden_frozen_kernel():
    """``tests/test_golden.py::frozen_kernel`` (M=256, K=4) as numpy."""
    rng = np.random.default_rng(31415)
    v = (rng.normal(size=(256, 4)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(256, 4)) * 0.1).astype(np.float32)
    d = rng.normal(size=(4, 4)).astype(np.float32)
    return v, b, d


def as_payload(res):
    return {
        "items": np.asarray(res.items).tolist(),
        "mask": np.asarray(res.mask).astype(int).tolist(),
        "trials": np.asarray(res.trials).tolist(),
        "accepted": np.asarray(res.accepted).astype(int).tolist(),
    }


@pytest.fixture(scope="module")
def golden_samplers():
    v, b, d = golden_frozen_kernel()
    ref = jax_preprocess(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d),
                         block=4)
    return ref, port_sampler(ref)


def test_golden_rejection_draws(golden_samplers):
    """Bit-identical state -> bit-identical draws, live and pinned."""
    ref, got = golden_samplers
    with golden_key_layout():
        live = as_payload(jax_sample_batched_many(
            ref, jax.random.PRNGKey(0), 8, n_spec=4, max_trials=100))
        port = as_payload(sample_batched_many(
            got, trandom.PRNGKey(0), 8, n_spec=4, max_trials=100))
    assert port == live
    assert port == json.loads(GOLDEN.read_text())


def test_rejection_draws_in_partitionable_layout(golden_samplers):
    """Under ``jax_threefry_partitionable=True`` (jax's default) on both
    sides, the draws equal the reference's, run live."""
    ref, got = golden_samplers
    with jax.threefry_partitionable(True), \
            trandom.threefry_partitionable(True):
        live = as_payload(jax_sample_batched_many(
            ref, jax.random.PRNGKey(5), 8, n_spec=4, max_trials=100))
        port = as_payload(sample_batched_many(
            got, trandom.PRNGKey(5), 8, n_spec=4, max_trials=100))
    assert port == live


@pytest.mark.parametrize("n_spec,max_trials", [(4, 10), (2, 3), (8, 100)])
def test_driver_matches_reference_with_exhaustion(golden_samplers, n_spec,
                                                  max_trials):
    """Budgets that are not a multiple of the round width, including
    exhausted requests (the last-in-budget payout)."""
    ref, got = golden_samplers
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(42), 24)
        live = as_payload(jax_sample_batched_many(
            ref, keys, n_spec=n_spec, max_trials=max_trials,
            split_keys=False))
        port = as_payload(sample_batched_many(
            got, trandom.as_key(keys), n_spec=n_spec, max_trials=max_trials,
            split_keys=False))
    assert port == live


def test_log_det_ratio_matches_reference(golden_samplers):
    ref, got = golden_samplers
    rng = np.random.default_rng(3)
    items = np.stack([rng.permutation(256)[:8] for _ in range(32)])
    mask = rng.uniform(size=(32, 8)) < 0.6
    items = np.where(mask, items, -1).astype(np.int32)
    lr_ref, sg_ref = jax_log_det_ratio_batch(ref.sp, jnp.asarray(items),
                                             jnp.asarray(mask))
    lr, sg = log_det_ratio_batch(got.sp, torch.as_tensor(items).long(),
                                 torch.as_tensor(mask))
    np.testing.assert_allclose(lr.numpy(), np.asarray(lr_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(sg_ref))
    np.testing.assert_allclose(float(det_ratio_exact(got.sp)),
                               float(jax_det_ratio_exact(ref.sp)), rtol=1e-5)


def test_unported_options_raise(golden_samplers):
    _, got = golden_samplers
    # mesh= is ported: a mesh without the sampler's "model" axis is the
    # reference's configuration error
    with pytest.raises(ValueError, match="'model' axis"):
        sample_batched_many(got, trandom.PRNGKey(0), 2, mesh=object())
    # observer= is ported: an observer is duck-typed, and one without
    # ``on_round`` fails where the reference's does
    with pytest.raises(AttributeError, match="on_round"):
        sample_batched_many(got, trandom.PRNGKey(0), 2, observer=object())


def fields_equal(port, ref):
    for name in ("items", "mask", "trials", "accepted"):
        np.testing.assert_array_equal(
            np.asarray(getattr(port, name)), np.asarray(getattr(ref, name)),
            err_msg=name)


@pytest.mark.parametrize("seed,max_trials", [(4, 1000), (4, 2), (13, 1000),
                                             (2, 1)])
def test_sequential_sample_matches_reference(golden_samplers, seed,
                                             max_trials):
    """``sample`` (the reference's while loop over one request), exhausted
    budgets included."""
    ref, got = golden_samplers
    with golden_key_layout():
        fields_equal(sample(got, trandom.PRNGKey(seed), max_trials),
                     jax_rejection.sample(ref, jax.random.PRNGKey(seed),
                                          max_trials))


@pytest.mark.parametrize("n,max_trials", [(16, 1000), (16, 3), (1, 1000)])
def test_sample_batch_matches_reference(golden_samplers, n, max_trials):
    """``sample_batch`` equals ``vmap(sample)`` over ``split(key, n)``."""
    ref, got = golden_samplers
    with golden_key_layout():
        fields_equal(
            sample_batch(got, trandom.PRNGKey(9), n, max_trials),
            jax_rejection.sample_batch(ref, jax.random.PRNGKey(9), n,
                                       max_trials))


@pytest.mark.parametrize("n_spec,grow,max_trials", [(None, 2, 1000),
                                                    (2, 2, 5), (1, 3, 1000)])
def test_sample_batched_matches_reference(golden_samplers, n_spec, grow,
                                          max_trials):
    ref, got = golden_samplers
    with golden_key_layout():
        for seed in (11, 12):
            fields_equal(
                sample_batched(got, trandom.PRNGKey(seed), n_spec=n_spec,
                               max_trials=max_trials, grow=grow),
                jax_rejection.sample_batched(
                    ref, jax.random.PRNGKey(seed), n_spec=n_spec,
                    max_trials=max_trials, grow=grow))


class RecordingObserver:
    """Every call of the observed driver's hooks, in order."""

    def __init__(self):
        self.calls = []

    def on_round(self, **kw):
        self.calls.append(("round", kw))

    def on_retire(self, **kw):
        self.calls.append(("retire", kw))

    def phase(self, name):
        self.calls.append(("phase", name))
        return contextlib.nullcontext()


@pytest.mark.parametrize("n_spec,grow,max_spec,max_trials",
                         [(2, 2, 64, 1000), (1, 3, 4, 1000), (4, 2, 64, 6),
                          (2, 1, 2, 3)])
def test_observed_driver_matches_reference(golden_samplers, n_spec, grow,
                                           max_spec, max_trials):
    """``sample_batched_many(observer=)`` runs ``drive_rounds``: results
    equal the fused path's per rid and the reference's observed path's,
    and the hooks get the reference's calls in the reference's order."""
    ref, got = golden_samplers
    kw = dict(n_spec=n_spec, max_trials=max_trials)
    with golden_key_layout():
        want_obs, port_obs = RecordingObserver(), RecordingObserver()
        want = jax_sample_batched_many(
            ref, jax.random.PRNGKey(0), 24, grow=grow, max_spec=max_spec,
            observer=want_obs, **kw)
        port = sample_batched_many(
            got, trandom.PRNGKey(0), 24, grow=grow, max_spec=max_spec,
            observer=port_obs, **kw)
        fused = sample_batched_many(got, trandom.PRNGKey(0), 24, **kw)
    fields_equal(port, want)
    fields_equal(port, fused)
    assert port_obs.calls == want_obs.calls
    assert sum(c[0] == "retire" for c in port_obs.calls) == 24


def test_drive_rounds_without_observer_equals_fused(golden_samplers):
    """``drive_rounds`` called directly, no observer: the fused path's
    results for the same request keys."""
    _, got = golden_samplers
    req_keys = trandom.split(trandom.PRNGKey(8), 10)
    res = drive_rounds(lambda k: _spec_round(got, k), req_keys, got.tree.R,
                       n_spec=2, max_trials=50)
    fields_equal(res, sample_batched_many(got, req_keys, n_spec=2,
                                          max_trials=50, split_keys=False))


M_EXACT, K_EXACT, N_SAMPLES = 8, 4, 8000


def test_port_preprocess_samples_exact_distribution():
    """The port's own preprocessing (M=8) samples Pr(Y) ∝ det(L_Y):
    chi-square against the enumerated distribution."""
    rng = np.random.default_rng(8)
    v = (rng.normal(size=(M_EXACT, K_EXACT)) * 0.6).astype(np.float32)
    b = (rng.normal(size=(M_EXACT, K_EXACT)) * 0.6).astype(np.float32)
    d = rng.normal(size=(K_EXACT, K_EXACT)).astype(np.float32)
    sampler = preprocess(v, b, d, block=2, device="cpu")
    res = sample_batched_many(sampler, trandom.PRNGKey(3), N_SAMPLES, n_spec=4)
    assert bool(res.accepted.all())
    emp = histogram(res.items.numpy(), res.mask.numpy())
    probs = enumerate_subset_probs(dense_l(NDPPParams(
        torch.as_tensor(v, dtype=torch.float64),
        torch.as_tensor(b, dtype=torch.float64),
        torch.as_tensor(d, dtype=torch.float64))).numpy())
    assert set(emp) <= set(probs)
    assert_chi_square_close(emp, probs, N_SAMPLES)


def test_trials_match_expected_ondpp():
    """For an ONDPP kernel the mean trial count matches Theorem 2's
    det(Lhat+I)/det(L+I) within 10%."""
    p = init_ondpp(jax.random.PRNGKey(7), 64, 4)
    sigma = torch.tensor(np.asarray(p.sigma))
    sp = spectral_from_params(np.asarray(p.V), np.asarray(p.B),
                              d_from_sigma(sigma), device="cpu")
    lam, w = proposal_eigens(sp)
    sampler = NDPPSampler(sp=sp, tree=construct_tree(lam, w, block=8))
    res = sample_batched_many(sampler, trandom.PRNGKey(8), 2000, n_spec=4)
    assert bool(res.accepted.all())
    expect = float(expected_trials(sp))
    assert expect == pytest.approx(float(det_ratio_exact(sp)), rel=1e-3)
    assert float(res.trials.double().mean()) == pytest.approx(expect, rel=0.1)
