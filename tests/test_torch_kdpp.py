"""The port's fixed-size (k-NDPP) samplers against the reference.

The ESP tables are float32 recurrences in both, in another operation
order (rtol 1e-5; -inf in the same places in log space).  Fed the
reference's tree and keys, the size-k selections, the k-DPP draws and the
k-NDPP rejection results are equal, and every accepted draw has exactly k
items.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import golden_key_layout, port_sampler
from repro.core import kdpp as jax_kdpp
from repro.core import preprocess as jax_preprocess
from repro_torch import random as trandom
from repro_torch.core import (
    elementary_symmetric,
    elementary_symmetric_log,
    sample_fixed_size_e,
    sample_k_ndpp,
    sample_kdpp,
)


@pytest.fixture(scope="module")
def samplers():
    rng = np.random.default_rng(404)
    v = (rng.normal(size=(64, 4)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(64, 4)) * 0.5).astype(np.float32)
    d = rng.normal(size=(4, 4)).astype(np.float32)
    ref = jax_preprocess(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d),
                         block=4)
    return ref, port_sampler(ref)


@pytest.mark.parametrize("n,k,lo", [(7, 3, 0.1), (64, 10, 0.0),
                                    (512, 64, 0.5)])
def test_esp_tables_match_reference(n, k, lo):
    lam = np.random.default_rng(n).uniform(lo, 2.0, n).astype(np.float32)
    lam[:: 5] *= lo > 0          # exact zeros where lo = 0
    want = np.asarray(jax_kdpp.elementary_symmetric_log(jnp.asarray(lam), k))
    got = elementary_symmetric_log(torch.as_tensor(lam), k).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_kdpp.elementary_symmetric(jnp.asarray(lam), k))
    got = elementary_symmetric(torch.as_tensor(lam), k).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("k", [0, 1, 3, 8])
def test_fixed_size_selection_matches_reference(samplers, k):
    """Keys stacked (as ``vmap``) and one key; exactly k True each."""
    ref, got = samplers
    lam = ref.tree.lam
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(k), 32)
        want = np.asarray(jax.vmap(
            lambda kk: jax_kdpp.sample_fixed_size_e(lam, k, kk))(keys))
        port = sample_fixed_size_e(got.tree.lam, k,
                                   trandom.as_key(keys)).numpy()
        one = sample_fixed_size_e(got.tree.lam, k,
                                  trandom.as_key(keys[5])).numpy()
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(one, want[5])
    assert (port.sum(axis=1) == k).all()


@pytest.mark.parametrize("k", [1, 3, 6])
def test_kdpp_draws_match_reference(samplers, k):
    ref, got = samplers
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(30 + k), 8)
        for i in range(8):
            items_ref, mask_ref = jax_kdpp.sample_kdpp(ref.tree, k, keys[i])
            items, mask = sample_kdpp(got.tree, k, trandom.as_key(keys[i]))
            np.testing.assert_array_equal(items.numpy(),
                                          np.asarray(items_ref))
            np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
            assert int(mask.sum()) == k
        # a stack of keys is the same draws, row by row
        items, _ = sample_kdpp(got.tree, k, trandom.as_key(keys))
        np.testing.assert_array_equal(
            items[3].numpy(),
            np.asarray(jax_kdpp.sample_kdpp(ref.tree, k, keys[3])[0]))


@pytest.mark.parametrize("k,max_trials", [(2, 1000), (4, 1000), (4, 2)])
def test_k_ndpp_matches_reference(samplers, k, max_trials):
    """Items, masks, trials and accepted flags; accepted draws of size k,
    and the last proposal (still of size k) where the budget runs out."""
    ref, got = samplers
    with golden_key_layout():
        for seed in range(4):
            want = jax_kdpp.sample_k_ndpp(ref, k, jax.random.PRNGKey(seed),
                                          max_trials=max_trials)
            res = sample_k_ndpp(got, k, trandom.PRNGKey(seed),
                                max_trials=max_trials)
            for name in ("items", "mask", "trials", "accepted"):
                np.testing.assert_array_equal(
                    getattr(res, name).numpy(), np.asarray(getattr(want, name)),
                    err_msg=name)
            assert int(res.mask.sum()) == k
