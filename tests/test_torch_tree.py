"""Preprocessing and the batched tree sampler of the port against the
reference, stage by stage, on the same numpy-seeded inputs.

Youla runs the same float64 numpy arithmetic in both (1e-6); the proposal
eigens are float32 eigh in both (lam rtol 1e-4, W atol 1e-4 up to column
sign); the tree is a float32 sum in another order (rtol 1e-5).  The
proposal draws, fed bit-identical trees and keys, must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import golden_key_layout, port_sampler
from repro.core import preprocess as jax_preprocess
from repro.core import tree as jax_tree
from repro.core.types import SpectralNDPP as JaxSpectral
from repro.core.types import dense_l_hat as jax_dense_l_hat
from repro.core.youla import youla_decompose_np as jax_youla
from repro_torch import random as trandom
from repro_torch.core import preprocess, tree
from repro_torch.core.types import (
    NDPPParams,
    SpectralNDPP,
    dense_l,
    dense_l_hat,
    dense_l_spectral,
)
from repro_torch.core.youla import spectral_from_params, youla_decompose_np

M, K = 100, 4


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(2024)
    v = (rng.normal(size=(M, K)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(M, K)) * 0.3).astype(np.float32)
    d = rng.normal(size=(K, K)).astype(np.float32)
    return v, b, d


def test_youla_matches_reference(factors):
    _, b, d = factors
    sig, y = youla_decompose_np(b, d)
    sig_ref, y_ref = jax_youla(b, d)
    np.testing.assert_allclose(sig, sig_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y, y_ref, rtol=1e-6, atol=1e-6)
    v, b, d = factors
    sp = spectral_from_params(v, b, d, device="cpu")
    z_ref = np.concatenate([v, y_ref.astype(np.float32)], axis=1)
    np.testing.assert_allclose(sp.Z.numpy(), z_ref, rtol=1e-6, atol=1e-6)


def test_proposal_eigens_match_reference(factors):
    v, b, d = factors
    sp = spectral_from_params(v, b, d, device="cpu")
    lam, w = tree.proposal_eigens(sp)
    lam_ref, w_ref = jax_tree.proposal_eigens(
        JaxSpectral(Z=jnp.asarray(sp.Z.numpy()),
                    sigma=jnp.asarray(sp.sigma.numpy())))
    lam_ref, w_ref = np.asarray(lam_ref), np.asarray(w_ref)
    np.testing.assert_allclose(lam.numpy(), lam_ref, rtol=1e-4, atol=1e-6)
    w = w.numpy()
    sign = np.where(np.sum(w * w_ref, axis=0) < 0, -1.0, 1.0)
    np.testing.assert_allclose(w * sign, w_ref, atol=1e-4)


@pytest.mark.parametrize("m,block", [(100, 4), (64, 8), (5, 8)])
def test_construct_tree_matches_reference(m, block):
    rng = np.random.default_rng(m + block)
    lam = rng.uniform(size=6).astype(np.float32)
    w = rng.normal(size=(m, 6)).astype(np.float32)
    ref = jax_tree.construct_tree(jnp.asarray(lam), jnp.asarray(w), block)
    got = tree.construct_tree(torch.as_tensor(lam), torch.as_tensor(w), block)
    assert got.depth == ref.depth and got.M == m
    np.testing.assert_array_equal(got.W.numpy(), np.asarray(ref.W))
    for lv, lv_ref in zip(got.levels, ref.levels):
        np.testing.assert_allclose(lv.numpy(), np.asarray(lv_ref),
                                   rtol=1e-5, atol=1e-6)


def test_preprocess_matches_reference(factors):
    v, b, d = factors
    got = preprocess(v, b, d, block=4, device="cpu")
    ref = jax_preprocess(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d),
                         block=4)
    np.testing.assert_allclose(got.tree.lam.numpy(), np.asarray(ref.tree.lam),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.tree.nodes[0].numpy(),
                               np.asarray(ref.tree.levels[0][0]),
                               rtol=1e-4, atol=1e-5)


def test_entry_points_need_cuda_or_cpu(factors, monkeypatch):
    v, b, d = factors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preprocess(v, b, d, block=4)
    assert preprocess(v, b, d, block=4, device="cpu").M == M


@pytest.fixture(scope="module")
def samplers(factors):
    v, b, d = factors
    ref = jax_preprocess(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d),
                         block=4)
    return ref, port_sampler(ref)


def test_sample_elementary_batch_matches_reference(samplers):
    ref, got = samplers
    r = got.tree.R
    rng = np.random.default_rng(5)
    e_masks = rng.uniform(size=(16, r)) < 0.5
    e_masks[0] = False                       # an empty proposal
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(6), 16)
        items_ref, mask_ref = jax_tree.sample_elementary_batch(
            ref.tree, jnp.asarray(e_masks), keys)
        items, mask = tree.sample_elementary_batch(
            got.tree, torch.as_tensor(e_masks), trandom.as_key(keys))
    np.testing.assert_array_equal(items.numpy(), np.asarray(items_ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))


def test_sample_proposal_dpp_batch_matches_reference(samplers):
    ref, got = samplers
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(7), 64)
        items_ref, _ = jax_tree.sample_proposal_dpp_batch(ref.tree, keys)
        items, _ = tree.sample_proposal_dpp_batch(got.tree,
                                                  trandom.as_key(keys))
    np.testing.assert_array_equal(items.numpy(), np.asarray(items_ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_elementary_matches_reference(samplers, seed):
    """The single draw equals the reference's (its own descent, which
    re-reads each parent) and row 0 of the batched draw on the same key."""
    ref, got = samplers
    r = got.tree.R
    e_mask = np.random.default_rng(seed).uniform(size=r) < 0.6
    with golden_key_layout():
        key = jax.random.PRNGKey(40 + seed)
        items_ref, mask_ref = jax_tree.sample_elementary(
            ref.tree, jnp.asarray(e_mask), key)
        items, mask = tree.sample_elementary(
            got.tree, torch.as_tensor(e_mask), trandom.as_key(key))
        batch, _ = tree.sample_elementary_batch(
            got.tree, torch.as_tensor(e_mask)[None], trandom.as_key(key)[None])
    np.testing.assert_array_equal(items.numpy(), np.asarray(items_ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    np.testing.assert_array_equal(items.numpy(), batch[0].numpy())


def test_sample_proposal_dpp_matches_reference(samplers):
    ref, got = samplers
    with golden_key_layout():
        for seed in range(6):
            items_ref, _ = jax_tree.sample_proposal_dpp(
                ref.tree, jax.random.PRNGKey(seed))
            items, _ = tree.sample_proposal_dpp(got.tree,
                                                trandom.PRNGKey(seed))
            np.testing.assert_array_equal(items.numpy(),
                                          np.asarray(items_ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_elementary_dense_matches_reference(samplers, seed):
    """The treeless oracle on the reference's eigenvector rows (scores
    through ``bilinear``'s plain version on the CPU): the same items."""
    ref, got = samplers
    r = got.tree.R
    e_mask = np.random.default_rng(10 + seed).uniform(size=r) < 0.6
    with golden_key_layout():
        key = jax.random.PRNGKey(50 + seed)
        items_ref, mask_ref = jax_tree.sample_elementary_dense(
            ref.tree.W[:M], jnp.asarray(e_mask), key)
        items, mask = tree.sample_elementary_dense(
            got.tree.W[:M], torch.as_tensor(e_mask), trandom.as_key(key))
    np.testing.assert_array_equal(items.numpy(), np.asarray(items_ref))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_ref))
    assert int(mask.sum()) == int(e_mask.sum())


def test_spectral_types_match_reference():
    sigma = np.array([0.5, 2.0], np.float32)
    sp = SpectralNDPP(Z=torch.zeros(3, 8), sigma=torch.as_tensor(sigma))
    ref = JaxSpectral(Z=jnp.zeros((3, 8)), sigma=jnp.asarray(sigma))
    np.testing.assert_array_equal(sp.x_matrix().numpy(),
                                  np.asarray(ref.x_matrix()))
    np.testing.assert_array_equal(sp.x_diag_hat().numpy(),
                                  np.asarray(ref.x_diag_hat()))


def test_spectral_form_factors_the_kernel(factors):
    """Z X Z^T from the port's Youla equals V V^T + B (D - D^T) B^T
    (float32, atol 1e-5), and Lhat matches the reference's on the same
    spectral form."""
    v, b, d = factors
    sp = spectral_from_params(v, b, d, device="cpu")
    want = dense_l(NDPPParams(*(torch.as_tensor(a) for a in (v, b, d))))
    np.testing.assert_allclose(dense_l_spectral(sp).numpy(), want.numpy(),
                               atol=1e-5)
    ref = jax_dense_l_hat(JaxSpectral(Z=jnp.asarray(sp.Z.numpy()),
                                      sigma=jnp.asarray(sp.sigma.numpy())))
    np.testing.assert_allclose(dense_l_hat(sp).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_params_from_numpy(factors, monkeypatch):
    from repro_torch.convert import params_from_numpy

    v, b, d = factors
    p = params_from_numpy(v.astype(np.float64), b, d, device="cpu")
    assert p.V.dtype == torch.float32 and (p.M, p.K) == (M, K)
    np.testing.assert_array_equal(p.B.numpy(), b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(v, b, d)
