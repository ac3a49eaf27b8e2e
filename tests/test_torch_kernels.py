"""The port's plain kernel versions against the reference on the same
arrays (numpy-seeded inputs, both run on the CPU).

``block_outer_sums`` is held against both the reference's Pallas kernel in
interpret mode and its jnp oracle (rtol 1e-5, atol 1e-6: float32 sums in
another order).  ``descend_score`` is held against the reference's jnp
oracle, which is what the reference runs off the TPU; block ids must be
equal and scores within rtol 1e-5, atol 1e-6.  The CUDA kernels themselves
are held against these plain versions on the card (``test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (caps torch's CPU threads)

from repro.kernels.spec_round.ref import descend_score_ref as jax_descend_score
from repro.kernels.tree_sum import ops as jax_tree_sum
from repro.kernels.tree_sum.ref import block_outer_sums_ref as jax_outer_sums
from repro_torch.kernels.spec_round import ops as spec_ops
from repro_torch.kernels.spec_round import ref as spec_ref
from repro_torch.kernels.tree_sum import ops as tree_sum_ops


def random_tree_nodes(rng, depth, r):
    """A mass-consistent tree (random PSD leaves, parents the sum of their
    children) as per-level arrays, root first."""
    leaves = rng.normal(size=(1 << depth, r, r)).astype(np.float32)
    nodes = np.einsum("nik,njk->nij", leaves, leaves)
    levels = [nodes]
    for _ in range(depth):
        nodes = nodes.reshape(-1, 2, r, r).sum(axis=1)
        levels.append(nodes)
    return tuple(reversed(levels))


def descend_inputs(depth, block, r, n):
    rng = np.random.default_rng(depth * 1000 + block * 100 + r)
    levels = random_tree_nodes(rng, depth, r)
    w = rng.normal(size=((1 << depth) * block, r)).astype(np.float32)
    qh = rng.normal(size=(n, r, r)).astype(np.float32)
    q = (np.einsum("nik,njk->nij", qh, qh) / r).astype(np.float32)
    us = rng.uniform(size=(n, max(depth, 1))).astype(np.float32)
    return levels, w, q, us


@pytest.mark.parametrize("n,block,r", [(5, 4, 8), (8, 8, 16), (2, 16, 130),
                                       (3, 5, 33)])
def test_block_outer_sums_matches_reference(n, block, r):
    rng = np.random.default_rng(n * 100 + r)
    w = rng.normal(size=(n * block, r)).astype(np.float32)
    got = tree_sum_ops.block_outer_sums(torch.as_tensor(w), block).numpy()
    pallas = np.asarray(jax_tree_sum.block_outer_sums(
        jnp.asarray(w), block, force_interpret=True))
    oracle = np.asarray(jax_outer_sums(jnp.asarray(w), block))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


def test_block_outer_sums_writes_out():
    w = torch.as_tensor(np.random.default_rng(1).normal(
        size=(12, 6)).astype(np.float32))
    out = torch.empty((3, 6, 6))
    res = tree_sum_ops.block_outer_sums(w, 4, out=out)
    assert res is out
    assert torch.equal(out, tree_sum_ops.block_outer_sums(w, 4))
    with pytest.raises(ValueError):
        tree_sum_ops.block_outer_sums(w, 5)


@pytest.mark.parametrize("depth,block,r,n", [(3, 4, 8, 5), (5, 8, 16, 12),
                                             (6, 2, 40, 3), (2, 8, 130, 4),
                                             (0, 4, 8, 3), (7, 3, 12, 6)])
def test_descend_score_matches_reference(depth, block, r, n):
    levels, w, q, us = descend_inputs(depth, block, r, n)
    blk_ref, sc_ref = jax_descend_score(
        tuple(jnp.asarray(lv) for lv in levels), jnp.asarray(w), block,
        jnp.asarray(q), jnp.asarray(us))
    nodes = torch.as_tensor(np.concatenate(levels))
    launches = spec_ops.launches
    blk, sc = spec_ops.descend_score(nodes, torch.as_tensor(w), block,
                                     torch.as_tensor(q), torch.as_tensor(us))
    assert spec_ops.launches == launches   # the plain version is no launch
    np.testing.assert_array_equal(blk.numpy(), np.asarray(blk_ref))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_ref),
                               rtol=1e-5, atol=1e-6)


def test_descend_score_checks_shapes():
    levels, w, q, us = descend_inputs(3, 4, 8, 2)
    nodes = torch.as_tensor(np.concatenate(levels))
    with pytest.raises(ValueError):
        spec_ops.descend_score(nodes[1:], torch.as_tensor(w), 4,
                               torch.as_tensor(q), torch.as_tensor(us))
    with pytest.raises(ValueError):
        spec_ops.descend_score(nodes, torch.as_tensor(w), 4,
                               torch.as_tensor(q), torch.as_tensor(us[:, :2]))


@pytest.mark.parametrize("sms", [132, 20])
def test_descend_score_cluster_size(sms):
    """CTAs a lane: a power of two up to 8, the largest with N c <= the SM
    count (2 at the main path's 64 lanes on 132 SMs), and 1 once N
    reaches the SM count."""
    for n in range(1, 301):
        c = spec_ops.cluster_size(n, sms)
        assert c in (1, 2, 4, 8)
        assert c <= spec_ops.MAX_CLUSTER
        if n >= sms:
            assert c == 1
        else:
            assert n * c <= sms
            assert c == spec_ops.MAX_CLUSTER or n * 2 * c > sms
    assert spec_ops.cluster_size(64, 132) == 2


def test_shallow_max_matches_reference():
    from repro.kernels.spec_round import ref as jax_spec_ref

    assert spec_ref._SHALLOW_MAX == jax_spec_ref._SHALLOW_MAX


@pytest.mark.parametrize("r", [8, 225])
def test_quad_form_cpu_tensors_take_the_plain_versions(r):
    """``score_all`` and ``bilinear`` share ``csrc/quad_form.cuh``: on CPU
    tensors, at widths on either side of its resident route's limit (224),
    both go to their plain versions, agree with each other at C = 1, and
    move neither the total nor any route's launch count."""
    from repro_torch.kernels.bilinear import ops as bilinear_ops
    from repro_torch.kernels.mcmc_score import ops as score_ops

    assert score_ops.MAX_R == bilinear_ops.MAX_R == 512
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.normal(size=(5, r)).astype(np.float32))
    a = torch.as_tensor(rng.normal(size=(2, r, r)).astype(np.float32))
    counts = [(m.launches, m.resident_launches, m.panel_launches)
              for m in (score_ops, bilinear_ops)]
    torch.testing.assert_close(score_ops.score_all(z, a)[1],
                               bilinear_ops.bilinear(z, a[1]))
    assert counts == [(m.launches, m.resident_launches, m.panel_launches)
                      for m in (score_ops, bilinear_ops)]
