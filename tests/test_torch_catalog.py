"""The port's dynamic catalog against the reference, and its own invariants.

Tolerances, each with its reason:
- the Youla transform is the same float64 numpy arithmetic on both sides
  (1e-10); Z = [V, B T] is a float32 product that the two frameworks may
  round differently (1e-6);
- the gathered Grams and the maintained tree are bit-equal to a rebuild
  within the port (the catalog's invariant), and the draws, fed
  carried-across state and the same keys, are equal item for item;
- the port's update of a carried-across reference tree leaves untouched
  nodes bit-equal and recomputed nodes within the float32 sum-order
  tolerance of ``test_torch_tree.py`` (rtol 1e-5);
- the stale-snapshot distribution is held by the chi-square bar of
  ``tests/_exactness.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _exactness import assert_chi_square_close, enumerate_subset_probs, histogram
from _torch_port import golden_key_layout, port_catalog_state
from repro.core import tree as jax_tree
from repro.core.dynamic import sample_dynamic_many as jax_sample_dynamic_many
from repro.core.youla import spectral_from_transform as jax_from_transform
from repro.core.youla import youla_transform_np as jax_transform
from repro.serve.catalog import Catalog as JaxCatalog
from repro.serve.sampler_engine import SampleRequest as JaxRequest
from repro.serve.sampler_engine import SamplerEngine as JaxEngine
from repro_torch import random as trandom
from repro_torch.convert import tree_from_numpy
from repro_torch.core import mcmc
from repro_torch.core.dynamic import (
    dual_rows,
    expected_trials_dynamic,
    sample_dynamic_many,
)
from repro_torch.core.tree import construct_tree, update_rows
from repro_torch.core.types import dense_l_spectral
from repro_torch.core.youla import spectral_from_transform, youla_transform_np
from repro_torch.kernels.tree_sum import ops as tree_sum_ops
from repro_torch.kernels.tree_sum.ref import (
    block_outer_sums_ref,
    gathered_block_grams_ref,
)
from repro_torch.serve.catalog import Catalog
from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

K = 4


def _factors(rng, m, scale=0.3):
    v = (rng.normal(size=(m, K)) * scale).astype(np.float32)
    b = (rng.normal(size=(m, K)) * scale).astype(np.float32)
    d = rng.normal(size=(K, K)).astype(np.float32)
    return v, b, d


def _catalog(v, b, d, **kw):
    return Catalog(v, b, d, device="cpu", **kw)


def _assert_tree_equals_rebuild(cat: Catalog):
    """The maintained live tree is bit-equal, level by level and W too, to
    ``construct_tree`` on the dual rows of the mutated Z."""
    a = dual_rows(cat._sp)
    rebuilt = construct_tree(torch.zeros(a.shape[1]), a, block=cat.block)
    live = cat._live_prop.tree
    assert live.depth == rebuilt.depth
    for lvl in range(live.depth + 1):
        assert torch.equal(live.level(lvl), rebuilt.level(lvl)), lvl
    assert torch.equal(live.W, rebuilt.W)


def test_youla_transform_matches_reference():
    rng = np.random.default_rng(7)
    v, b, d = _factors(rng, 12, scale=0.6)
    sig, t = youla_transform_np(b, d)
    sig_ref, t_ref = jax_transform(b, d)
    np.testing.assert_allclose(sig, sig_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t, t_ref, rtol=1e-10, atol=1e-12)
    sp = spectral_from_transform(v, b, t, sig, device="cpu")
    ref = jax_from_transform(jnp.asarray(v), jnp.asarray(b), t, sig)
    np.testing.assert_allclose(sp.Z.numpy(), np.asarray(ref.Z), rtol=1e-6,
                               atol=1e-6)
    # the frozen transform stays an exact factorization after row edits
    for _ in range(3):
        i = int(rng.integers(12))
        v[i] = rng.normal(size=K) * 0.6
        b[i] = rng.normal(size=K) * 0.6
        sp = spectral_from_transform(v, b, t, sig, device="cpu")
        want = v @ v.T + b @ (d - d.T) @ b.T
        np.testing.assert_allclose(dense_l_spectral(sp).numpy(), want,
                                   atol=2e-5)


@pytest.mark.parametrize("n,block,r", [(8, 4, 8), (16, 2, 6), (64, 64, 200),
                                       (32, 5, 33), (16, 13, 130)])
def test_gathered_block_grams_bit_equal_full_build(n, block, r):
    rng = np.random.default_rng(n * 100 + r)
    w = torch.as_tensor(rng.normal(size=(n * block, r)).astype(np.float32))
    full = block_outer_sums_ref(w, block)
    for nb in (1, 3, n // 2, n + 3):
        blks = torch.as_tensor(rng.integers(0, n, size=nb))   # duplicates too
        got = gathered_block_grams_ref(w, blks, block)
        assert torch.equal(got, full[blks])
        assert torch.equal(tree_sum_ops.gathered_block_grams(w, blks, block),
                           got)


@pytest.mark.parametrize("seed,n_ins", [(0, 1), (5, 3), (77, 6)])
def test_insert_then_delete_roundtrips_bitwise(seed, n_ins):
    rng = np.random.default_rng(seed)
    cat = _catalog(*_factors(rng, 24), block=4, capacity=32)
    before = cat._live_prop.tree
    m0, alive0 = cat.m, cat._alive.copy()
    ids = cat.insert_items(rng.normal(size=(n_ins, K)) * 0.3,
                           rng.normal(size=(n_ins, K)) * 0.3)
    assert cat.m == m0 + n_ins
    cat.delete_items(ids)
    after = cat._live_prop.tree
    assert torch.equal(after.nodes, before.nodes)
    assert torch.equal(after.W, before.W)
    assert cat.m == m0 and np.array_equal(cat._alive, alive0)
    _assert_tree_equals_rebuild(cat)


@pytest.mark.parametrize("seed,n_batches", [(1, 5), (2, 3), (3, 5), (4, 4),
                                            (2024, 5)])
def test_interleaved_batches_match_rebuild(seed, n_batches):
    rng = np.random.default_rng(seed)
    cat = _catalog(*_factors(rng, 24), block=4, capacity=32, staleness=3)
    for _ in range(n_batches):
        op = rng.integers(3)
        alive = np.flatnonzero(cat._alive)
        old = cat.state()
        old_nodes = old.proposal.tree.nodes.clone()
        if op == 0:
            n = int(rng.integers(1, 4))
            cat.insert_items(rng.normal(size=(n, K)) * 0.3,
                             rng.normal(size=(n, K)) * 0.3)
        elif op == 1:
            n = int(rng.integers(1, min(4, alive.size + 1)))
            ids = rng.choice(alive, size=n, replace=False)
            cat.update_items(ids, rng.normal(size=(n, K)) * 0.3,
                             rng.normal(size=(n, K)) * 0.3,
                             defer=bool(rng.integers(2)))
        elif alive.size > 4:
            n = int(rng.integers(1, 3))
            cat.delete_items(rng.choice(alive, size=n, replace=False))
        _assert_tree_equals_rebuild(cat)
        # copy-on-write: a state pinned before the batch did not change
        assert torch.equal(old.proposal.tree.nodes, old_nodes)


def test_update_rows_matches_reference():
    """The port's update_rows on a carried-across reference tree: W and the
    untouched nodes bit-equal, the recomputed nodes within rtol 1e-5."""
    rng = np.random.default_rng(3)
    lam = rng.uniform(size=6).astype(np.float32)
    w = rng.normal(size=(64, 6)).astype(np.float32)
    ref = jax_tree.construct_tree(jnp.asarray(lam), jnp.asarray(w), 4)
    tree = tree_from_numpy(np.asarray(ref.lam), np.asarray(ref.W),
                           [np.asarray(lv) for lv in ref.levels], 4, ref.M,
                           device="cpu")
    idx = np.array([0, 5, 6, 33, 63])
    rows = rng.normal(size=(5, 6)).astype(np.float32)
    want = jax_tree.update_rows(ref, jnp.asarray(idx), jnp.asarray(rows))
    got = update_rows(tree, torch.as_tensor(idx), torch.as_tensor(rows))
    np.testing.assert_array_equal(got.W.numpy(), np.asarray(want.W))
    for lvl, lv_ref in enumerate(want.levels):
        lv_ref = np.asarray(lv_ref)
        lv = got.level(lvl).numpy()
        touched = np.unique((idx // 4) >> (ref.depth - lvl))
        untouched = np.setdiff1d(np.arange(lv.shape[0]), touched)
        np.testing.assert_array_equal(lv[untouched], lv_ref[untouched])
        np.testing.assert_allclose(lv[touched], lv_ref[touched], rtol=1e-5,
                                   atol=1e-6)
    # the input tree is untouched (copy-on-write)
    np.testing.assert_array_equal(tree.W.numpy(), np.asarray(ref.W))


@pytest.fixture(scope="module")
def stale_states():
    """A reference catalog after update and (deferred) delete batches: the
    fresh state before the delete and the stale one after it, each carried
    across to the port."""
    rng = np.random.default_rng(11)
    v, b, d = _factors(rng, 24)
    cat = JaxCatalog(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d), block=4,
                     staleness=4)
    cat.update_items([3, 7], rng.normal(size=(2, K)) * 0.3,
                     rng.normal(size=(2, K)) * 0.3)
    fresh = cat.state()
    cat.delete_items([9, 14])
    stale = cat.state()
    assert stale.stale and not fresh.stale
    return [(st, port_catalog_state(st)) for st in (fresh, stale)]


def test_sample_dynamic_many_matches_reference(stale_states):
    for ref_st, st in stale_states:
        with golden_key_layout():
            want = jax_sample_dynamic_many(ref_st.proposal, ref_st.sp,
                                           jax.random.PRNGKey(5), 16,
                                           n_spec=2, max_trials=50)
        got = sample_dynamic_many(st.proposal, st.sp, trandom.PRNGKey(5), 16,
                                  n_spec=2, max_trials=50)
        for name in ("items", "mask", "trials", "accepted"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        assert float(st.expected_trials()) == pytest.approx(
            float(ref_st.expected_trials()), rel=1e-4)


def test_stale_proposal_samples_live_target():
    """Deferred deletes leave the snapshot stale but valid: the draws match
    the enumerated live target (chi-square), deleted items never appear,
    and the trial rate is the predicted det(Lhat_snap+I)/det(L_live+I)."""
    rng = np.random.default_rng(7)
    cat = _catalog(*_factors(rng, 8, scale=0.6), block=2, staleness=8)
    st0 = cat.state()
    cat.delete_items([2, 5])
    st = cat.state()
    assert st.stale and st.proposal_version == st0.version
    et_stale = st.expected_trials()
    et_fresh = float(expected_trials_dynamic(cat._live_prop, cat._sp))
    assert et_stale > et_fresh > 0

    n = 4000
    res = cat.sample_many(trandom.PRNGKey(5), n, n_spec=8)
    assert bool(res.accepted.all())
    probs = enumerate_subset_probs(dense_l_spectral(cat._sp).double().numpy())
    emp = histogram(res.items.numpy(), res.mask.numpy())
    assert not any((2 in y) or (5 in y) for y in emp)
    assert_chi_square_close(emp, probs, n)
    mean_trials = float(res.trials.double().mean())
    assert abs(mean_trials - et_stale) < 0.35 * et_stale, (mean_trials,
                                                           et_stale)
    cat.refresh()
    assert not cat.state().stale
    res2 = cat.sample_many(trandom.PRNGKey(6), 500, n_spec=8)
    assert float(res2.trials.double().mean()) < mean_trials


def _serve(engine_cls, request_cls, st, rids, swap_to=None, n_slots=3):
    eng = engine_cls(st, n_slots=n_slots, n_spec=4)
    for i in rids[:n_slots]:
        eng.submit(request_cls(rid=i, seed=50 + i))
    if swap_to is not None:
        eng.step()
        eng.swap_catalog(swap_to)
    for i in rids[n_slots:]:
        eng.submit(request_cls(rid=i, seed=50 + i))
    return eng.run()


def _same(got, want, rids):
    for i in rids:
        np.testing.assert_array_equal(got[i].items, np.asarray(want[i].items))
        np.testing.assert_array_equal(got[i].mask, np.asarray(want[i].mask))
        assert (got[i].trials, got[i].accepted) == (int(want[i].trials),
                                                    bool(want[i].accepted)), i


def test_engine_swap_zero_drain_matches_reference(stale_states):
    """swap_catalog after the first tick: every rid equals the reference
    engine's on the same carried-across states; pre-swap requests equal an
    engine that never swapped; post-swap requests never draw a deleted
    item."""
    (ref_old, old), (ref_new, new) = stale_states
    rids = list(range(6))
    with golden_key_layout():
        want = _serve(JaxEngine, JaxRequest, ref_old, rids, swap_to=ref_new)
    got = _serve(SamplerEngine, SampleRequest, old, rids, swap_to=new)
    assert sorted(got) == rids
    _same(got, want, rids)
    never = _serve(SamplerEngine, SampleRequest, old, rids[:3])
    _same(got, never, rids[:3])
    for i in rids[3:]:
        chosen = got[i].items[got[i].mask]
        assert 9 not in chosen and 14 not in chosen, i


def test_engine_auto_n_spec_follows_swap(stale_states):
    (_, old), (ref_new, new) = stale_states
    eng = SamplerEngine(old, n_slots=2)
    with golden_key_layout():
        want = JaxEngine(ref_new, n_slots=2).n_spec
    eng.swap_catalog(new)
    assert eng.n_spec == want
    assert eng.stats()["catalog_version"] == new.version


def test_mutation_batch_validation():
    rng = np.random.default_rng(19)
    cat = _catalog(*_factors(rng, 16), block=4)
    with pytest.raises(ValueError, match="duplicate"):
        cat.update_items([3, 3], rng.normal(size=(2, K)),
                         rng.normal(size=(2, K)))
    cat.delete_items([5, 5])              # dedup: zeros are zeros
    assert cat.m == 15
    with pytest.raises(ValueError, match="dead"):
        cat.update_items([5], rng.normal(size=(1, K)),
                         rng.normal(size=(1, K)))
    with pytest.raises(ValueError, match="dead"):
        cat.delete_items([5])
    with pytest.raises(ValueError, match="dead"):
        cat.delete_items([99])
    _assert_tree_equals_rebuild(cat)


def test_insert_overflow_doubles_capacity():
    rng = np.random.default_rng(13)
    cat = _catalog(*_factors(rng, 14), block=4)   # capacity rounds to 16
    assert cat.capacity == 16
    ids = cat.insert_items(rng.normal(size=(6, K)) * 0.3,
                           rng.normal(size=(6, K)) * 0.3)
    assert cat.capacity == 32 and cat.m == 20 and ids.size == 6
    _assert_tree_equals_rebuild(cat)
    res = cat.sample_many(trandom.PRNGKey(0), 8, n_spec=4)
    assert bool(res.accepted.all())


def test_catalog_matches_reference_catalog():
    """A catalog built and mutated on both sides from the same factors: the
    same versions, free list and capacity, Z within the float32 rounding
    of B @ T."""
    rng = np.random.default_rng(21)
    v, b, d = _factors(rng, 14)
    ref = JaxCatalog(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d), block=4,
                     staleness=1)
    cat = _catalog(v, b, d, block=4, staleness=1)
    vi, bi = rng.normal(size=(4, K)) * 0.3, rng.normal(size=(4, K)) * 0.3
    for c in (ref, cat):
        ids = c.insert_items(vi, bi)
        c.delete_items([1, int(ids[0])])
    assert cat.capacity == ref.capacity and cat.version == ref.version
    np.testing.assert_array_equal(cat.alive_ids(), ref.alive_ids())
    st, st_ref = cat.state(), ref.state()
    assert (st.stale, st.m) == (st_ref.stale, st_ref.m)
    np.testing.assert_allclose(st.sp.Z.numpy(), np.asarray(st_ref.sp.Z),
                               rtol=1e-6, atol=1e-6)


def test_mcmc_reanchor_on_version_bump():
    """After a version bump every chain's cached inverse is exact against
    the new rows (rtol 1e-5, float32 inverses), deleted subset items are
    dropped and step counters are kept."""
    rng = np.random.default_rng(17)
    cat = _catalog(*_factors(rng, 24), block=4)
    sp0 = cat._sp
    keys = trandom.split(trandom.PRNGKey(0), 4)
    states, _, _, _ = mcmc.run_chains(sp0, keys, mcmc.init_empty(sp0, 4),
                                      n_steps=64)
    held = np.unique(states.items.numpy()[states.mask.numpy()])
    victim = int(held[0]) if held.size else 0
    cat.delete_items([victim])
    re = mcmc.reanchor(cat._sp, states)
    assert not ((re.items == victim) & re.mask).any()
    exact = mcmc.refresh(cat._sp, re).minv
    np.testing.assert_allclose(re.minv.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(re.step, states.step)


def test_mcmc_engine_swap_matches_reference(stale_states):
    """backend='mcmc' on a catalog state, swapped after the first tick to a
    version with deletes: the chains re-anchor (reanchor drops deleted
    items) and every rid equals the reference engine's."""
    (ref_old, old), (ref_new, new) = stale_states

    def serve(engine_cls, request_cls, st, st_new):
        eng = engine_cls(st, n_slots=3, backend="mcmc", mcmc_burn_in=32,
                         mcmc_thin=8, mcmc_steps_per_tick=16)
        for i in range(5):
            eng.submit(request_cls(rid=i, seed=70 + i))
        eng.step()
        eng.swap_catalog(st_new)
        return eng.run()

    with golden_key_layout():
        want = serve(JaxEngine, JaxRequest, ref_old, ref_new)
    got = serve(SamplerEngine, SampleRequest, old, new)
    assert sorted(got) == list(range(5))
    _same(got, want, range(5))
    for i in range(5):
        chosen = got[i].items[got[i].mask]
        assert 9 not in chosen and 14 not in chosen, i
