"""The port's item-axis sharding against its unsharded path and the
reference's mesh functions.

The sharding invariant (``docs/sharding.md``): a mesh changes where the
(M, R) rows live, never what is sampled.  The port's mesh is
single-controller (``repro_torch/launch/mesh.py``), and a device may hold
several shards, so S = 1 and S = 2 both run here on the CPU.  At the
reference's sharding size (M = 256, K = 4, blocks of 4: 64 leaf blocks, a
64-node level that really shards) every draw, chain trace, engine result
and catalog tree at S = 1 and S = 2 must equal the port's unsharded result
exactly, and the reference's sharded functions on a 1-device mesh, fed the
same carried-across state and keys.  Tolerances, each with its reason:
the port's plain ``bilinear``/``bilinear_batched`` against the
reference's Pallas kernels in interpret mode take ``tests/test_kernels.py``'s
(1e-4 float32, 5e-2 bfloat16: the two frameworks sum in other orders);
trees the port recomputed against the reference's take
``test_torch_catalog.py``'s rtol 1e-5 on the recomputed nodes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from _torch_port import (
    golden_key_layout,
    port_catalog_state,
    port_mcmc_states,
    port_sampler,
)
from repro.core import init_empty as jax_init_empty
from repro.core import preprocess as jax_preprocess
from repro.core import run_chains_sharded as jax_run_chains_sharded
from repro.core import sample_batched_many as jax_sample_batched_many
from repro.core import sample_proposal_dpp_batch_sharded as jax_proposal_sharded
from repro.core import shard_sampler as jax_shard_sampler
from repro.core import tree as jax_tree
from repro.kernels.bilinear import ops as jax_bops
from repro.kernels.mcmc_score import ops as jax_mops
from repro.serve.catalog import Catalog as JaxCatalog
from repro.serve.sampler_engine import SampleRequest as JaxRequest
from repro.serve.sampler_engine import SamplerEngine as JaxEngine
from repro_torch import random as trandom
from repro_torch.core import (
    ShardedTree,
    gather_tree,
    run_chains,
    run_chains_sharded,
    sample_batched_many,
    sample_mcmc,
    sample_elementary_batch,
    sample_elementary_batch_sharded,
    sample_proposal_dpp_batch,
    sample_proposal_dpp_batch_sharded,
    shard_sampler,
    shard_tree,
    tree_shard_specs,
    update_rows,
    update_rows_sharded,
)
from repro_torch.core.bilinear import bilinear_scores, bilinear_scores_fast
from repro_torch.core.dynamic import dual_rows
from repro_torch.core.tree import construct_tree
from repro_torch.kernels.bilinear import ops as bops
from repro_torch.kernels.mcmc_score import ops as mops
from repro_torch.launch.mesh import Mesh, make_sampler_mesh
from repro_torch.models import sharding as msh
from repro_torch.serve.catalog import Catalog
from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

M, K = 256, 4
SHARDS = [1, 2]


def cpu_mesh(s: int) -> Mesh:
    return make_sampler_mesh(devices=["cpu"] * s)


def _factors(rng, m, scale=0.1):
    v = (rng.normal(size=(m, K)) * scale).astype(np.float32)
    b = (rng.normal(size=(m, K)) * scale).astype(np.float32)
    d = rng.normal(size=(K, K)).astype(np.float32)
    return v, b, d


@pytest.fixture(scope="module")
def mesh1():
    return JaxMesh(np.asarray(jax.devices()[:1]), ("model",))


@pytest.fixture(scope="module")
def samplers():
    """The reference's sharding-test sampler (tests/test_sharded.py) and
    its state carried across to the port."""
    v, b, d = _factors(np.random.default_rng(2024), M)
    ref = jax_preprocess(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d),
                         block=4)
    return ref, port_sampler(ref)


def _equal(got, want, names=("items", "mask", "trials", "accepted")):
    for name in names:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name)


def test_make_sampler_mesh_and_extent():
    mesh = make_sampler_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.shape == {"model": 3} and mesh.device == torch.device("cpu")
    assert make_sampler_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="asked for"):
        make_sampler_mesh(4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_sampler_mesh(2)
    assert msh.model_extent(mesh) == 3
    with pytest.raises(ValueError, match="'model' axis"):
        msh.model_extent(object())
    assert msh.logical_to_spec(mesh, ("items", None), (6, 5)) == ("model",
                                                                  None)
    assert msh.logical_to_spec(mesh, ("items", None), (8, 5)) == (None, None)


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_tree_placement(samplers, s):
    """Deep levels and W shard when the extent divides them (whole leaf
    blocks for W), else replicate; on the tree's own device the shards are
    views, and gathering gives the tree back bit for bit."""
    _, got = samplers
    tree, mesh = got.tree, cpu_mesh(s)
    specs = tree_shard_specs(tree, mesh)
    divides = 64 % s == 0
    assert specs["levels"][-1] == (("model" if divides else None), None, None)
    assert specs["levels"][5] == (None, None, None)     # 32 nodes: replicated
    assert specs["W"] == (("model" if divides else None), None)
    st = shard_tree(tree, mesh)
    assert isinstance(st, ShardedTree) and shard_tree(st, mesh) is st
    if divides:
        assert len(st.W.parts) == s and st.W.rows_per_shard == 256 // s
        assert st.deep[-1].parts[0].data_ptr() == tree.level(6).data_ptr()
    back = gather_tree(st)
    assert torch.equal(back.nodes, tree.nodes) and torch.equal(back.W, tree.W)


def test_proposal_dpp_batch_sharded_matches(samplers, mesh1):
    ref, got = samplers
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(0), 16)
        want = jax_proposal_sharded(jax_tree.shard_tree(ref.tree, mesh1),
                                    keys, mesh1)
    tkeys = torch.as_tensor(np.asarray(keys).astype(np.int64))
    plain = sample_proposal_dpp_batch(got.tree, tkeys)
    e_masks = torch.as_tensor(np.random.default_rng(1).uniform(
        size=(16, got.tree.R)) < 0.5)
    elem = sample_elementary_batch(got.tree, e_masks, tkeys)
    for s in SHARDS:
        it, mk = sample_proposal_dpp_batch_sharded(got.tree, tkeys,
                                                   cpu_mesh(s))
        assert torch.equal(it, plain[0]) and torch.equal(mk, plain[1]), s
        np.testing.assert_array_equal(it.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(mk.numpy(), np.asarray(want[1]))
        it, _ = sample_elementary_batch_sharded(got.tree, e_masks, tkeys,
                                                cpu_mesh(s))
        assert torch.equal(it, elem[0]), s


def test_sample_batched_many_sharded_matches(samplers, mesh1):
    ref, got = samplers
    with golden_key_layout():
        want = jax_sample_batched_many(jax_shard_sampler(ref, mesh1),
                                       jax.random.PRNGKey(7), 32, n_spec=4,
                                       mesh=mesh1)
    plain = sample_batched_many(got, trandom.PRNGKey(7), 32, n_spec=4)
    _equal(plain, want)
    for s in SHARDS:
        mesh = cpu_mesh(s)
        res = sample_batched_many(shard_sampler(got, mesh), trandom.PRNGKey(7),
                                  32, n_spec=4, mesh=mesh)
        _equal(res, plain)


@pytest.fixture(scope="module")
def chain_traces(samplers, mesh1):
    """96 steps of 4 up/down chains from Y = {} on the reference's
    1-device mesh."""
    ref, _ = samplers
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(8), 4)
        states = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (4,) + a.shape),
            jax_init_empty(ref.sp))
        sh = jax_shard_sampler(ref, mesh1)
        out = jax_run_chains_sharded(sh.sp, keys, states, mesh=mesh1,
                                     n_steps=96)
    return np.asarray(keys), states, out


@pytest.mark.parametrize("s", SHARDS)
def test_run_chains_sharded_matches(samplers, chain_traces, s):
    _, got = samplers
    keys, states, want = chain_traces
    tkeys = torch.as_tensor(keys.astype(np.int64))
    init = port_mcmc_states(states)
    plain = run_chains(got.sp, tkeys, init, n_steps=96)
    out = run_chains_sharded(got.sp, tkeys, init, mesh=cpu_mesh(s),
                             n_steps=96)
    for a, b, w in zip(out[1:], plain[1:], want[1:]):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="must divide"):
        run_chains_sharded(got.sp, tkeys, init, mesh=cpu_mesh(3), n_steps=1)


@pytest.mark.parametrize("s", SHARDS)
def test_sharded_scorers_match(mesh1, s):
    """score_all_sharded and bilinear_sharded equal one call over all rows
    bit for bit; score_argmax_sharded equals max/argmax of the full
    scores; the port's plain scores agree with the reference's sharded
    ones to float32 rounding."""
    rng = np.random.default_rng(5)
    z = rng.normal(size=(64, 8)).astype(np.float32)
    a = rng.normal(size=(5, 8, 8)).astype(np.float32)
    w = rng.normal(size=(8, 8)).astype(np.float32)
    zt, at, wt = map(torch.as_tensor, (z, a, w))
    mesh = cpu_mesh(s)
    full = mops.score_all(zt, at)
    assert torch.equal(mops.score_all_sharded(zt, at, mesh), full)
    mx, arg = mops.score_argmax_sharded(zt, at, mesh)
    assert torch.equal(mx, full.max(dim=1).values)
    assert torch.equal(arg, full.argmax(dim=1))
    assert torch.equal(bops.bilinear_sharded(zt, wt, mesh),
                       bops.bilinear(zt, wt))
    want_sc = jax_mops.score_all_sharded(jnp.asarray(z), jnp.asarray(a), mesh1)
    want_mx, want_arg = jax_mops.score_argmax_sharded(jnp.asarray(z),
                                                      jnp.asarray(a), mesh1)
    np.testing.assert_allclose(full.numpy(), np.asarray(want_sc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(want_arg))
    np.testing.assert_allclose(mx.numpy(), np.asarray(want_mx), rtol=1e-5)
    np.testing.assert_allclose(
        bops.bilinear_sharded(zt, wt, mesh).numpy(),
        np.asarray(jax_bops.bilinear_sharded(jnp.asarray(z), jnp.asarray(w),
                                             mesh1)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        bops.bilinear_sharded(zt[:63], wt, mesh if s > 1 else cpu_mesh(2))


# the reference's kernel tests' shapes and tolerances (tests/test_kernels.py)
@pytest.mark.parametrize("m,r", [(64, 8), (100, 40), (512, 200), (33, 7),
                                 (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_plain_matches_reference_kernel(m, r, dtype):
    rng = np.random.default_rng(m * 10 + r)
    z = jnp.asarray(rng.normal(size=(m, r)), dtype)
    w = jnp.asarray(rng.normal(size=(r, r)), dtype)
    want = jax_bops.bilinear(z, w, force_interpret=True)
    tdt = getattr(torch, dtype)
    # bfloat16 bits carried across exactly (through float32)
    zt = torch.as_tensor(np.array(z.astype(jnp.float32))).to(tdt)
    wt = torch.as_tensor(np.array(w.astype(jnp.float32))).to(tdt)
    got = bops.bilinear(zt, wt)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * max(1, r))
    np.testing.assert_allclose(bilinear_scores_fast(zt.float(), wt.float()),
                               bilinear_scores(zt.float(), wt.float()),
                               rtol=1e-5, atol=1e-5 * max(1, r))


@pytest.mark.parametrize("n,b,r", [(4, 8, 16), (16, 64, 64), (3, 5, 40)])
def test_bilinear_batched_plain_matches_reference_kernel(n, b, r):
    rng = np.random.default_rng(n * 100 + b + r)
    z = rng.normal(size=(n, b, r)).astype(np.float32)
    w = rng.normal(size=(n, r, r)).astype(np.float32)
    want = jax_bops.bilinear_batched(jnp.asarray(z), jnp.asarray(w),
                                     force_interpret=True)
    got = bops.bilinear_batched(torch.as_tensor(z), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * max(1, r))


def test_update_rows_sharded_matches(samplers, mesh1):
    """The sharded row update equals the plain one bit for bit, for every
    level and W, at S = 1, 2 and 3 (3 replicates the 64-node level), and the
    reference's update_rows_sharded on its 1-device mesh: W and untouched
    nodes bit-equal, recomputed nodes to rtol 1e-5."""
    ref, got = samplers
    rng = np.random.default_rng(3)
    idx = np.array([0, 5, 6, 100, 131, 255])
    rows = rng.normal(size=(6, got.tree.R)).astype(np.float32)
    plain = update_rows(got.tree, torch.as_tensor(idx), torch.as_tensor(rows))
    for s in SHARDS + [3]:
        placed = shard_tree(got.tree, cpu_mesh(s))
        new = update_rows_sharded(placed, torch.as_tensor(idx),
                                  torch.as_tensor(rows), cpu_mesh(s))
        g = gather_tree(new)
        assert torch.equal(g.nodes, plain.nodes) and torch.equal(g.W, plain.W)
        # copy-on-write: the placed input is unchanged
        assert torch.equal(gather_tree(placed).nodes, got.tree.nodes)
    want = jax_tree.update_rows_sharded(jax_tree.shard_tree(ref.tree, mesh1),
                                        jnp.asarray(idx), jnp.asarray(rows),
                                        mesh1)
    np.testing.assert_array_equal(plain.W.numpy(), np.asarray(want.W))
    for lvl, lv_ref in enumerate(want.levels):
        lv_ref, lv = np.asarray(lv_ref), plain.level(lvl).numpy()
        touched = np.unique((idx // 4) >> (ref.tree.depth - lvl))
        untouched = np.setdiff1d(np.arange(lv.shape[0]), touched)
        np.testing.assert_array_equal(lv[untouched], lv_ref[untouched])
        np.testing.assert_allclose(lv[touched], lv_ref[touched], rtol=1e-5,
                                   atol=1e-6)


def _drain(sampler, mesh, backend, engine_cls=SamplerEngine,
           request_cls=SampleRequest, **kw):
    eng = engine_cls(sampler, n_slots=3, mesh=mesh, backend=backend, **kw)
    for i in range(7):
        eng.submit(request_cls(rid=i, seed=100 + i))
    return eng.run()


def _same(got, want, rids):
    assert sorted(got) == sorted(rids)
    for i in rids:
        np.testing.assert_array_equal(got[i].items, np.asarray(want[i].items))
        np.testing.assert_array_equal(got[i].mask, np.asarray(want[i].mask))
        assert (got[i].trials, got[i].accepted) == (int(want[i].trials),
                                                    bool(want[i].accepted)), i


@pytest.mark.parametrize("backend,kw", [
    ("rejection", dict(n_spec=4)),
    ("mcmc", dict(mcmc_burn_in=32, mcmc_thin=8)),
    ("mcmc", dict(mcmc_burn_in=16, mcmc_thin=8, mcmc_k=3,
                  mcmc_steps_per_tick=8)),
], ids=["rejection", "mcmc", "mcmc_k"])
def test_engine_mesh_matches(samplers, mesh1, backend, kw):
    """SamplerEngine(mesh=) at S = 1 and 2 retires every request with the
    unsharded engine's result and the reference mesh engine's."""
    ref, got = samplers
    with golden_key_layout():
        want = _drain(ref, mesh1, backend, JaxEngine, JaxRequest, **kw)
    plain = _drain(got, None, backend, **kw)
    _same(plain, want, range(7))
    for s in SHARDS:
        _same(_drain(got, cpu_mesh(s), backend, **kw), plain, range(7))


def test_sample_mcmc_mesh_matches(samplers):
    _, got = samplers
    kw = dict(n_chains=4, burn_in=16, thin=4, k=3)
    plain = sample_mcmc(got.sp, trandom.PRNGKey(3), 8, **kw)
    for s in SHARDS:
        res = sample_mcmc(got.sp, trandom.PRNGKey(3), 8, mesh=cpu_mesh(s),
                          **kw)
        _equal(res, plain, ("items", "mask", "steps"))


def _mutate(cat, rng):
    """One round of the four mutation batches."""
    cat.insert_items(rng.normal(size=(5, K)) * 0.1,
                     rng.normal(size=(5, K)) * 0.1)
    cat.update_items([3, 77, 200], rng.normal(size=(3, K)) * 0.1,
                     rng.normal(size=(3, K)) * 0.1)
    cat.delete_items([10, 130, 131])
    cat.refresh()


def _serve_swap(st, st_new, backend="rejection", engine_cls=SamplerEngine,
                request_cls=SampleRequest, **kw):
    eng = engine_cls(st, n_slots=3, backend=backend, **kw)
    for i in range(6):
        eng.submit(request_cls(rid=i, seed=50 + i))
    eng.step()
    eng.swap_catalog(st_new)
    return eng.run()


def test_meshed_catalog_matches_unsharded():
    """A meshed Catalog through insert/update/delete/refresh batches, a
    deferred delete and a swap_catalog: at S = 1 and 2 the maintained tree
    (gathered) is bit-equal to the unsharded catalog's and to a rebuild,
    and sampling and both engines equal the unsharded catalog's."""
    v, b, d = _factors(np.random.default_rng(11), 240, scale=0.3)
    cats = {}
    for s in [None] + SHARDS:
        cat = Catalog(v, b, d, block=4, capacity=256, staleness=1,
                      device="cpu", mesh=None if s is None else cpu_mesh(s))
        _mutate(cat, np.random.default_rng(12))
        old = cat.state()
        cat.delete_items([20, 21])
        cats[s] = (cat, old, cat.state())
    base, old0, new0 = cats[None]
    assert new0.stale
    a = dual_rows(base._sp)
    rebuilt = construct_tree(torch.zeros(a.shape[1]), a, block=4)
    plain_rej = _serve_swap(old0, new0, n_spec=4)
    plain_mc = _serve_swap(old0, new0, "mcmc", mcmc_burn_in=16, mcmc_thin=8,
                           mcmc_steps_per_tick=8)
    plain_draws = base.sample_many(trandom.PRNGKey(4), 8, n_spec=4)
    for s in SHARDS:
        cat, old, new = cats[s]
        assert isinstance(cat._sp.Z, msh.ShardedRows)
        assert cat.capacity == base.capacity and cat.version == base.version
        live = gather_tree(cat._live_prop.tree)
        assert torch.equal(live.nodes, base._live_prop.tree.nodes)
        assert torch.equal(live.nodes, rebuilt.nodes)
        assert torch.equal(live.W, rebuilt.W)
        assert torch.equal(msh.full_rows(cat._sp.Z), base._sp.Z)
        _equal(cat.sample_many(trandom.PRNGKey(4), 8, n_spec=4), plain_draws)
        _same(_serve_swap(cat, new, n_spec=4), plain_rej, range(6))
        _same(_serve_swap(cat, new, "mcmc", mcmc_burn_in=16, mcmc_thin=8,
                          mcmc_steps_per_tick=8), plain_mc, range(6))
    with pytest.raises(ValueError, match="own mesh"):
        SamplerEngine(cats[2][0], mesh=cpu_mesh(1))


def test_meshed_catalog_grows_and_matches():
    """An insert past the capacity doubles it and rebuilds, gathering Z off
    the mesh first; the rebuilt sharded tree equals the unsharded one."""
    v, b, d = _factors(np.random.default_rng(13), 14, scale=0.3)
    extra = np.random.default_rng(14).normal(size=(2, 6, K)) * 0.3
    trees = []
    for mesh in (None, cpu_mesh(2)):
        cat = Catalog(v, b, d, block=4, device="cpu", mesh=mesh)
        assert cat.capacity == 16
        cat.insert_items(extra[0], extra[1])
        assert cat.capacity == 32 and cat.m == 20
        trees.append(gather_tree(cat._live_prop.tree))
    assert torch.equal(trees[0].nodes, trees[1].nodes)


def test_engine_on_reference_meshed_catalog(mesh1):
    """Catalog states of the reference's meshed catalog (1-device mesh),
    carried across and served by the port's engine with a mesh around a
    swap: every rid equals the reference engine's."""
    v, b, d = _factors(np.random.default_rng(15), 24, scale=0.3)
    ref = JaxCatalog(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d), block=4,
                     staleness=4, mesh=mesh1)
    ref.update_items([3, 7], np.random.default_rng(16).normal(size=(2, K))
                     * 0.3, np.random.default_rng(17).normal(size=(2, K)) * 0.3)
    ref_old = ref.state()
    ref.delete_items([9, 14])
    ref_new = ref.state()
    with golden_key_layout():
        want = _serve_swap(ref_old, ref_new, engine_cls=JaxEngine,
                           request_cls=JaxRequest, n_spec=2, mesh=mesh1)
    old, new = port_catalog_state(ref_old), port_catalog_state(ref_new)
    for s in SHARDS:
        got = _serve_swap(old, new, n_spec=2, mesh=cpu_mesh(s))
        _same(got, want, range(6))


@pytest.mark.parametrize("s", SHARDS)
def test_engine_places_catalog_state_once(s):
    """An unplaced CatalogState given with mesh=, or swapped in, is placed
    on the mesh once: the engine's state and every slot's pin hold the
    item-sharded tree and rows, and the ticks read those arrays as they
    are (no further placement), with the unsharded engine's results
    (``_serve_swap``'s seeds)."""
    v, b, d = _factors(np.random.default_rng(18), 32, scale=0.3)
    cat = Catalog(v, b, d, block=4, staleness=1, device="cpu")
    old = cat.state()
    cat.delete_items([5, 6])
    new = cat.state()
    mesh = cpu_mesh(s)
    eng = SamplerEngine(old, n_slots=3, n_spec=2, mesh=mesh)
    for i in range(6):
        eng.submit(SampleRequest(rid=i, seed=50 + i))
    eng.step()
    eng.swap_catalog(new)
    placed = [eng._cat] + [p for p in eng.slot_pin if p is not None]
    for st in placed:
        assert isinstance(st.proposal.tree, ShardedTree)
        assert st.proposal.tree.mesh == mesh
        assert isinstance(st.sp.Z, msh.ShardedRows) and st.sp.Z.mesh == mesh
    first = {id(p): (p.proposal.tree, p.sp.Z) for p in placed}
    got = eng.run()
    for st in placed:
        assert first[id(st)] == (st.proposal.tree, st.sp.Z)
    _same(got, _serve_swap(old, new, n_spec=2), range(6))
