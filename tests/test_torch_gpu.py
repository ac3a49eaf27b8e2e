"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: they skip without a CUDA device (a CUDA kernel has
no CPU mode) and run on the H100 with ``pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: the kernels sum in float32 in another order than cuBLAS /
PyTorch's reductions, so values agree to rtol 1e-5 (Gram) and 1e-4 of the
largest score (descent, all-candidate scores, quadratic forms); block ids
on these well-separated random inputs must be equal.  The Cholesky scan's
decisions are held up to each draw's first flip, which must fall where
|u - p_plain| is within the limit 1e-4 |p_plain| + 1e-6 max|p_plain|, with
|p - p_plain| within it before the flip (``flip_gaps``); the rule refuses
the plain scan with a planted fault.  The gathered Grams
share the full build's contraction and must be bit-equal to it;
``bilinear_batched`` shares ``descend_score``'s leaf stage and must be
bit-equal to its raw scores; the sharded scorers must be bit-equal to one
call over all rows.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (caps torch's CPU threads)

from repro_torch import random as trandom
from repro_torch.core import (
    SpectralNDPP,
    gather_tree,
    preprocess,
    sample_batched_many,
    shard_sampler,
)
from repro_torch.core.rejection import NDPPSampler
from repro_torch.kernels.cholesky_scan import ops as scan_ops
from repro_torch.kernels.cholesky_scan.ref import (
    FAULTS,
    cholesky_scan_ref,
    flip_gaps,
    planted_scan,
    random_inputs,
)
from repro_torch.kernels.spec_round import ops as spec_ops
from repro_torch.kernels.spec_round.ref import descend_score_ref
from repro_torch.core.dynamic import dual_rows
from repro_torch.core.tree import construct_tree
from repro_torch.kernels.bilinear import ops as bilinear_ops
from repro_torch.kernels.bilinear.ref import bilinear_batched_ref, bilinear_ref
from repro_torch.launch.mesh import make_sampler_mesh
from repro_torch.kernels.mcmc_score import ops as score_ops
from repro_torch.kernels.mcmc_score.ref import score_all_ref
from repro_torch.kernels.tree_sum import ops as tree_sum_ops
from repro_torch.kernels.tree_sum.ref import (
    block_outer_sums_ref,
    gathered_block_grams_ref,
)
from repro_torch.serve.catalog import Catalog
from repro_torch.serve.sampler_engine import SampleRequest, SamplerEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(on the H100: pytest -m gpu tests/test_torch_gpu.py)")
    return torch.device("cuda")


# The redesigned kernels' edges: R around their 8-column and 32-column
# tiles and kernel 1's on-chip limit of 224; row counts that are not
# multiples of the 8-row (kernel 3) or 64-row (kernel 2) tiles; lane and
# block counts below and above the 132 SMs.
_EDGE_R = (1, 31, 33, 64, 65, 200, 224, 225, 512)
_EDGE_ROWS = (5, 13, 63, 64)
_EDGE_N = (3, 140)
_GRAM_CASES = [(5, 4, 8), (3, 5, 33), (7, 13, 130), (16, 64, 200)] + [
    (n, block, r) for r in _EDGE_R for block in _EDGE_ROWS for n in _EDGE_N]


@pytest.mark.parametrize("n,block,r", _GRAM_CASES)
def test_block_outer_sums_kernel(cuda, n, block, r):
    rng = np.random.default_rng(n * 1000 + r)
    w = torch.as_tensor(rng.normal(size=(n * block, r)).astype(np.float32),
                        device=cuda)
    before = tree_sum_ops.launches
    got = tree_sum_ops.block_outer_sums(w, block)
    torch.cuda.synchronize()
    assert tree_sum_ops.launches == before + 1
    want = block_outer_sums_ref(w, block)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got, got.transpose(1, 2))
    # the gathered kernel runs the same chain in another schedule
    every = torch.arange(n, device=cuda)
    assert torch.equal(got, tree_sum_ops.gathered_block_grams(w, every, block))


def _tree(rng, depth, r, dev):
    leaves = rng.normal(size=(1 << depth, r, r)).astype(np.float32)
    nodes = np.einsum("nik,njk->nij", leaves, leaves)
    levels = [nodes]
    for _ in range(depth):
        nodes = nodes.reshape(-1, 2, r, r).sum(axis=1)
        levels.append(nodes)
    return torch.as_tensor(np.concatenate(levels[::-1]), device=dev)


def _card_tree(gen, depth, r, dev):
    """A mass-consistent tree made on the card: random Gram leaves, each
    parent the sum of its children; the node stack, root first."""
    leaves = torch.randn((1 << depth, r, r), generator=gen, device=dev)
    nodes = torch.bmm(leaves, leaves.transpose(1, 2))
    levels = [nodes]
    for _ in range(depth):
        nodes = nodes[0::2] + nodes[1::2]
        levels.append(nodes)
    return torch.cat(levels[::-1])


def _card_descent_inputs(cuda, depth, block, r, n, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    nodes = _card_tree(gen, depth, r, cuda)
    w = torch.randn(((1 << depth) * block, r), generator=gen, device=cuda)
    qh = torch.randn((n, r, r), generator=gen, device=cuda)
    q = torch.bmm(qh, qh.transpose(1, 2)) / r
    us = torch.rand((n, max(depth, 1)), generator=gen, device=cuda)
    return nodes, w, q, us


# Besides a few shapes, lane counts around the cluster sizes' edges on 132
# SMs (c = 8 at 1, 2 at 64 and 66, 1 from 67 on, and past the SM count),
# widths at the edges of the 16-byte grid and of the on-chip limit, whole
# and ragged blocks.
_CLUSTER_DEPTH = {64: 10, 5: 0, 63: 4}
_DESCEND_CASES = [(0, 4, 8, 3), (3, 4, 8, 5), (6, 3, 40, 9), (5, 8, 33, 12),
                  (2, 8, 130, 4), (8, 64, 200, 16)] + [
    (_CLUSTER_DEPTH[block], block, r, n)
    for n in (1, 64, 66, 67, 132, 133, 140) for r in (1, 33, 200, 224)
    for block in (64, 5, 63)]


@pytest.mark.parametrize("depth,block,r,n", _DESCEND_CASES)
def test_descend_score_kernel(cuda, depth, block, r, n):
    nodes, w, q, us = _card_descent_inputs(
        cuda, depth, block, r, n, seed=depth * 100_000 + n * 1000 + r + block)
    before = spec_ops.launches
    blk, sc = spec_ops.descend_score(nodes, w, block, q, us)
    torch.cuda.synchronize()
    assert spec_ops.launches == before + 1
    blk_ref, sc_ref = descend_score_ref(nodes, w, block, q, us)
    assert torch.equal(blk, blk_ref)
    torch.testing.assert_close(sc, sc_ref, rtol=1e-4,
                               atol=1e-4 * float(sc_ref.abs().max()))


@pytest.mark.parametrize("n", [3, 64, 140])
def test_descend_score_is_deterministic(cuda, n):
    """The cluster's partial sums meet in a fixed order: two calls on the
    same inputs give the same bits (c = 8, 2 and 1)."""
    nodes, w, q, us = _card_descent_inputs(cuda, 10, 64, 200, n, seed=n)
    first = spec_ops.descend_score(nodes, w, 64, q, us)
    second = spec_ops.descend_score(nodes, w, 64, q, us)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_descend_score_refuses_wide_r(cuda):
    r = spec_ops.MAX_R + 1
    nodes = torch.zeros((1, r, r), device=cuda)
    with pytest.raises(ValueError, match="R <="):
        spec_ops.descend_score(nodes, torch.zeros((4, r), device=cuda), 4,
                               torch.zeros((2, r, r), device=cuda),
                               torch.zeros((2, 1), device=cuda))


def test_card_draws_match_cpu_draws(cuda):
    """The same sampler state on the CPU (plain versions) and on the card
    (kernels) gives the same draws for the same keys: M=256, K=4 as the
    reference's golden kernel."""
    rng = np.random.default_rng(31415)
    v = (rng.normal(size=(256, 4)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(256, 4)) * 0.1).astype(np.float32)
    d = rng.normal(size=(4, 4)).astype(np.float32)
    cpu = preprocess(v, b, d, block=4, device="cpu")
    card = NDPPSampler(
        sp=SpectralNDPP(Z=cpu.sp.Z.to(cuda), sigma=cpu.sp.sigma.to(cuda)),
        tree=dataclasses.replace(cpu.tree, W=cpu.tree.W.to(cuda),
                                 lam=cpu.tree.lam.to(cuda),
                                 nodes=cpu.tree.nodes.to(cuda)))
    before = spec_ops.launches
    want = sample_batched_many(cpu, trandom.PRNGKey(0), 8, n_spec=4,
                               max_trials=100)
    got = sample_batched_many(card, trandom.PRNGKey(0), 8, n_spec=4,
                              max_trials=100)
    assert spec_ops.launches > before
    for name in ("items", "mask", "trials", "accepted"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


# kernel 4 runs kernel 2's CTA on each named block: the same R, block and
# block-count edges, and block 130 (two chunked passes of 64 rows)
_GATHERED_CASES = [(5, 4, 8), (9, 5, 33), (7, 13, 130), (64, 64, 200)] + [
    (n, block, r) for r in _EDGE_R for block in _EDGE_ROWS + (130,)
    for n in _EDGE_N]


@pytest.mark.parametrize("n,block,r", _GATHERED_CASES)
def test_gathered_block_grams_kernel(cuda, n, block, r):
    rng = np.random.default_rng(n * 10 + block * 1000 + r)
    w = torch.as_tensor(rng.normal(size=(n * block, r)).astype(np.float32),
                        device=cuda)
    blks = torch.as_tensor(np.concatenate([rng.integers(0, n, size=2 * n),
                                           [0, n - 1, 0]]), device=cuda)
    before = tree_sum_ops.gathered_launches
    got = tree_sum_ops.gathered_block_grams(w, blks, block)
    torch.cuda.synchronize()
    assert tree_sum_ops.gathered_launches == before + 1
    # the full build's contraction, bit for bit (duplicate ids included)
    assert torch.equal(got, tree_sum_ops.block_outer_sums(w, block)[blks])
    want = gathered_block_grams_ref(w, blks, block)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("block,r", [(4, 8), (64, 200), (130, 33)])
def test_gathered_block_grams_bad_ids_give_nan(cuda, block, r):
    """Ids -1 and n give all-NaN Grams (the kernel reads nothing outside
    W); the valid ids of the same call stay bit-equal to the full build."""
    n = 6
    rng = np.random.default_rng(block + r)
    w = torch.as_tensor(rng.normal(size=(n * block, r)).astype(np.float32),
                        device=cuda)
    blks = torch.as_tensor([2, -1, 0, n, 5, 2], device=cuda)
    got = tree_sum_ops.gathered_block_grams(w, blks, block)
    torch.cuda.synchronize()
    bad = torch.tensor([False, True, False, True, False, False])
    assert bool(torch.isnan(got[bad.to(cuda)]).all())
    full = tree_sum_ops.block_outer_sums(w, block)
    assert torch.equal(got[~bad.to(cuda)], full[blks[~bad.to(cuda)]])


def test_update_rows_on_card_bit_equal_to_rebuild(cuda):
    """Catalog mutations on the card keep the maintained tree bit-equal to
    a card rebuild (the gathered kernel against block_outer_sums)."""
    rng = np.random.default_rng(5)
    m, k = 300, 8
    cat = Catalog(rng.normal(size=(m, k)) * 0.3, rng.normal(size=(m, k)) * 0.3,
                  rng.normal(size=(k, k)), block=8, capacity=512,
                  staleness=1, device=cuda)
    before = tree_sum_ops.gathered_launches
    cat.insert_items(rng.normal(size=(5, k)) * 0.3,
                     rng.normal(size=(5, k)) * 0.3)
    cat.update_items([3, 77, 78], rng.normal(size=(3, k)) * 0.3,
                     rng.normal(size=(3, k)) * 0.3)
    cat.delete_items([10, 200, 201])
    assert tree_sum_ops.gathered_launches == before + 3
    a = dual_rows(cat._sp)
    rebuilt = construct_tree(torch.zeros(a.shape[1], device=cuda), a, block=8)
    live = cat._live_prop.tree
    assert torch.equal(live.nodes, rebuilt.nodes)
    assert torch.equal(live.W, rebuilt.W)


# The quadratic form's edges: R at its resident limit (224) and one above
# (the panel route), widths around its 8-column tiles; M of one row, around
# the 64-row tile, and not a multiple of it; C of one chain, a few, and more
# chains than SMs.
_QUAD_R = (1, 8, 33, 130, 200, 224, 225, 512)
_QUAD_M = (1, 63, 65, 1000, 4097)
#: the widest R of the resident route (quad_form.cuh's kQuadResidentMaxR)
_RESIDENT_MAX_R = 224
#: the first port's cases, which keep its check
_FIRST_SCORE_CASES = [(1, 1, 8), (1, 100, 33), (3, 1000, 130),
                      (8, 4097, 200), (2, 64, 512)]
_SCORE_CASES = _FIRST_SCORE_CASES + [
    (c, m, r) for r in _QUAD_R for m in _QUAD_M for c in (1, 3)] + [
    (c, m, r) for r in (200, 225) for c in (8, 200) for m in (65, 1000)]


def _route_counts(mod):
    return mod.launches, mod.resident_launches, mod.panel_launches


def _assert_one_launch_on_route(mod, before, r):
    """One launch since ``before``, counted in the total and in the route
    that R alone chooses."""
    resident = r <= _RESIDENT_MAX_R
    n, res, pan = before
    assert _route_counts(mod) == (n + 1, res + resident, pan + (not resident))


def _rows_to_64(rng, z):
    """z and, below 64 rows, further normal rows up to 64 (z's dtype)."""
    more = rng.normal(size=(64 - z.shape[0], z.shape[1]))
    return torch.cat([z, torch.as_tensor(more, device=z.device).to(z.dtype)])


@pytest.mark.parametrize("c,m,r", _SCORE_CASES)
def test_score_all_kernel(cuda, c, m, r):
    """One launch, on the route R gives, within 1e-4 of each chain's
    largest |score|.  Below 64 rows (a single random row can cancel to
    ~1e-4 of its terms' scale, below what any float32 sum meets) that
    holds over 64 drawn rows, the first m of them the rows scored, which
    equal the same rows of the 64-row call, bit for bit; the first port's
    cases there also keep its check of the rows scored."""
    rng = np.random.default_rng(c * 1000 + m + r)
    z = torch.as_tensor(rng.normal(size=(m, r)).astype(np.float32),
                        device=cuda)
    a = torch.as_tensor(rng.normal(size=(c, r, r)).astype(np.float32),
                        device=cuda)
    before = _route_counts(score_ops)
    got = score_ops.score_all(z, a)
    torch.cuda.synchronize()
    _assert_one_launch_on_route(score_ops, before, r)
    want = score_all_ref(z, a)
    if m < 64:
        if (c, m, r) in _FIRST_SCORE_CASES:
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))
        z64 = _rows_to_64(rng, z)
        got64 = score_ops.score_all(z64, a)
        assert torch.equal(got, got64[:, :m])
        got, want = got64, score_all_ref(z64, a)
    scale = want.abs().amax(dim=1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-4 * scale).all())


def test_score_all_refuses_wide_r(cuda):
    r = score_ops.MAX_R + 1
    with pytest.raises(ValueError, match="R <="):
        score_ops.score_all(torch.zeros((4, r), device=cuda),
                            torch.zeros((1, r, r), device=cuda))


_BATCHED_CASES = [(3, 5, 8), (4, 64, 33), (64, 64, 200), (5, 5, 200),
                  (2, 5, 512), (3, 64, 512)] + [
    (n, b, r) for r in _EDGE_R for b in _EDGE_ROWS for n in _EDGE_N]


@pytest.mark.parametrize("n,b,r", _BATCHED_CASES)
def test_bilinear_batched_kernel(cuda, n, b, r):
    """Against the plain version within 1e-4 of the largest score; up to
    kernel 1's on-chip limit also against descend_score's raw scores of
    the same rows (a one-block tree a lane), bit for bit."""
    rng = np.random.default_rng(n * 100 + b + r)
    z = torch.as_tensor(rng.normal(size=(n, b, r)).astype(np.float32),
                        device=cuda)
    w = torch.as_tensor(rng.normal(size=(n, r, r)).astype(np.float32),
                        device=cuda)
    before = bilinear_ops.batched_launches
    got = bilinear_ops.bilinear_batched(z, w)
    torch.cuda.synchronize()
    assert bilinear_ops.batched_launches == before + 1
    want = bilinear_batched_ref(z, w)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    if r <= spec_ops.MAX_R:
        nodes = torch.zeros((1, r, r), device=cuda)
        us = torch.zeros((1, 1), device=cuda)
        raw = torch.cat([spec_ops.descend_score(nodes, z[i], b, w[i:i + 1],
                                                us)[1] for i in range(n)])
        assert torch.equal(got, raw)


def test_bilinear_batched_refuses_wide_r(cuda):
    r = bilinear_ops.BATCHED_MAX_R + 1
    with pytest.raises(ValueError, match="R <="):
        bilinear_ops.bilinear_batched(torch.zeros((1, 1, r), device=cuda),
                                      torch.zeros((1, r, r), device=cuda))


_LEAF_CASES = [(3, 5, 8, 6), (5, 64, 33, 9), (4, 64, 200, 16)] + [
    (3, block, r, n) for r in _EDGE_R if r <= 224 for block in _EDGE_ROWS
    for n in (9, 64, 66, 140)]


@pytest.mark.parametrize("depth,block,r,n", _LEAF_CASES)
def test_bilinear_batched_equals_descend_score_leaf(cuda, depth, block, r, n):
    """The two kernels share the leaf stage's chains: bilinear_batched's
    scores of the blocks descend_score chose are its raw scores, bit for
    bit."""
    rng = np.random.default_rng(depth * 7 + r)
    nodes = _tree(rng, depth, r, cuda)
    w = torch.as_tensor(rng.normal(size=((1 << depth) * block, r))
                        .astype(np.float32), device=cuda)
    qh = rng.normal(size=(n, r, r)).astype(np.float32)
    q = torch.as_tensor(np.einsum("nik,njk->nij", qh, qh) / r, device=cuda)
    us = torch.as_tensor(rng.uniform(size=(n, depth)).astype(np.float32),
                         device=cuda)
    blk, raw = spec_ops.descend_score(nodes, w, block, q, us)
    rows = blk[:, None] * block + torch.arange(block, device=cuda)
    assert torch.equal(bilinear_ops.bilinear_batched(w[rows], q), raw)


_FIRST_BILINEAR_CASES = [(1, 8), (100, 33), (4097, 200), (64, 512)]
_BILINEAR_CASES = _FIRST_BILINEAR_CASES + [
    (m, r) for r in _QUAD_R for m in _QUAD_M]


@pytest.mark.parametrize("m,r", _BILINEAR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_kernel(cuda, m, r, dtype):
    """One launch, on the route R gives, within 1e-4 of the largest |score|
    (and of each score); below 64 rows over 64 drawn rows, as in
    ``test_score_all_kernel``."""
    rng = np.random.default_rng(m + r)
    z = torch.as_tensor(rng.normal(size=(m, r)), device=cuda).to(dtype)
    w = torch.as_tensor(rng.normal(size=(r, r)), device=cuda).to(dtype)
    before = _route_counts(bilinear_ops)
    got = bilinear_ops.bilinear(z, w)
    torch.cuda.synchronize()
    _assert_one_launch_on_route(bilinear_ops, before, r)
    assert got.dtype == torch.float32
    # bfloat16 inputs widen exactly to float32: the same tolerance holds
    want = bilinear_ref(z, w)
    if m < 64:
        if (m, r) in _FIRST_BILINEAR_CASES:
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))
        z64 = _rows_to_64(rng, z)
        got64 = bilinear_ops.bilinear(z64, w)
        assert torch.equal(got, got64[:m])
        got, want = got64, bilinear_ref(z64, w)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("r", [7, 33, 200, 224, 225])
@pytest.mark.parametrize("scorer", ["score_all", "bilinear", "bilinear_bf16"])
def test_quad_form_slices_bit_equal_to_the_whole(cuda, scorer, r):
    """A row's score does not depend on where it sits: rows a..b-1 scored
    alone, a and b not multiples of the 64-row tile (so every row lands in
    another tile slot, and Z's start moves off 16 bytes when R is odd),
    equal the same rows of one call over all rows, bit for bit."""
    rng = np.random.default_rng(r)
    m, a, b = 1000, 37, 811
    dtype = torch.bfloat16 if scorer == "bilinear_bf16" else torch.float32
    z = torch.as_tensor(rng.normal(size=(m, r)), device=cuda).to(dtype)
    w = torch.as_tensor(rng.normal(size=(3, r, r)), device=cuda).to(dtype)
    if scorer == "score_all":
        whole, part = score_ops.score_all(z, w), score_ops.score_all(z[a:b], w)
        assert torch.equal(part, whole[:, a:b])
    else:
        whole = bilinear_ops.bilinear(z, w[0])
        part = bilinear_ops.bilinear(z[a:b], w[0])
        assert torch.equal(part, whole[a:b])


def test_bilinear_refuses_mixed_dtypes_and_wide_r(cuda):
    z = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="both"):
        bilinear_ops.bilinear(z, torch.zeros((8, 8), device=cuda,
                                             dtype=torch.bfloat16))
    r = bilinear_ops.MAX_R + 1
    with pytest.raises(ValueError, match="R <="):
        bilinear_ops.bilinear(torch.zeros((4, r), device=cuda),
                              torch.zeros((r, r), device=cuda))


@pytest.mark.parametrize("s,m", [(2, 4096), (3, 3000), (4, 1024)])
def test_sharded_scorers_bit_equal_on_card(cuda, s, m):
    """Every row's arithmetic is independent of M and of its place: the
    shards' slices equal one call over all rows, bit for bit."""
    rng = np.random.default_rng(s * m)
    r = 200
    z = torch.as_tensor(rng.normal(size=(m, r)).astype(np.float32),
                        device=cuda)
    w = torch.as_tensor(rng.normal(size=(r, r)).astype(np.float32),
                        device=cuda)
    a = torch.as_tensor(rng.normal(size=(3, r, r)).astype(np.float32),
                        device=cuda)
    mesh = make_sampler_mesh(devices=[cuda] * s)
    assert torch.equal(bilinear_ops.bilinear_sharded(z, w, mesh),
                       bilinear_ops.bilinear(z, w))
    full = score_ops.score_all(z, a)
    assert torch.equal(score_ops.score_all_sharded(z, a, mesh), full)
    mx, arg = score_ops.score_argmax_sharded(z, a, mesh)
    assert torch.equal(mx, full.max(dim=1).values)
    assert torch.equal(arg, full.argmax(dim=1))


def test_sharded_paths_on_card(cuda):
    """On the card, meshes of 1 and 2 shards (both on this card) draw the
    same as the unsharded kernels: the rejection sampler (the sharded
    descent is torch operations, the unsharded one descend_score: on this
    well-separated kernel no decision is a near tie), the MCMC engine, and
    a meshed catalog whose tree stays bit-equal to the unsharded one."""
    rng = np.random.default_rng(31415)
    v = (rng.normal(size=(256, 4)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(256, 4)) * 0.1).astype(np.float32)
    d = rng.normal(size=(4, 4)).astype(np.float32)
    card = preprocess(v, b, d, block=4, device=cuda)
    want = sample_batched_many(card, trandom.PRNGKey(0), 16, n_spec=4)
    before = bilinear_ops.batched_launches
    for s in (1, 2):
        mesh = make_sampler_mesh(devices=[cuda] * s)
        got = sample_batched_many(shard_sampler(card, mesh),
                                  trandom.PRNGKey(0), 16, n_spec=4, mesh=mesh)
        for name in ("items", "mask", "trials", "accepted"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bilinear_ops.batched_launches > before

    def drain(mesh):
        eng = SamplerEngine(card, backend="mcmc", n_slots=3, mcmc_k=3,
                            mcmc_burn_in=16, mcmc_thin=8, mesh=mesh)
        for i in range(5):
            eng.submit(SampleRequest(rid=i, seed=i))
        return eng.run()

    plain = drain(None)
    for s in (1, 2):
        out = drain(make_sampler_mesh(devices=[cuda] * s))
        for i in range(5):
            assert np.array_equal(out[i].items, plain[i].items), (s, i)

    trees = []
    for mesh in (None, make_sampler_mesh(devices=[cuda] * 2)):
        cat = Catalog(v * 3, b * 3, d, block=4, staleness=1, device=cuda,
                      mesh=mesh)
        cat.update_items([3, 77, 200], v[:3] * 2, b[:3] * 2)
        cat.delete_items([10, 130])
        trees.append(gather_tree(cat._live_prop.tree))
    assert torch.equal(trees[0].nodes, trees[1].nodes)
    assert torch.equal(trees[0].W, trees[1].W)


# ------------------------------------------------- flash attention (kernel 7)
_FLASH_CASES = [  # (Sq, Sk, D, g, causal): S 200 and 100 are ragged
    (128, 128, 64, 1, True), (200, 200, 80, 2, True),
    (384, 384, 128, 2, True), (1024, 1024, 128, 2, True),
    (200, 200, 256, 3, True), (1024, 1024, 80, 1, True),
    (128, 128, 256, 1, False), (384, 384, 64, 3, False),
    (200, 200, 128, 3, False), (100, 200, 64, 2, True),
    (128, 384, 256, 2, True), (2048, 2048, 128, 8, True),
    (1, 300, 128, 2, True), (130, 390, 48, 3, True),
    (64, 640, 112, 4, False)]


@pytest.mark.parametrize("sq,sk,d,g,causal", _FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, sq, sk, d, g, causal, dtype):
    """Forward (O and the row log-sum-exp) and backward (dq, dk, dv)
    against the plain version in float32 on the same inputs: within 2e-5
    of each output's max |.| in float32; in bfloat16 each of O, dq, dk and
    dv within ``bf16_excess``'s per-element, per-row tolerance (the
    chip_smoke tolerance), the log-sum-exp within 1e-4.  bfloat16 at D
    48, 64, 80, 112 and 128 runs the tensor-core kernels ("wgmma"), the
    rest the SIMT kernels; each route's counts must show it."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import (bf16_excess, mha_lse_ref,
                                                   mha_ref)

    rng = np.random.default_rng(sq * 7 + d * 3 + g)
    b, kvh = 2, 2
    h = kvh * g
    mk = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                    device=cuda).to(dtype)
    q, k, v = mk(b, h, sq, d), mk(b, kvh, sk, d), mk(b, kvh, sk, d)
    dout = mk(b, h, sq, d)
    f0, b0 = attn_ops.launches, attn_ops.bwd_launches
    by_route = lambda: (attn_ops.wgmma_launches, attn_ops.simt_launches,
                        attn_ops.wgmma_bwd_launches,
                        attn_ops.simt_bwd_launches)
    r0 = by_route()
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = attn_ops.mha(qg, kg, vg, causal=causal)
    dq, dk, dv = torch.autograd.grad(o, (qg, kg, vg), dout)
    o = o.detach()
    o1, lse, o32 = attn_ops.flash_forward(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(o1, o) and torch.equal(o32.to(dtype), o)
    assert (attn_ops.launches, attn_ops.bwd_launches) == (f0 + 2, b0 + 1)
    wgmma = dtype == torch.bfloat16 and d % 16 == 0 and d <= 128
    assert attn_ops._route(dtype, d) == ("wgmma" if wgmma else "simt")
    got = tuple(x - y for x, y in zip(by_route(), r0))
    assert got == ((2, 0, 1, 0) if wgmma else (0, 2, 0, 1)), got
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype

    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    want = mha_ref(qf, kf, vf, causal=causal)
    wq, wk, wv = torch.autograd.grad(want, (qf, kf, vf), dout.float())
    want = want.detach()
    wl = mha_lse_ref(q.float(), k.float(), v.float(), causal=causal)
    f32 = dtype == torch.float32
    for name, got, ref in (("o", o, want), ("dq", dq, wq), ("dk", dk, wk),
                           ("dv", dv, wv)):
        if f32:
            err = float((got.float() - ref).abs().max())
            assert err <= 2e-5 * float(ref.abs().max()), (name, err)
        else:
            assert bf16_excess(got, ref) <= 1, (name, bf16_excess(got, ref))
    assert float((lse - wl).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_takes_strided_and_unaligned_inputs(cuda, dtype):
    """A contiguous view at an address that is not 16-byte aligned (TMA's
    rule) and a transposed k give the same outputs as fresh copies."""
    from repro_torch.kernels.attention import ops as attn_ops

    rng = np.random.default_rng(5)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                    device=cuda).to(dtype)
    q, k, v, dout = mk(2, 4, 96, 64), mk(2, 2, 96, 64), mk(2, 2, 96, 64), \
        mk(2, 4, 96, 64)
    buf = torch.empty(q.numel() + 8, dtype=dtype, device=cuda)
    buf[1:q.numel() + 1] = q.flatten()
    q_odd = buf[1:q.numel() + 1].view(q.shape)
    k_t = k.transpose(2, 3).contiguous().transpose(2, 3)
    assert q_odd.data_ptr() % 16 and not k_t.is_contiguous()
    o, lse, o32 = attn_ops.flash_forward(q, k, v, True, 0.125)
    o2, lse2, o322 = attn_ops.flash_forward(q_odd, k_t, v, True, 0.125)
    grads = attn_ops.flash_backward(q, k, v, o32, lse, dout, True, 0.125)
    grads2 = attn_ops.flash_backward(q_odd, k_t, v, o322, lse2, dout, True,
                                     0.125)
    torch.cuda.synchronize()
    for a, b in zip((o, lse, o32, *grads), (o2, lse2, o322, *grads2)):
        assert torch.equal(a, b)


def test_flash_attention_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.attention import ops as attn_ops

    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        attn_ops.mha(z(1, 2, 8, 12), z(1, 2, 8, 12), z(1, 2, 8, 12))
    with pytest.raises(ValueError, match="Sq <= Sk"):
        attn_ops.mha(z(1, 2, 16, 64), z(1, 2, 8, 64), z(1, 2, 8, 64))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        attn_ops.mha(z(1, 2, 8, 64), z(1, 2, 8, 64, dt=torch.bfloat16),
                     z(1, 2, 8, 64))
    with pytest.raises(ValueError, match="O in float32"):
        attn_ops.flash_backward(*(z(1, 2, 8, 64, dt=torch.bfloat16),) * 4,
                                z(1, 2, 8), z(1, 2, 8, 64), True, 1.0)
    with pytest.raises(NotImplementedError, match="serving slice"):
        attn_ops.mha(z(1, 2, 1, 64), z(1, 2, 8, 64), z(1, 2, 8, 64),
                     kv_len=torch.tensor([8], device=cuda))


def test_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of a float32 smoke LM (head_dim 64, GQA g = 2) on the
    card, where attention runs the flash kernels forward and backward,
    against the same step on the CPU (the plain versions): loss and grad
    norm within 1e-4 relative, every gradient within 1e-3 of its max |.|
    (float32 sums in other orders through 4 layers and the loss); flash
    launches 2 x 4 forward (remat) and 4 backward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.data.lm import lm_batch
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models.model import init_model
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), n_layers=4,
                              head_dim=64, attn_chunk=64)
    cpu_model = init_model(cfg, seed=3, device="cpu")
    card_model = lm_params_from_numpy(cfg, lm_params_to_numpy(cfg, cpu_model),
                                      cuda)
    opt = make_optimizer(OptimizerConfig())
    grads = {}
    cpu_batch = lm_batch(cfg, 0, 0, 2, 256, device="cpu")

    def run(model, dev):
        params = dict(model.named_parameters())
        state = opt.init(params)
        batch = {k: t.to(dev) for k, t in cpu_batch.items()}
        orig = opt.update

        def spy(g, st, p):
            grads[dev.type] = {k: t.float().cpu() for k, t in g.items()}
            return orig(g, st, p)

        step = make_train_step(cfg, opt._replace(update=spy))
        _, _, metrics = step(model, state, batch)
        return {k: float(t) for k, t in metrics.items()}

    want = run(cpu_model, torch.device("cpu"))
    f0, b0 = attn_ops.launches, attn_ops.bwd_launches
    got = run(card_model, cuda)
    torch.cuda.synchronize()
    assert attn_ops.launches - f0 == 2 * cfg.n_layers
    assert attn_ops.bwd_launches - b0 == cfg.n_layers
    for k in ("loss", "grad_norm"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k, ref in grads["cpu"].items():
        err = float((grads["cuda"][k] - ref).abs().max())
        assert err <= 1e-3 * float(ref.abs().max()) + 1e-12, (k, err)


# ------------------------------------------------------------ SSD (kernel 8)
_SSD_CASES = [  # (B, S, H, P, N, chunk, smallest decay, B and C shared)
    (2, 64, 2, 16, 8, 16, 0.7, False), (1, 128, 4, 32, 16, 32, 0.7, True),
    (1, 96, 1, 8, 4, 32, 0.7, False), (1, 200, 3, 24, 20, 40, 0.5, True),
    (2, 512, 4, 64, 128, 128, 0.5, True), (1, 384, 2, 64, 128, 128, 1e-6,
                                          False),
    (1, 256, 3, 64, 64, 64, 1e-6, True),
    # the backward's wgmma route (bf16): per-head B and C at chunk 64 with
    # N and P below their tiles, one chunk only, and the train widths
    (1, 256, 2, 32, 48, 64, 0.5, False), (2, 64, 3, 16, 16, 64, 0.9, False),
    (2, 384, 3, 64, 128, 128, 1e-3, False)]


def _ssd_route(dtype, p, n, chunk):
    """The forward's and the backward's route, as ``ssd/ops.py::_fwd_route``
    and ``_bwd_route`` must choose them: the tensor cores for bf16 at chunk
    64 or 128 with N and P multiples of 16, the float32 SIMT kernels for
    everything else."""
    return ("wgmma" if dtype == torch.bfloat16 and chunk in (64, 128)
            and n % 16 == 0 and p % 16 == 0 else "simt")


def _bwd_counts(ssd_ops):
    return ssd_ops.wgmma_bwd_launches, ssd_ops.simt_bwd_launches


def _fwd_counts(ssd_ops):
    return ssd_ops.wgmma_fwd_launches, ssd_ops.simt_fwd_launches


def _ssd_inputs(cuda, b, s, h, p, n, lo, shared, dtype, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(rng.normal(size=sh).astype(np.float32),
                                     device=cuda).to(dtype)
    x = mk(b, s, h, p)
    a = torch.as_tensor(np.exp(rng.uniform(np.log(lo), 0, size=(b, s, h)))
                        .astype(np.float32), device=cuda)
    if shared:  # one row over all heads, read through a head stride of 0
        bb, cc = mk(b, s, 1, n).expand(b, s, h, n), mk(b, s, 1, n).expand(
            b, s, h, n)
    else:
        bb, cc = mk(b, s, h, n), mk(b, s, h, n)
    return x, a, bb, cc, mk(b, s, h, p), mk(b, h, n, p).float()


def _ssd_want(x, a, bb, cc, dy, dh, chunk):
    """The plain version in float32 on the same inputs, and autograd's
    gradients of <y, dy> + <h_last, dh> for x, a, and b and c a head at a
    time."""
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    xs = [t.float().contiguous().requires_grad_(True) for t in (x, a, bb, cc)]
    y, hl = ssd_chunked_ref(*xs, chunk=chunk)
    return (y.detach(), hl.detach()), torch.autograd.grad(
        (y, hl), xs, (dy.float(), dh))


def _ssd_excess(got, want, a, chunk, rel):
    """row_excess of (y, h_last, dx, d log a, db, dc): d log a = da * a,
    since da = d log a / a divides float32 sums by decays down to 1e-6."""
    from repro_torch.kernels.ssd.ref import da_rows, row_excess

    (y, hl, dx, da, db, dc), ((wy, wh), (wx, wa, wb, wc)) = got, want
    return {"y": row_excess(y, wy, 1, rel), "h_last": row_excess(hl, wh, 2, rel),
            "dx": row_excess(dx, wx, 1, rel),
            "dloga": row_excess(da_rows(da * a, chunk),
                                da_rows(wa * a, chunk), 1, rel),
            "db": row_excess(db, wb, 1, rel), "dc": row_excess(dc, wc, 1, rel)}


@pytest.mark.parametrize("b,s,h,p,n,chunk,lo,shared", _SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel(cuda, b, s, h, p, n, chunk, lo, shared, dtype):
    """Forward (y, h_last) and backward (dx, da, db, dc) through ``ssd``
    on the card against the plain version in float32 on the same inputs,
    every element within ``row_excess``'s per-row tolerance: 2^-12 of its
    |value| + 2^-12 of its row's max in float32 (sums in another order,
    cum rounded differently), 2^-8 (one bfloat16 rounding) in bfloat16.
    da is compared as d log a = da * a.  One forward and one backward
    launch each, both on the route ``_ssd_route`` names (h_last's
    gradient nonzero on both)."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    x, a, bb, cc, dy, dh = _ssd_inputs(cuda, b, s, h, p, n, lo, shared,
                                       dtype, seed=s + 7 * n + p)
    f0, b0 = ssd_ops.launches, ssd_ops.bwd_launches
    r0, fr0 = _bwd_counts(ssd_ops), _fwd_counts(ssd_ops)
    xs = [t.detach().requires_grad_(True) for t in (x, a)]
    # gradients of b and c taken at the expanded views: a head at a time
    bl = (bb[:, :, :1] if shared else bb).detach().requires_grad_(True)
    cl = (cc[:, :, :1] if shared else cc).detach().requires_grad_(True)
    be, ce = bl.expand(b, s, h, n), cl.expand(b, s, h, n)
    y, hl = ssd_ops.ssd(xs[0], xs[1], be, ce, chunk=chunk)
    dx, da, db, dc = torch.autograd.grad((y, hl), (*xs, be, ce), (dy, dh))
    torch.cuda.synchronize()
    assert (ssd_ops.launches, ssd_ops.bwd_launches) == (f0 + 1, b0 + 1)
    route = _ssd_route(dtype, p, n, chunk)
    assert ssd_ops._bwd_route(dtype, chunk, n, p) == route
    assert ssd_ops._fwd_route(dtype, chunk, n, p) == route
    assert tuple(c - c0 for c, c0 in zip(_bwd_counts(ssd_ops), r0)) == (
        (1, 0) if route == "wgmma" else (0, 1))
    assert tuple(c - c0 for c, c0 in zip(_fwd_counts(ssd_ops), fr0)) == (
        (1, 0) if route == "wgmma" else (0, 1))
    assert y.dtype == dx.dtype == db.dtype == dc.dtype == dtype
    assert hl.dtype == da.dtype == torch.float32
    want = _ssd_want(x, a, bb, cc, dy, dh, chunk)
    rel = 2.0 ** -12 if dtype == torch.float32 else 2.0 ** -8
    excess = _ssd_excess((y, hl, dx, da, db, dc), want, a, chunk, rel)
    assert max(excess.values()) <= 1, excess


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_row_tolerance_rejects_planted_faults(cuda, dtype):
    """At the train path's widths (P 64, N 128, chunk 128, B and C shared)
    the kernels pass ``row_excess`` while two planted faults fail it: the
    state not carried across one chunk boundary (the sequence run in two
    halves) and the decays of the wrong head; forward and backward on the
    wgmma routes in bf16, on the simt routes in float32."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import row_excess

    b, s, h, p, n, q = 2, 1024, 8, 64, 128, 128
    x, a, bb, cc, dy, _ = _ssd_inputs(cuda, b, s, h, p, n, 1e-3, True,
                                      dtype, seed=5)
    r0, fr0 = _bwd_counts(ssd_ops), _fwd_counts(ssd_ops)
    (wy, _), (wx, *_) = _ssd_want(x, a, bb, cc, dy, torch.zeros(
        b, h, n, p, device=cuda), q)

    def run(sl, a_):
        y, _, st = ssd_ops.ssd_forward(x[:, sl], a_[:, sl], bb[:, sl],
                                       cc[:, sl], q, keep_states=True)
        dx = ssd_ops.ssd_backward(x[:, sl], a_[:, sl], bb[:, sl], cc[:, sl],
                                  st, dy[:, sl], None, q)[0]
        return y, dx

    y, dx = run(slice(None), a)
    assert row_excess(y, wy) <= 1 and row_excess(dx, wx) <= 1
    halves = [run(slice(0, s // 2), a), run(slice(s // 2, None), a)]
    rolled = run(slice(None), a.roll(1, dims=2))
    for name, (my, mdx) in {"no carry": [torch.cat(t, 1) for t in zip(
            *halves)], "rolled a": rolled}.items():
        assert row_excess(my, wy) > 1 and row_excess(mdx, wx) > 1, name
    wgmma = _ssd_route(dtype, p, n, q) == "wgmma"
    assert tuple(c - c0 for c, c0 in zip(_bwd_counts(ssd_ops), r0)) == (
        (4, 0) if wgmma else (0, 4))
    assert tuple(c - c0 for c, c0 in zip(_fwd_counts(ssd_ops), fr0)) == (
        (4, 0) if wgmma else (0, 4))


@pytest.mark.parametrize("shared", [True, False])
def test_ssd_fwd_wgmma_is_deterministic(cuda, shared):
    """The forward's wgmma route writes every output element from one CTA,
    with no atomics: two calls on the same inputs are equal bit for bit,
    with the states kept and not (y and h_last the same either way); its
    chunk-start states lie within 2^-12 (``row_excess``, a row a state)
    of the simt route's on the same inputs, and y and h_last within 2^-8
    of the plain version in float32."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import row_excess

    b, s, h, p, n, q = 2, 512, 4, 64, 128, 128
    x, a, bb, cc, dy, dh = _ssd_inputs(cuda, b, s, h, p, n, 1e-3, shared,
                                       torch.bfloat16, seed=9)
    fr0 = _fwd_counts(ssd_ops)
    runs = {keep: [ssd_ops.ssd_forward(x, a, bb, cc, q, keep_states=keep)
                   for _ in range(2)] for keep in (True, False)}
    simt = ssd_ops._launch_forward("simt", x, a, bb, cc, q, True)
    torch.cuda.synchronize()
    assert tuple(c - c0 for c, c0 in zip(_fwd_counts(ssd_ops), fr0)) == (4, 1)
    for keep, (one, two) in runs.items():
        assert all(torch.equal(u, v) for u, v in zip(one[:2], two[:2])), keep
    assert torch.equal(runs[True][0][2], runs[True][1][2])
    assert runs[False][0][2] is None
    assert all(torch.equal(u, v) for u, v in zip(runs[True][0][:2],
                                                 runs[False][0][:2]))
    assert row_excess(runs[True][0][2], simt[2], 2, 2.0 ** -12) <= 1
    want = _ssd_want(x, a, bb, cc, dy, dh, q)
    y, hl, _ = runs[True][0]
    excess = _ssd_excess((y, hl, *ssd_ops.ssd_backward(
        x, a, bb, cc, runs[True][0][2], dy, dh, q)), want, a, q, 2.0 ** -8)
    assert max(excess.values()) <= 1, excess


def test_ssd_fwd_wgmma_reads_unaligned_rows(cuda):
    """Rows that do not start on 16 bytes (views one column into wider
    tensors) take the forward's wgmma route's element-at-a-time staging
    and give the same bits as 16-byte-aligned copies of the same values."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    b, s, h, p, n, q = 1, 256, 2, 32, 48, 64
    x, a, bb, cc, _, _ = _ssd_inputs(cuda, b, s, h, p, n, 0.5, False,
                                     torch.bfloat16, seed=11)

    def shifted(t):  # the same values one column into a wider tensor
        wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 1, dtype=t.dtype,
                           device=cuda)
        wide[..., 1:] = t
        return wide[..., 1:]

    fr0 = _fwd_counts(ssd_ops)
    want = ssd_ops.ssd_forward(x, a, bb, cc, q, keep_states=True)
    got = ssd_ops.ssd_forward(shifted(x), a, shifted(bb), shifted(cc), q,
                              keep_states=True)
    torch.cuda.synchronize()
    assert shifted(x).data_ptr() % 16 != 0
    assert tuple(c - c0 for c, c0 in zip(_fwd_counts(ssd_ops), fr0)) == (2, 0)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("shared", [True, False])
def test_ssd_bwd_wgmma_is_deterministic(cuda, shared):
    """The wgmma route writes every output element from one CTA, with no
    atomics: two calls on the same inputs are equal bit for bit, with
    h_last's gradient None, zero (equal to None) and nonzero (held against
    autograd of the plain version, as ``test_ssd_kernel``)."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    b, s, h, p, n, q = 2, 512, 4, 64, 128, 128
    x, a, bb, cc, dy, dh = _ssd_inputs(cuda, b, s, h, p, n, 1e-3, shared,
                                       torch.bfloat16, seed=9)
    _, _, st = ssd_ops.ssd_forward(x, a, bb, cc, q, keep_states=True)
    r0 = _bwd_counts(ssd_ops)
    runs = {k: [ssd_ops.ssd_backward(x, a, bb, cc, st, dy, g, q)
                for _ in range(2)]
            for k, g in (("none", None), ("zero", torch.zeros_like(dh)),
                         ("dh", dh))}
    torch.cuda.synchronize()
    assert tuple(c - c0 for c, c0 in zip(_bwd_counts(ssd_ops), r0)) == (6, 0)
    for k, (one, two) in runs.items():
        assert all(torch.equal(u, v) for u, v in zip(one, two)), k
    assert all(torch.equal(u, v) for u, v in zip(runs["none"][0],
                                                 runs["zero"][0]))
    want = _ssd_want(x, a, bb, cc, dy, dh, q)
    y, hl, _ = ssd_ops.ssd_forward(x, a, bb, cc, q)
    excess = _ssd_excess((y, hl, *runs["dh"][0]), want, a, q, 2.0 ** -8)
    assert max(excess.values()) <= 1, excess


def test_ssd_bwd_wgmma_reads_unaligned_rows(cuda):
    """Rows that do not start on 16 bytes (views one column into wider
    tensors) take the wgmma route's element-at-a-time staging and give
    the same bits as 16-byte-aligned copies of the same values."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    b, s, h, p, n, q = 1, 256, 2, 32, 48, 64
    x, a, bb, cc, dy, dh = _ssd_inputs(cuda, b, s, h, p, n, 0.5, False,
                                       torch.bfloat16, seed=11)

    def shifted(t):  # the same values one column into a wider tensor
        wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 1, dtype=t.dtype,
                           device=cuda)
        wide[..., 1:] = t
        return wide[..., 1:]

    _, _, st = ssd_ops.ssd_forward(x, a, bb, cc, q, keep_states=True)
    r0 = _bwd_counts(ssd_ops)
    want = ssd_ops.ssd_backward(x, a, bb, cc, st, dy, dh, q)
    got = ssd_ops.ssd_backward(shifted(x), a, shifted(bb), shifted(cc), st,
                               shifted(dy), dh, q)
    torch.cuda.synchronize()
    assert shifted(x).data_ptr() % 16 != 0
    assert tuple(c - c0 for c, c0 in zip(_bwd_counts(ssd_ops), r0)) == (2, 0)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_ssd_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.ssd import ops as ssd_ops

    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=cuda)
    with pytest.raises(ValueError, match="divides the sequence"):
        ssd_ops.ssd(z(1, 48, 2, 16), z(1, 48, 2), z(1, 48, 2, 8),
                    z(1, 48, 2, 8), chunk=32)
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd_ops.ssd(z(1, 32, 2, 12), z(1, 32, 2), z(1, 32, 2, 8),
                    z(1, 32, 2, 8), chunk=32)
    with pytest.raises(ValueError, match="multiple of 8 up to 64"):
        ssd_ops.ssd(z(1, 32, 2, 128), z(1, 32, 2), z(1, 32, 2, 8),
                    z(1, 32, 2, 8), chunk=32)
    with pytest.raises(ValueError, match="state size N up to 128"):
        ssd_ops.ssd(z(1, 32, 2, 16), z(1, 32, 2), z(1, 32, 2, 256),
                    z(1, 32, 2, 256), chunk=32)
    with pytest.raises(ValueError, match="chunk of 1..128"):
        ssd_ops.ssd(z(1, 512, 2, 16), z(1, 512, 2), z(1, 512, 2, 8),
                    z(1, 512, 2, 8), chunk=256)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ssd_ops.ssd(z(1, 32, 2, 16, dt=torch.bfloat16), z(1, 32, 2),
                    z(1, 32, 2, 8), z(1, 32, 2, 8), chunk=32)
    with pytest.raises(NotImplementedError, match="serving slice"):
        ssd_ops.ssd(z(1, 32, 2, 16), z(1, 32, 2), z(1, 32, 2, 8),
                    z(1, 32, 2, 8), h0=z(1, 2, 8, 16), chunk=32)


def test_mamba_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of the float32 mamba2 smoke model (4 layers, P 32,
    N 16, chunk 32) at 2 x 256 on the card, where the SSD scan runs the
    kernels forward and backward, against the same step on the CPU (the
    plain chunked scan): loss and grad norm within 1e-4 relative, every
    gradient within 1e-3 of its max |.| (float32 sums in other orders
    through 4 layers and the loss); SSD launches 2 x 4 forward (remat)
    and 4 backward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.data.lm import lm_batch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models.model import init_model
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer
    from repro_torch.train.steps import make_train_step

    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), n_layers=4)
    cpu_model = init_model(cfg, seed=3, device="cpu")
    card_model = lm_params_from_numpy(cfg, lm_params_to_numpy(cfg, cpu_model),
                                      cuda)
    opt = make_optimizer(OptimizerConfig())
    grads = {}
    cpu_batch = lm_batch(cfg, 0, 0, 2, 256, device="cpu")

    def run(model, dev):
        params = dict(model.named_parameters())
        state = opt.init(params)
        batch = {k: t.to(dev) for k, t in cpu_batch.items()}
        orig = opt.update

        def spy(g, st, p):
            grads[dev.type] = {k: t.float().cpu() for k, t in g.items()}
            return orig(g, st, p)

        step = make_train_step(cfg, opt._replace(update=spy))
        _, _, metrics = step(model, state, batch)
        return {k: float(t) for k, t in metrics.items()}

    want = run(cpu_model, torch.device("cpu"))
    f0, b0 = ssd_ops.launches, ssd_ops.bwd_launches
    got = run(card_model, cuda)
    torch.cuda.synchronize()
    assert ssd_ops.launches - f0 == 2 * cfg.n_layers
    assert ssd_ops.bwd_launches - b0 == cfg.n_layers
    for k in ("loss", "grad_norm"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k, ref in grads["cpu"].items():
        err = float((grads["cuda"][k] - ref).abs().max())
        assert err <= 1e-3 * float(ref.abs().max()) + 1e-12, (k, err)


# ------------------------------------------------- the Cholesky scan kernel
# R at both routes' edges (blocked to 208, resident 209-224); M at the
# blocked route's block edges (b = 32: b - 1, b, b + 1, 2b, 2b + 1)
_SCAN_CASES = ([(257, r, 3) for r in (1, 8, 33, 200, 208, 209, 224)]
               + [(m, 200, 5) for m in (1, 31, 32, 33, 63, 64, 65, 4097)]
               + [(300, 64, n) for n in (1, 131, 132, 133, 300)])


def _scan_inputs(cuda, m, r, n, seed, zero_rows=()):
    """``ref.random_inputs``: rows of a random NDPP scaled to marginals of
    O(0.1), its inner matrix, uniforms; rows in ``zero_rows`` are zero."""
    return random_inputs(m, r, n, seed, cuda, zero_rows=zero_rows)


@pytest.mark.parametrize("m,r,n", _SCAN_CASES)
def test_cholesky_scan_kernel(cuda, m, r, n):
    """One launch, on the route of R; decisions equal the plain version's
    up to each draw's first flip, a flip only where u is within the flip
    rule's limit of the plain p, p within it before the flip; two calls
    give the same bits."""
    z, w, u = _scan_inputs(cuda, m, r, n, seed=m * 1000 + r + n)
    count = f"{scan_ops.route(r)}_launches"
    before, on_route = scan_ops.launches, getattr(scan_ops, count)
    take, p = scan_ops.cholesky_scan(z, w, u)
    torch.cuda.synchronize()
    assert scan_ops.launches == before + 1
    assert getattr(scan_ops, count) == on_route + 1
    assert take.dtype == torch.bool and take.shape == (n, m) == p.shape
    gaps = flip_gaps(take, p, *cholesky_scan_ref(z, w, u), u)
    assert gaps["within"], gaps
    again = scan_ops.cholesky_scan(z, w, u)
    assert torch.equal(take, again[0]) and torch.equal(p, again[1])


def test_cholesky_scan_never_takes_zero_rows(cuda):
    """A zero row has p = 0 and is never taken, at u = 0 too (strict <),
    while u = 0 takes every row whose p is positive."""
    zero = (0, 5, 6, 100, 1023)
    z, w, u = _scan_inputs(cuda, 1024, 200, 133, seed=7, zero_rows=zero)
    u[:, list(zero)] = 0.0
    u[:, 7] = 0.0
    take, p = scan_ops.cholesky_scan(z, w, u)
    want_take, want_p = cholesky_scan_ref(z, w, u)
    assert not bool(take[:, list(zero)].any())
    assert bool((p[:, list(zero)] == 0).all())
    assert torch.equal(take[:, :8], want_take[:, :8])
    assert bool(take[:, 7].all())
    gaps = flip_gaps(take, p, want_take, want_p, u)
    assert gaps["within"], gaps


def test_cholesky_scan_zero_rows_at_block_edges(cuda):
    """Zero rows at the blocked route's block edges (the first and last
    item of a block of 32, and the last row) are never taken, at u = 0
    too, and the draws around them hold to the plain version."""
    zero = (0, 31, 32, 63, 64, 95, 96, 299)
    z, w, u = _scan_inputs(cuda, 300, 200, 7, seed=17, zero_rows=zero)
    u[:, list(zero)] = 0.0
    take, p = scan_ops.cholesky_scan(z, w, u)
    assert not bool(take[:, list(zero)].any())
    assert bool((p[:, list(zero)] == 0).all())
    gaps = flip_gaps(take, p, *cholesky_scan_ref(z, w, u), u)
    assert gaps["within"], gaps


def test_cholesky_scan_unaligned_rows(cuda):
    """Rows that start 4 bytes off a 16-byte boundary (a contiguous view
    one float into its storage) load by floats and give the aligned
    copy's bits."""
    z, w, u = _scan_inputs(cuda, 100, 64, 3, seed=29)
    flat = torch.empty(z.numel() + 1, device=cuda)
    shifted = flat[1:].view(z.shape)
    shifted.copy_(z)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    take, p = scan_ops.cholesky_scan(shifted, w, u)
    want_take, want_p = scan_ops.cholesky_scan(z, w, u)
    assert torch.equal(take, want_take) and torch.equal(p, want_p)


@pytest.mark.parametrize("r", [8, 200])
def test_cholesky_scan_routes_agree(cuda, r):
    """Both routes, where R lets both run, hold to the plain version on the
    same inputs, each one launch on its own count."""
    z, w, u = _scan_inputs(cuda, 300, r, 9, seed=23 + r)
    take_r, p_r = cholesky_scan_ref(z, w, u)
    for route in scan_ops.ROUTES:
        before = getattr(scan_ops, f"{route}_launches")
        gaps = flip_gaps(*scan_ops._launch(route, z, w, u), take_r, p_r, u)
        assert gaps["within"], (route, gaps)
        assert getattr(scan_ops, f"{route}_launches") == before + 1


@pytest.mark.parametrize("fault", FAULTS)
def test_cholesky_scan_rule_refuses_planted_fault(cuda, fault):
    """On the card's inputs at R = 200 with marginals of O(0.1), the flip
    rule passes the kernel and refuses the plain scan with a fault planted
    (all zeros, the downdate skipped, the denominator's sign flipped, the
    blocked form's rejected pivot left at p)."""
    z, w, u = _scan_inputs(cuda, 1024, 200, 132, seed=11)
    take_r, p_r = cholesky_scan_ref(z, w, u)
    sound = flip_gaps(*scan_ops.cholesky_scan(z, w, u), take_r, p_r, u)
    assert sound["within"] and sound["compared_takes"] > 132 * 10, sound
    bad = flip_gaps(*planted_scan(z, w, u, fault), take_r, p_r, u)
    assert not bad["within"], bad


def test_cholesky_scan_refuses_wide_r(cuda):
    r = scan_ops.MAX_R + 1
    assert scan_ops.route(scan_ops.MAX_R) == "resident"
    with pytest.raises(ValueError, match="R <= 224"):
        scan_ops.cholesky_scan(torch.zeros((4, r), device=cuda),
                               torch.zeros((r, r), device=cuda),
                               torch.zeros((2, 4), device=cuda))


def _golden_samplers(cuda):
    """The reference's golden kernel (M=256, K=4), preprocessed on the CPU,
    and the same state on the card."""
    rng = np.random.default_rng(31415)
    v = (rng.normal(size=(256, 4)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(256, 4)) * 0.1).astype(np.float32)
    d = rng.normal(size=(4, 4)).astype(np.float32)
    cpu = preprocess(v, b, d, block=4, device="cpu")
    card = NDPPSampler(
        sp=SpectralNDPP(Z=cpu.sp.Z.to(cuda), sigma=cpu.sp.sigma.to(cuda)),
        tree=dataclasses.replace(cpu.tree, W=cpu.tree.W.to(cuda),
                                 lam=cpu.tree.lam.to(cuda),
                                 nodes=cpu.tree.nodes.to(cuda)))
    return cpu, card


def test_cholesky_samplers_on_card_match_cpu(cuda):
    """Every Cholesky entry point on the card, one scan launch a call, for
    one key and for a stack of keys, equal to the CPU draws."""
    from repro_torch.core import (
        sample_cholesky_blocked,
        sample_cholesky_spectral,
        x_from_sigma,
    )

    cpu, card = _golden_samplers(cuda)
    keys = trandom.split(trandom.PRNGKey(1), 8)
    x = x_from_sigma(cpu.sp.K, cpu.sp.sigma)
    calls = [
        lambda s, k: sample_cholesky_spectral(s.sp, k),
        lambda s, k: sample_cholesky_blocked(s.sp.Z, x.to(s.sp.Z.device), k,
                                             block=64),
    ]
    for call in calls:
        for k in (keys, keys[3]):
            before = scan_ops.launches
            got = call(card, k.to(cuda))
            assert scan_ops.launches == before + 1
            assert torch.equal(got.cpu(), call(cpu, k))


def test_samplers_on_kernel_1_and_6_match_cpu(cuda):
    """``sample``, ``sample_batch`` and ``sample_k_ndpp`` descend through
    ``descend_score`` (one launch an elementary step), and
    ``sample_elementary_dense`` scores through ``bilinear`` (one launch a
    step); each equals its CPU draw."""
    from repro_torch.core import (
        sample,
        sample_batch,
        sample_elementary_dense,
        sample_k_ndpp,
    )

    cpu, card = _golden_samplers(cuda)
    for call in (lambda s: sample(s, trandom.PRNGKey(4)),
                 lambda s: sample_batch(s, trandom.PRNGKey(9), 8),
                 lambda s: sample_k_ndpp(s, 3, trandom.PRNGKey(6))):
        before = spec_ops.launches
        got = call(card)
        assert spec_ops.launches > before
        want = call(cpu)
        for name in ("items", "mask", "trials", "accepted"):
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    e_mask = cpu.tree.lam > cpu.tree.lam.median()
    before = bilinear_ops.launches
    items, _ = sample_elementary_dense(card.tree.W, e_mask.to(cuda),
                                       trandom.PRNGKey(2))
    assert bilinear_ops.launches - before == int(e_mask.sum())
    want, _ = sample_elementary_dense(cpu.tree.W, e_mask, trandom.PRNGKey(2))
    assert torch.equal(items.cpu(), want)


# ------------------------------------------- learning and next-item serving
def _learned_inputs(m, k, seed, device):
    """Planted baskets over m items and an ONDPP init, on ``device``."""
    from repro_torch.core.learning import init_ondpp
    from repro_torch.data.baskets import planted_baskets

    tr, te = planted_baskets(m, 200, k_max=6, seed=seed, n_topics=4,
                             device=device)
    return tr, te, init_ondpp(trandom.PRNGKey(seed), m, k, device=device)


def test_basket_fit_step_on_card_matches_cpu(cuda):
    """One Eq. 14 step on the card (slogdet of the basket Grams and of the
    2K x 2K normalizer, the QR of the projection) against the CPU step:
    loss and gradients within rtol 1e-4, then three fitted steps' losses."""
    from repro_torch.core.learning import item_frequencies, ondpp_loss
    from repro_torch.core.types import ONDPPParams
    from repro_torch.train.ndpp import BasketTrainConfig, fit_ondpp

    m, k = 96, 8
    tr, _, init = _learned_inputs(m, k, 3, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).clone().requires_grad_(True)
                  for t in (init.V, init.B, init.sigma)]
        b = type(tr)(tr.items.to(dev), tr.mask.to(dev))
        loss = ondpp_loss(ONDPPParams(*leaves), b, item_frequencies(b, m))
        out[str(dev)] = [loss.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(loss, leaves)]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))
    cfg = BasketTrainConfig(steps=3, minibatch=32, lr=0.01, seed=1)
    want = fit_ondpp(tr, m, k, cfg, init_params=init)
    got = fit_ondpp(type(tr)(tr.items.to(cuda), tr.mask.to(cuda)), m, k,
                    cfg, init_params=ONDPPParams(*(t.to(cuda) for t in (
                        init.V, init.B, init.sigma))))
    assert got.params.V.device.type == "cuda"
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)


def test_next_item_scores_on_kernel_6(cuda):
    """``next_item_scores`` at R = 200 scores all rows in one launch of
    ``bilinear`` on its resident route, against ``bilinear_ref`` on the
    same rows and the same nonsymmetric W_J (1e-4 of the largest score);
    observed items read -inf; ``greedy_map`` launches it once a pick."""
    from repro_torch.core.bilinear import conditional_inner_matrix
    from repro_torch.core.map_inference import _zx, greedy_map, next_item_scores
    from repro_torch.core.types import NDPPParams

    m, k = 4097, 100
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = NDPPParams(*(torch.randn(s, generator=gen, device=cuda) * c
                     for s, c in (((m, k), 0.05), ((m, k), 0.05),
                                  ((k, k), 1.0))))
    obs = torch.tensor([7, 300, 4096, -1, -1], device=cuda)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0], device=cuda)
    before = (bilinear_ops.launches, bilinear_ops.resident_launches)
    got = next_item_scores(p, obs, mask)
    assert (bilinear_ops.launches, bilinear_ops.resident_launches) == (
        before[0] + 1, before[1] + 1)
    z, x = _zx(p)
    w = conditional_inner_matrix(z[obs.clamp_min(0)], mask, x)
    assert float((w - w.T).abs().max()) > 1e-3 * float(w.abs().max())
    want = bilinear_ref(z, w)
    taken = torch.zeros(m, dtype=torch.bool, device=cuda)
    taken[obs[:3]] = True
    assert bool(torch.isneginf(got[taken]).all())
    assert bool(torch.isfinite(got[~taken]).all())
    torch.testing.assert_close(got[~taken], want[~taken], rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    before = bilinear_ops.launches
    picks = greedy_map(p, 4)
    assert bilinear_ops.launches - before == 4
    assert len(set(picks.tolist())) == 4


def test_conditional_sample_on_kernel_9(cuda):
    """A conditional completion wave at R = 200 is one launch of the
    Cholesky scan on the conditional rows and inner matrix, held to the
    plain scan on the same inputs by the flip rule; the observed rows are
    zero and never taken."""
    from repro_torch.core.map_inference import (
        _zx,
        conditional_rows,
        conditional_sample,
    )
    from repro_torch.core.types import NDPPParams

    m, k, n = 2000, 100, 16
    gen = torch.Generator(device=cuda).manual_seed(8)
    p = NDPPParams(*(torch.randn(s, generator=gen, device=cuda) * c
                     for s, c in (((m, k), 0.04), ((m, k), 0.04),
                                  ((k, k), 1.0))))
    obs = torch.tensor([3, 999, 1500], device=cuda)
    mask = torch.ones(3, device=cuda)
    keys = trandom.split(trandom.PRNGKey(12, device=cuda), n)
    before = scan_ops.launches
    take = conditional_sample(p, obs, mask, keys)
    assert scan_ops.launches == before + 1 and take.shape == (n, m)
    assert not bool(take[:, obs].any()) and bool(take.any())
    z_c, w = conditional_rows(*_zx(p), obs, mask)
    u = trandom.uniform(keys, (m,))
    kt, kp = scan_ops.cholesky_scan(z_c, w, u)
    assert torch.equal(kt, take)
    gaps = flip_gaps(kt, kp, *cholesky_scan_ref(z_c, w, u), u)
    assert gaps["within"], gaps


def test_next_item_server_on_card_matches_cpu(cuda):
    """``NextItemServer`` end to end at a small M on the card (kernels 6
    and 9) against the same server on the CPU: scores within 1e-4 of the
    largest, top-k, completions and both MPRs equal."""
    from repro_torch.core.types import ONDPPParams
    from repro_torch.serve.next_item import NextItemServer

    m, k = 512, 8
    _, te, init = _learned_inputs(m, k, 4, "cpu")
    cpu = NextItemServer(init)
    card = NextItemServer(ONDPPParams(*(t.to(cuda) for t in (
        init.V, init.B, init.sigma))))
    basket = [int(i) for i in te.items[0][te.mask[0] > 0]]
    s_card, s_cpu = card.scores(basket).cpu(), cpu.scores(basket)
    fin = torch.isfinite(s_cpu)
    assert torch.equal(torch.isfinite(s_card), fin)
    torch.testing.assert_close(s_card[fin], s_cpu[fin], rtol=0,
                               atol=1e-4 * float(s_cpu[fin].abs().max()))
    assert np.array_equal(card.top_k(basket, 10), cpu.top_k(basket, 10))
    before = scan_ops.launches
    many = card.complete_many(basket, trandom.PRNGKey(3), 8)
    assert scan_ops.launches == before + 1
    for got, want in zip(many, cpu.complete_many(basket, trandom.PRNGKey(3),
                                                  8)):
        assert np.array_equal(got, want) and not set(got) & set(basket)
    before = bilinear_ops.launches
    rep = card.evaluate_mpr(type(te)(te.items.to(cuda), te.mask.to(cuda)),
                            trandom.PRNGKey(7))
    assert bilinear_ops.launches - before == te.items.shape[0]
    want = cpu.evaluate_mpr(te, trandom.PRNGKey(7))
    np.testing.assert_allclose(rep.model, want.model, rtol=1e-6)
    np.testing.assert_allclose(rep.frequency, want.frequency, rtol=1e-6)


# ------------------------------------------ admission scheduler, telemetry
def _serve_pools(sampler, tel):
    return {"rej": SamplerEngine(sampler, n_slots=3, n_spec=4, telemetry=tel),
            "mcmc": SamplerEngine(sampler, n_slots=2, backend="mcmc",
                                  mcmc_k=3, mcmc_burn_in=16, mcmc_thin=8,
                                  mcmc_steps_per_tick=8, telemetry=tel)}


def test_scheduler_replay_on_card_matches_cpu(cuda):
    """A seeded trace (priorities, deadlines, pinned and routed requests)
    replayed through the port's ``Scheduler`` on a virtual clock: on the
    card, through ``descend_score`` and ``score_all``, every rid gets the
    CPU replay's ``Outcome`` (status, reason, pool, items, trials)."""
    from _torch_load import VirtualClock, poisson_trace, replay
    from repro_torch.obs import Telemetry
    from repro_torch.serve.scheduler import Scheduler

    cpu, card = _golden_samplers(cuda)
    runs = []
    for sampler in (card, cpu):
        clock, tel = VirtualClock(), Telemetry()
        sched = Scheduler(_serve_pools(sampler, tel), clock=clock,
                          telemetry=tel, max_queue=8, on_full="evict")
        trace = poisson_trace(5, 32, rate=600.0, pools=(None, "rej", "mcmc"),
                              priorities=(0, 1, 2), deadline_frac=0.25,
                              deadline_range=(0.002, 0.05))
        before = (spec_ops.launches, score_ops.launches)
        runs.append(replay(sched, clock, trace))
        if sampler is card:
            assert spec_ops.launches > before[0]
            assert score_ops.launches > before[1]
    got, want = runs
    assert sorted(got) == sorted(want) == list(range(32))
    assert {o.status for o in want.values()} >= {"done", "shed"}
    for rid, w in want.items():
        g = got[rid]
        assert (g.status, g.reason, g.pool) == (w.status, w.reason,
                                                w.pool), rid
        if w.result is not None:
            assert np.array_equal(g.result.items, w.result.items), rid
            assert (g.result.trials, g.result.accepted) == (
                w.result.trials, w.result.accepted), rid


def test_engine_telemetry_on_card_is_free(cuda):
    """An engine with telemetry draws what one without it draws on the
    card, in as many ticks, with as many ``descend_score`` launches."""
    from repro_torch.obs import Telemetry

    _, card = _golden_samplers(cuda)
    runs = []
    for tel in (None, Telemetry()):
        eng = SamplerEngine(card, n_slots=4, n_spec=4, telemetry=tel)
        for i in range(16):
            eng.submit(SampleRequest(rid=i, seed=i))
        before = spec_ops.launches
        out = eng.run()
        runs.append((out, eng.ticks, spec_ops.launches - before))
    (bare, ticks, launches), (inst, ticks_t, launches_t) = runs
    assert (ticks, launches) == (ticks_t, launches_t) and launches > 0
    for rid in range(16):
        assert np.array_equal(bare[rid].items, inst[rid].items), rid
        assert (bare[rid].trials, bare[rid].accepted) == (
            inst[rid].trials, inst[rid].accepted), rid
