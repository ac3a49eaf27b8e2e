"""The port's linear-time Cholesky sampler (Alg. 1) against the reference.

On the reference's golden frozen kernel (M=256, K=4) with its spectral
state carried across, every entry point gives the reference's masks key
for key, for one key and for a stack of keys (as ``jax.vmap``), in both
threefry layouts, and ``tests/golden/cholesky.json`` exactly.  The inner
matrix is float32 in both (rtol 1e-5); the scan's plain version
(``kernels/cholesky_scan/ref.py``) decides as the reference's scan, and
its marginals are within 1e-5 of a float64 dense-kernel conditioning
(Poulson's O(M^3) sampler) that follows the same decisions.  On the CPU
the port's sampler draws the exact NDPP distribution (chi-square against
enumeration at M = 8).
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _exactness import assert_chi_square_close, enumerate_subset_probs, histogram
from _torch_port import golden_key_layout, port_spectral
from repro.core import cholesky as jax_chol
from repro.core import preprocess as jax_preprocess
from repro.core.types import NDPPParams as JaxParams
from repro.core.types import x_from_sigma as jax_x_from_sigma
from repro_torch import random as trandom
from repro_torch.convert import params_from_numpy
from repro_torch.core import (
    NDPPParams,
    dense_l,
    marginal_inner,
    marginal_inner_from_params,
    sample_cholesky,
    sample_cholesky_blocked,
    sample_cholesky_inner,
    sample_cholesky_params,
    sample_cholesky_spectral,
    x_from_sigma,
)
from repro_torch.kernels.cholesky_scan import ops as scan_ops
from repro_torch.kernels.cholesky_scan.ref import (
    FAULTS,
    cholesky_scan_blocked_ref,
    cholesky_scan_ref,
    flip_gaps,
    planted_scan,
)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "cholesky.json"


def factors(m, k, seed, scale):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(m, k)) * scale).astype(np.float32)
    b = (rng.normal(size=(m, k)) * scale).astype(np.float32)
    d = rng.normal(size=(k, k)).astype(np.float32)
    return v, b, d


@pytest.fixture(scope="module")
def golden():
    """``tests/test_golden.py::frozen_kernel``'s spectral state in both."""
    v, b, d = factors(256, 4, 31415, 0.1)
    ref = jax_preprocess(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d),
                         block=4).sp
    return ref, port_spectral(ref), (v, b, d)


@pytest.mark.parametrize("m", [64, 256])
def test_marginal_inner_matches_reference(m):
    v, b, d = factors(m, 4, m, 0.3)
    z_ref, x_ref, w_ref = jax_chol.marginal_inner_from_params(
        JaxParams(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d)))
    z, x, w = marginal_inner_from_params(params_from_numpy(v, b, d, "cpu"))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_ref))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        marginal_inner(z, x).numpy(),
        np.asarray(jax_chol.marginal_inner(z_ref, x_ref)), rtol=1e-5,
        atol=1e-6)


def test_golden_cholesky_draws(golden):
    """``tests/test_golden.py::cholesky_payload``: live and pinned."""
    ref, got, _ = golden
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(1), 8)
        live = np.asarray(jax.vmap(
            lambda k: jax_chol.sample_cholesky_spectral(ref, k))(keys))
        port = sample_cholesky_spectral(got, trandom.as_key(keys)).numpy()
    np.testing.assert_array_equal(port, live)
    subsets = [np.flatnonzero(t).tolist() for t in port]
    assert subsets == json.loads(GOLDEN.read_text())["subsets"]


def _entry_points(ref, got, v, b, d):
    """(name, reference call, port call) per entry point."""
    x_ref = jax_x_from_sigma(ref.K, ref.sigma)
    x = x_from_sigma(got.K, got.sigma)
    w_ref = jax_chol.marginal_inner(ref.Z, x_ref)
    w = marginal_inner(got.Z, x)
    p_ref = JaxParams(jnp.asarray(v), jnp.asarray(b), jnp.asarray(d))
    p = params_from_numpy(v, b, d, "cpu")
    calls = {
        "sample_cholesky": (
            lambda k: jax_chol.sample_cholesky(ref.Z, x_ref, k),
            lambda k: sample_cholesky(got.Z, x, k)),
        "inner": (lambda k: jax_chol.sample_cholesky_inner(ref.Z, w_ref, k),
                  lambda k: sample_cholesky_inner(got.Z, w, k)),
        "params": (lambda k: jax_chol.sample_cholesky_params(p_ref, k),
                   lambda k: sample_cholesky_params(p, k)),
        "spectral": (lambda k: jax_chol.sample_cholesky_spectral(ref, k),
                     lambda k: sample_cholesky_spectral(got, k)),
    }
    for block in (4, 256, 7):
        calls[f"blocked{block}"] = (
            lambda k, blk=block: jax_chol.sample_cholesky_blocked(
                ref.Z, x_ref, k, block=blk),
            lambda k, blk=block: sample_cholesky_blocked(got.Z, x, k,
                                                         block=blk))
    return calls


ENTRY_POINTS = ["sample_cholesky", "inner", "params", "spectral",
                "blocked4", "blocked256", "blocked7"]


@pytest.mark.parametrize("stack", [False, True], ids=["one_key", "stack"])
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_match_reference(golden, entry, stack):
    """A key (2,) gives the reference's mask (M,); a stack (N, 2) gives
    ``vmap`` of the reference over the keys, (N, M)."""
    ref, got, (v, b, d) = golden
    ref_call, port_call = _entry_points(ref, got, v, b, d)[entry]
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(11), 6)
        if stack:
            want = np.asarray(jax.vmap(ref_call)(keys))
            port = port_call(trandom.as_key(keys)).numpy()
        else:
            want = np.asarray(ref_call(keys[2]))
            port = port_call(trandom.as_key(keys[2])).numpy()
    assert port.shape == want.shape and port.dtype == bool
    np.testing.assert_array_equal(port, want)


def test_cholesky_draws_in_partitionable_layout(golden):
    """Under ``jax_threefry_partitionable=True`` on both sides."""
    ref, got, _ = golden
    x_ref = jax_x_from_sigma(ref.K, ref.sigma)
    with jax.threefry_partitionable(True), \
            trandom.threefry_partitionable(True):
        keys = jax.random.split(jax.random.PRNGKey(5), 6)
        want = np.asarray(jax.vmap(
            lambda k: jax_chol.sample_cholesky_blocked(ref.Z, x_ref, k,
                                                       block=7))(keys))
        port = sample_cholesky_blocked(
            got.Z, x_from_sigma(got.K, got.sigma), trandom.as_key(keys),
            block=7).numpy()
    np.testing.assert_array_equal(port, want)


def dense_conditional_marginals(Z, W, take):
    """Float64 Poulson conditioning of K = Z W Z^T (M x M) along the given
    decisions: p_i = K_ii, then K -= K[:, i] K[i, :] / (K_ii - [not
    taken])."""
    k = Z @ W @ Z.T
    p = np.empty(len(take))
    for i, t in enumerate(take):
        p[i] = k[i, i]
        k = k - np.outer(k[:, i], k[i, :]) / (k[i, i] - (0.0 if t else 1.0))
    return p


def test_scan_ref_matches_reference_scan(golden):
    """The plain scan on the reference's uniforms: the reference scan's
    decisions, and marginals within 1e-5 of a float64 dense conditioning
    along them."""
    ref, got, _ = golden
    x_ref = jax_x_from_sigma(ref.K, ref.sigma)
    w_ref = jax_chol.marginal_inner(ref.Z, x_ref)
    w = marginal_inner(got.Z, x_from_sigma(got.K, got.sigma))
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(3), 4)
        want = np.asarray(jax.vmap(
            lambda k: jax_chol.sample_cholesky_inner(ref.Z, w_ref, k))(keys))
        u = trandom.uniform(trandom.as_key(keys), (got.M,))
    take, p = cholesky_scan_ref(got.Z, w, u)
    np.testing.assert_array_equal(take.numpy(), want)
    z64, w64 = got.Z.double().numpy(), w.double().numpy()
    for n in range(len(keys)):
        dense = dense_conditional_marginals(z64, w64, want[n])
        np.testing.assert_allclose(p[n].numpy(), dense, rtol=0, atol=1e-5)


def test_zero_rows_are_never_taken():
    """Strict ``u < p``: a zero row (p = 0) is never taken, at u = 0 too,
    and its downdate leaves the state as it was."""
    v, b, d = factors(32, 4, 5, 0.4)
    z, _, w = marginal_inner_from_params(params_from_numpy(v, b, d, "cpu"))
    zero = [0, 3, 17, 31]
    z[zero] = 0.0
    u = torch.rand((64, 32), generator=torch.Generator().manual_seed(0))
    u[:, zero] = 0.0
    take, p = scan_ops.cholesky_scan(z, w, u)
    assert not bool(take[:, zero].any())
    assert bool((p[:, zero] == 0).all())
    kept = [i for i in range(32) if i not in zero]
    take2, p2 = cholesky_scan_ref(z[kept], w, u[:, kept])
    assert torch.equal(take[:, kept], take2)
    assert torch.equal(p[:, kept], p2)


def test_scan_counts_no_launch_on_the_cpu():
    z = torch.zeros((4, 8))
    before = scan_ops.launches
    scan_ops.cholesky_scan(z, torch.eye(8), torch.zeros((2, 4)))
    assert scan_ops.launches == before
    with pytest.raises(ValueError, match="shape mismatch"):
        scan_ops.cholesky_scan(z, torch.eye(8), torch.zeros((2, 5)))


def scan_inputs(m, r, n, seed):
    """Rows of a random NDPP (L = Z X Z^T, X = I + S with S skew) scaled so
    that marginals are O(0.1), W = X (I + Z^T Z X)^-1 from float64, and
    uniforms, all float32."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(m, r)) / np.sqrt(m)
    a = rng.normal(size=(r, r))
    x = np.eye(r) + 0.5 * (a - a.T)
    w = x @ np.linalg.inv(np.eye(r) + z.T @ z @ x)
    u = rng.uniform(size=(n, m))
    return (torch.tensor(z, dtype=torch.float32),
            torch.tensor(w, dtype=torch.float32),
            torch.tensor(u, dtype=torch.float32))


def test_flip_rule_holds_float32_scan_to_float64():
    """The flip rule (``flip_gaps``: |p - p_plain| <= 1e-4 |p_plain| + 1e-6
    max|p_plain| before a draw's first flip) passes the float32 scan against
    the same scan in float64, on marginals of O(0.1) where every draw takes
    items, and holds its decisions."""
    z, w, u = scan_inputs(96, 24, 8, seed=40)
    take, p = cholesky_scan_ref(z, w, u)
    take64, p64 = cholesky_scan_ref(z.double(), w.double(), u.double())
    gaps = flip_gaps(take, p, take64, p64.float(), u)
    assert gaps["within"], gaps
    assert gaps["p_excess"] > 0.0, gaps
    assert gaps["compared_takes"] >= 8, gaps


@pytest.mark.parametrize("fault", FAULTS)
def test_flip_rule_refuses_planted_faults(fault):
    """Each planted fault of the plain scan fails the flip rule: all zeros,
    the downdate skipped (which keeps E|Y| = tr(K)), the denominator's sign
    flipped, the blocked form's rejected pivot left at p."""
    z, w, u = scan_inputs(96, 24, 8, seed=41)
    take, p = planted_scan(z, w, u, fault)
    gaps = flip_gaps(take, p, *cholesky_scan_ref(z, w, u), u)
    assert not gaps["within"], gaps
    assert max(gaps["p_excess"], gaps["flip_excess"]) > 100.0, gaps


@pytest.mark.parametrize("fair", [True, False], ids=["fair", "unfair"])
def test_flip_rule_judges_a_flip_by_its_margin(fair):
    """A flip counts as fair only where u lies within the limit of the plain
    marginal; items after it are not compared."""
    z, w, u = scan_inputs(64, 16, 4, seed=42)
    take_r, p_r = cholesky_scan_ref(z, w, u)
    j = 10
    limit = 1e-4 * float(p_r[1, j].abs()) + 1e-6 * float(p_r.abs().max())
    u[1, j] = p_r[1, j] + (0.5 if fair else 3.0) * limit
    take, p = take_r.clone(), p_r.clone()
    take[1, j] = ~take[1, j]
    p[1, j + 1:] = 0.0
    gaps = flip_gaps(take, p, take_r, p_r, u)
    assert gaps["flipped_draws"] == 1
    assert gaps["p_excess"] == 0.0
    assert gaps["within"] is fair, gaps


def _block_edges(m, block):
    """Rows at a block's first and last item, below m."""
    return sorted({i for s in range(0, m, block) for i in (s, s + block - 1)
                   if i < m})


@pytest.mark.parametrize("block", [1, 3, 32])
@pytest.mark.parametrize("m", [20, 100, 96],
                         ids=["M_below_block", "ragged", "whole_blocks"])
def test_blocked_ref_matches_sequential_float64(m, block):
    """In float64 the blocked form (the kernel's "blocked" route's order)
    makes the sequential scan's decisions with p within 1e-12 of it, for M
    below a block, M not a multiple of it, and zero rows at blocks' first
    and last items (never taken)."""
    z, w, u = scan_inputs(m, 24, 6, seed=m + block)
    zero = _block_edges(m, 32)[:6] + _block_edges(m, block)[:4]
    z[zero] = 0.0
    z, w, u = z.double(), w.double(), u.double()
    take, p = cholesky_scan_ref(z, w, u)
    take_b, p_b = cholesky_scan_blocked_ref(z, w, u, block)
    assert torch.equal(take_b, take)
    assert int(take.sum()) >= 6
    assert not bool(take_b[:, zero].any())
    torch.testing.assert_close(p_b, p, rtol=1e-12,
                               atol=1e-12 * float(p.abs().max()))


@pytest.mark.parametrize("block", [3, 32])
def test_blocked_ref_float32_within_flip_rule(block):
    """The blocked form in float32 stands to the float64 scan as the
    sequential one does: within the flip rule, decisions held."""
    z, w, u = scan_inputs(200, 32, 8, seed=43)
    take64, p64 = cholesky_scan_ref(z.double(), w.double(), u.double())
    gaps = flip_gaps(*cholesky_scan_blocked_ref(z, w, u, block), take64,
                     p64.float(), u)
    assert gaps["within"], gaps
    assert gaps["compared_takes"] >= 8 * 10, gaps


def test_blocked_ref_decides_as_reference(golden):
    """On the reference's uniforms the blocked form's decisions equal the
    reference scan's (``sample_cholesky_inner``) up to the flip rule, with
    the port's sequential p as the plain marginals."""
    ref, got, _ = golden
    x_ref = jax_x_from_sigma(ref.K, ref.sigma)
    w_ref = jax_chol.marginal_inner(ref.Z, x_ref)
    w = marginal_inner(got.Z, x_from_sigma(got.K, got.sigma))
    with golden_key_layout():
        keys = jax.random.split(jax.random.PRNGKey(5), 6)
        want = np.asarray(jax.vmap(
            lambda k: jax_chol.sample_cholesky_inner(ref.Z, w_ref, k))(keys))
        u = trandom.uniform(trandom.as_key(keys), (got.M,))
    _, p_seq = cholesky_scan_ref(got.Z, w, u)
    for block in (7, 32):
        gaps = flip_gaps(*cholesky_scan_blocked_ref(got.Z, w, u, block),
                         torch.from_numpy(want.copy()), p_seq, u)
        assert gaps["within"], (block, gaps)
        assert gaps["compared_takes"] >= 1, gaps


def test_scan_routes_by_width():
    """The kernel's route is a function of R alone: "blocked" up to
    ``BLOCKED_MAX_R``, "resident" to ``MAX_R``, wider refused."""
    assert scan_ops.route(1) == scan_ops.route(200) == "blocked"
    assert scan_ops.route(scan_ops.BLOCKED_MAX_R) == "blocked"
    assert scan_ops.route(scan_ops.BLOCKED_MAX_R + 1) == "resident"
    assert scan_ops.route(scan_ops.MAX_R) == "resident"
    for r in (0, scan_ops.MAX_R + 1):
        with pytest.raises(ValueError, match="R <= 224"):
            scan_ops.route(r)


M_EXACT, K_EXACT, N_SAMPLES = 8, 4, 20000


@pytest.mark.parametrize("block", [None, 3])
def test_cholesky_samples_exact_distribution(block):
    """Pr(Y) ∝ det(L_Y) at M = 8: chi-square against enumeration."""
    v, b, d = factors(M_EXACT, K_EXACT, 8, 0.6)
    params = params_from_numpy(v, b, d, "cpu")
    keys = trandom.split(trandom.PRNGKey(21), N_SAMPLES)
    if block is None:
        masks = sample_cholesky_params(params, keys)
    else:
        z, x, _ = marginal_inner_from_params(params)
        masks = sample_cholesky_blocked(z, x, keys, block=block)
    items = np.where(masks.numpy(), np.arange(M_EXACT)[None, :], -1)
    emp = histogram(items, masks.numpy())
    probs = enumerate_subset_probs(dense_l(NDPPParams(
        *(torch.as_tensor(a, dtype=torch.float64) for a in (v, b, d)))
    ).numpy())
    assert set(emp) <= set(probs)
    assert_chi_square_close(emp, probs, N_SAMPLES)
