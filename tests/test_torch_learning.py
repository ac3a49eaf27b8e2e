"""The port's ONDPP learning (Section 5, Eq. 14) and basket trainer against
the reference.

The same seeds and numpy data go through ``repro`` and ``repro_torch``:
the init draws (V and B bit for bit; the normal draws of sigma and D to
float32 rounding, as ``random.normal``'s erfinv differs from XLA's in the
last bits), the planted basket generators (equal arrays), the three
objectives and their gradients (rtol 1e-5 and 1e-4), the projection's
invariants, a 50-step minibatch fit of each kind (the minibatch indices
equal, the losses within rtol 1e-4 step by step), the exports, and the
reference pipeline's MPR check (``test_learning_pipeline.py``: lift > 10,
model > 70) on the port's own fit.  Everything runs on the CPU, in the
key layout of the reference's golden files (the port's default).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import golden_key_layout
from repro.core import learning as jl
from repro.core.types import NDPPParams as JaxParams
from repro.core.types import ONDPPParams as JaxONDPP
from repro.data import baskets as jdata
from repro.serve.next_item import NextItemServer as JaxServer
from repro.train import ndpp as jtrain
from repro_torch import random as trandom
from repro_torch.convert import baskets_from_numpy, ondpp_params_from_numpy
from repro_torch.core import learning as tl
from repro_torch.core.types import NDPPParams, ONDPPParams
from repro_torch.data import baskets as tdata
from repro_torch.serve.next_item import NextItemServer
from repro_torch.train import ndpp as ttrain

RTOL, ATOL = 1e-5, 1e-6
M, K = 24, 6


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else a)


def _port_baskets(b):
    return baskets_from_numpy(np.asarray(b.items), np.asarray(b.mask),
                              device="cpu")


def _jax_baskets(items, mask):
    return jl.Baskets(jnp.asarray(items, jnp.int32), jnp.asarray(mask))


@pytest.fixture(scope="module")
def data():
    """Planted topic baskets at M = 24 from both generators."""
    with golden_key_layout():
        ref = jdata.planted_baskets(M, 120, k_max=5, seed=3, n_topics=4)
    port = tdata.planted_baskets(M, 120, k_max=5, seed=3, n_topics=4,
                                 device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def params():
    """Seeded general factors (numpy) with V ⟂ B not imposed."""
    rng = np.random.default_rng(41)
    v = (rng.normal(size=(M, K)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(M, K)) * 0.5).astype(np.float32)
    d = rng.normal(size=(K, K)).astype(np.float32)
    sigma = np.abs(rng.normal(size=(K // 2,))).astype(np.float32)
    return v, b, d, sigma


# ------------------------------------------------------------- init, data
@pytest.mark.parametrize("partitionable", [False, True])
def test_init_draws_equal_reference(partitionable):
    key = jax.random.PRNGKey(5)
    with jax.threefry_partitionable(partitionable):
        ref_nd = jl.init_ndpp(key, M, K)
        ref_on = jl.init_ondpp(key, M, K)
    with trandom.threefry_partitionable(partitionable):
        nd = tl.init_ndpp(np.asarray(key), M, K, device="cpu")
        on = tl.init_ondpp(np.asarray(key), M, K, device="cpu")
    assert np.array_equal(_np(nd.V), np.asarray(ref_nd.V))
    assert np.array_equal(_np(nd.B), np.asarray(ref_nd.B))
    np.testing.assert_allclose(_np(nd.D), np.asarray(ref_nd.D), rtol=1e-5,
                               atol=5e-6)
    for name in ("V", "B", "sigma"):
        np.testing.assert_allclose(_np(getattr(on, name)),
                                   np.asarray(getattr(ref_on, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("init", ["init_ondpp", "init_ndpp"])
@pytest.mark.parametrize("key_form", ["torch", "numpy"])
def test_init_defaults_to_cuda(init, key_form):
    """Without ``device=`` an init draws on ``cuda``, as every entry point
    does: a CPU key does not pull it onto the CPU."""
    key = trandom.PRNGKey(5)
    if key_form == "numpy":
        key = key.numpy().astype(np.uint32)
    fn = getattr(tl, init)
    if torch.cuda.is_available():
        assert fn(key, M, K).V.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(key, M, K)


@pytest.mark.parametrize("style", ["topic", "hothead", "hothead_direct"])
def test_basket_generators_equal(style):
    if style == "topic":
        def gen(mod, **kw):
            return mod.planted_baskets(40, 200, k_max=6, seed=9, **kw)
    elif style == "hothead":
        def gen(mod, **kw):
            return mod.planted_baskets(12, 300, style="hothead", seed=2,
                                       n_pairs=3, **kw)
    else:
        def gen(mod, **kw):
            return mod.hothead_baskets(16, 300, n_pairs=4, p_head=0.5,
                                       p_comp=0.95, p_noise=0.45, seed=0,
                                       **kw)
    ref = gen(jdata)
    port = gen(tdata, device="cpu")
    for r, p in zip(ref, port):
        assert np.array_equal(np.asarray(r.items), _np(p.items))
        assert np.array_equal(np.asarray(r.mask), _np(p.mask))
        assert p.items.dtype == torch.int64 and p.mask.dtype == torch.float32


def test_planted_baskets_refuses_mixed_styles():
    with pytest.raises(ValueError, match="hothead"):
        tdata.planted_baskets(12, 10, k_max=4, style="hothead", device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        tdata.planted_baskets(12, 10, n_pairs=2, device="cpu")


def test_item_frequencies_equal(data):
    ref, port = data
    for r, p in zip(ref, port):
        assert np.array_equal(_np(tl.item_frequencies(p, M)),
                              np.asarray(jl.item_frequencies(r, M)))


# ----------------------------------------------------------------- losses
def _loss_pair(kind, params, ref_b, port_b, freq):
    """(reference loss and grads, port loss and grads) as numpy."""
    v, b, d, sigma = params
    if kind == "ondpp":
        names = ("V", "B", "sigma")
        jp = JaxONDPP(*(jnp.asarray(a) for a in (v, b, sigma)))

        def jfn(p):
            return jl.ondpp_loss(p, ref_b, jnp.asarray(freq))
        leaves = [torch.tensor(a, requires_grad=True) for a in (v, b, sigma)]
        tloss = tl.ondpp_loss(ONDPPParams(*leaves), port_b,
                              torch.from_numpy(freq))
    elif kind == "ndpp":
        names = ("V", "B", "D")
        jp = JaxParams(*(jnp.asarray(a) for a in (v, b, d)))

        def jfn(p):
            return jl.ndpp_loss(p, ref_b, jnp.asarray(freq))
        leaves = [torch.tensor(a, requires_grad=True) for a in (v, b, d)]
        tloss = tl.ndpp_loss(NDPPParams(*leaves), port_b,
                             torch.from_numpy(freq))
    else:
        names = ("V",)
        jp = jnp.asarray(v)

        def jfn(p):
            return jl.symmetric_dpp_loss(p, ref_b, jnp.asarray(freq))
        leaves = [torch.tensor(v, requires_grad=True)]
        tloss = tl.symmetric_dpp_loss(leaves[0], port_b,
                                      torch.from_numpy(freq))
    jloss, jgrads = jax.value_and_grad(jfn)(jp)
    jg = ([getattr(jgrads, n) for n in names] if kind != "symmetric"
          else [jgrads])
    tg = torch.autograd.grad(tloss, leaves)
    return (float(jloss), [np.asarray(g) for g in jg]), \
        (float(tloss), [_np(g) for g in tg]), names


@pytest.mark.parametrize("kind", ["ondpp", "ndpp", "symmetric"])
def test_losses_and_gradients_equal(kind, data, params):
    (ref, _), (port, _) = data
    freq = np.asarray(jl.item_frequencies(ref, M))
    (jloss, jg), (tloss, tg), names = _loss_pair(kind, params, ref, port,
                                                 freq)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL, atol=ATOL)
    for n, a, b in zip(names, tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=n)


def test_basket_logdets_and_normalizer_equal(data, params):
    (ref, _), (port, _) = data
    v, b, d, _ = params
    want = np.asarray(jl._basket_logdets(jnp.asarray(v), jnp.asarray(b),
                                         jnp.asarray(d), ref))
    got = _np(tl._basket_logdets(*(torch.from_numpy(a) for a in (v, b, d)),
                                 port))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    want = float(jl.log_normalizer(jnp.asarray(v), jnp.asarray(b),
                                   jnp.asarray(d)))
    got = float(tl.log_normalizer(*(torch.from_numpy(a) for a in (v, b, d))))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # log det(L + I) from the dense kernel, float64
    lmat = (v @ v.T + b @ (d - d.T) @ b.T).astype(np.float64)
    np.testing.assert_allclose(got, np.linalg.slogdet(np.eye(M) + lmat)[1],
                               rtol=1e-4)


def test_project_constraints_invariants(params):
    v, b, _, sigma = params
    raw = ONDPPParams(*(torch.from_numpy(a) for a in (v, b, -sigma)))
    p = tl.project_constraints(raw)
    bb = _np(p.B)
    np.testing.assert_allclose(bb.T @ bb, np.eye(K), atol=2e-6)
    assert np.abs(_np(p.V).T @ bb).max() < 2e-6
    assert (_np(p.sigma) >= 0).all()
    ref = jl.project_constraints(JaxONDPP(jnp.asarray(v), jnp.asarray(b),
                                          jnp.asarray(-sigma)))
    for name in ("V", "B", "sigma"):
        np.testing.assert_allclose(_np(getattr(p, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=2e-6, err_msg=name)
    # the projection is idempotent to float32 rounding
    again = tl.project_constraints(p)
    np.testing.assert_allclose(_np(again.B), bb, atol=2e-6)


# -------------------------------------------------------------------- fit
FIT_STEPS = 50


@pytest.mark.parametrize("kind", ["ondpp", "ndpp"])
def test_fit_equals_reference(kind, data):
    """50 minibatch steps from the same init: each step's minibatch is the
    reference's, index for index, and the losses agree step by step."""
    (ref, _), (port, _) = data
    cfg = dict(steps=FIT_STEPS, minibatch=16, lr=0.01, seed=4, scan_chunk=20)
    with golden_key_layout():
        fit = jtrain.fit_ondpp if kind == "ondpp" else jtrain.fit_ndpp
        want = fit(ref, M, K, jtrain.BasketTrainConfig(**cfg))
        _, data_key = jax.random.split(jax.random.PRNGKey(cfg["seed"]))
        idx = [np.asarray(jax.random.randint(
            jax.random.fold_in(data_key, s), (16,), 0, port.items.shape[0]))
            for s in range(FIT_STEPS)]
    _, tkey = ttrain.fit_keys(cfg["seed"], "cpu")
    for s in range(FIT_STEPS):
        assert np.array_equal(_np(ttrain.minibatch_indices(
            tkey, s, 16, port.items.shape[0])), idx[s])
    fit = ttrain.fit_ondpp if kind == "ondpp" else ttrain.fit_ndpp
    got = fit(port, M, K, ttrain.BasketTrainConfig(**cfg))
    assert got.losses.shape == (FIT_STEPS,) and got.step == FIT_STEPS
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    np.testing.assert_allclose(got.loss_init, want.loss_init, rtol=1e-5)
    np.testing.assert_allclose(got.loss_final, want.loss_final, rtol=1e-4)
    assert got.loss_final < got.loss_init
    if kind == "ondpp":
        b = _np(got.params.B)
        np.testing.assert_allclose(b.T @ b, np.eye(K), atol=2e-6)
        assert np.abs(_np(got.params.V).T @ b).max() < 2e-6
        assert (_np(got.params.sigma) >= 0).all()


def test_fit_schedule_independent_of_chunk(data):
    (_, _), (port, _) = data
    cfg = ttrain.BasketTrainConfig(steps=12, minibatch=8, lr=0.01, seed=1,
                                   scan_chunk=12)
    a = ttrain.fit_ondpp(port, M, K, cfg)
    b = ttrain.fit_ondpp(port, M, K, dataclasses.replace(cfg, scan_chunk=5))
    assert np.array_equal(a.losses, b.losses)
    assert torch.equal(a.params.V, b.params.V)


def test_fit_explicit_init_is_projected_and_logged(data, params):
    (_, _), (port, _) = data
    v, b, _, sigma = params
    init = ONDPPParams(*(torch.from_numpy(a) for a in (v, b, -sigma)))
    lines = []
    res = ttrain.fit_ondpp(port, M, K, ttrain.BasketTrainConfig(
        steps=6, lr=0.01, scan_chunk=3, log_every=3), init_params=init,
        log_fn=lines.append)
    assert len(lines) == 2 and lines[-1].startswith("[ndpp-trainer] step 6")
    want = float(tl.ondpp_loss(tl.project_constraints(init), port,
                               tl.item_frequencies(port, M)))
    np.testing.assert_allclose(res.loss_init, want, rtol=1e-6)
    # the explicit init itself is left as it was
    assert (init.sigma < 0).all()


def test_fit_refuses_checkpoints_and_bad_minibatch(data):
    (_, _), (port, _) = data
    with pytest.raises(NotImplementedError, match="8.3"):
        ttrain.fit_ondpp(port, M, K, ttrain.BasketTrainConfig(
            steps=1, checkpoint_dir="ckpt"))
    with pytest.raises(ValueError, match="minibatch"):
        ttrain.fit_ndpp(port, M, K, ttrain.BasketTrainConfig(
            steps=1, minibatch=0))


# ---------------------------------------------------------------- exports
def test_moment_init_and_exports_equal_reference():
    ref_tr, _ = jdata.hothead_baskets(8, 400, n_pairs=2, seed=1)
    tr = _port_baskets(ref_tr)
    want = jtrain.moment_init_hothead(ref_tr, 8, 6, 2)
    got = ttrain.moment_init_hothead(tr, 8, 6, 2)
    for name in ("V", "B", "D"):
        assert np.array_equal(_np(getattr(got, name)),
                              np.asarray(getattr(want, name))), name
    with pytest.raises(ValueError, match="n_pairs"):
        ttrain.moment_init_hothead(tr, 8, 3, 2)
    # the Youla export of the same factors, float32 either side
    sp, jsp = ttrain.export_spectral(got), jtrain.export_spectral(want)
    np.testing.assert_allclose(_np(sp.sigma), np.asarray(jsp.sigma),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(sp.Z), np.asarray(jsp.Z), rtol=RTOL,
                               atol=ATOL)
    sampler = ttrain.export_sampler(got, block=2)
    assert sampler.device == torch.device("cpu") and sampler.M == 8
    cat = ttrain.export_catalog(got, block=2)
    assert cat.device == torch.device("cpu")
    assert ttrain.ondpp_trial_bound(6) == jtrain.ondpp_trial_bound(6) == 8.0
    on = ondpp_params_from_numpy(*(np.asarray(a) for a in (
        want.V, want.B, np.ones(3, np.float32))), device="cpu")
    assert torch.equal(ttrain.as_general(on).D, on.to_general().D)
    assert ttrain.as_general(got) is got


def test_learned_mpr_beats_frequency_baseline():
    """The reference pipeline's check on the port's own fit: balanced
    pairs, so popularity is uninformative and basket context is all; the
    learned ONDPP beats the baseline on the same held-out draws (the
    reference reads ~79 against ~57)."""
    m2, k2 = 16, 8
    tr, te = tdata.hothead_baskets(m2, 800, n_pairs=4, p_head=0.5,
                                   p_comp=0.95, p_noise=0.45, seed=0,
                                   device="cpu")
    res = ttrain.fit_ondpp(tr, m2, k2, ttrain.BasketTrainConfig(
        steps=800, lr=0.05, scan_chunk=400))
    assert res.improvement >= 0.2
    srv = NextItemServer(res.params)
    rep = srv.evaluate_mpr(te, trandom.PRNGKey(7), train=tr)
    assert rep.model > rep.frequency + 10.0, (rep.model, rep.frequency)
    assert rep.model > 70.0
    assert rep.n_baskets == te.items.shape[0] and rep.lift > 10.0
    s = _np(srv.scores([0, 2]))
    assert np.isneginf(s[[0, 2]]).all()
    rest = np.delete(s, [0, 2])
    assert np.isfinite(rest).all() and (rest > 0).all()
    # the reference's evaluation of the port's learned kernel, same key
    p = res.params
    with golden_key_layout():
        ref_rep = JaxServer(JaxONDPP(*(jnp.asarray(_np(a)) for a in (
            p.V, p.B, p.sigma)))).evaluate_mpr(
            jl.Baskets(jnp.asarray(_np(te.items), jnp.int32),
                       jnp.asarray(_np(te.mask))),
            jax.random.PRNGKey(7),
            train=jl.Baskets(jnp.asarray(_np(tr.items), jnp.int32),
                             jnp.asarray(_np(tr.mask))))
    np.testing.assert_allclose(rep.model, ref_rep.model, atol=1e-3)
    np.testing.assert_allclose(rep.frequency, ref_rep.frequency, atol=1e-3)
