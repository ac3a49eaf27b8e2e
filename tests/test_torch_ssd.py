"""The port's SSD scan (``repro_torch.kernels.ssd``: kernel 8's plain
versions and dispatch) and Mamba2 mixer (``repro_torch.models.mamba``)
against the reference, on the CPU: the same numpy inputs, made from a seed,
through both.

Shapes are ``tests/test_kernels.py``'s SSD cases plus one whose decays go
down to 1e-6, so that ``cum`` underflows ``exp`` inside a chunk (the
kernel's hardest case: masking after the exp would give NaN gradients).
Tolerances, for float32 sums in other orders: every element within
``row_excess`` at 1e-4 of its |value| + 1e-4 of its row's max (a row: a
(batch, step, head) of y, dx, db, dc; a (batch, head) state; a chunk of
one head of d log a).  da = d log a / a is compared as d log a = da * a:
dividing float32 sums by decays of 1e-6 makes da itself ill-conditioned.
The card's kernels are held against these plain versions in
``test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (caps torch's CPU threads)

from repro.configs import get_smoke_config as r_smoke
from repro.kernels.ssd import ops as rsops
from repro.kernels.ssd.ref import ssd_ref as r_ssd_ref
from repro.models import mamba as r_mamba
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd import ops as tsops
from repro_torch.kernels.ssd.ref import (chunk_states, da_rows, row_excess,
                                         ssd_backward_ref, ssd_chunked_ref,
                                         ssd_forward_ref, ssd_ref)
from repro_torch.models import mamba as t_mamba

CASES = [(2, 64, 2, 16, 8, 16, 0.7), (1, 128, 4, 32, 16, 32, 0.7),
         (1, 96, 1, 8, 4, 32, 0.7), (1, 128, 3, 16, 8, 64, 1e-6)]
REL = 1e-4


def _inputs(b, s, h, p, n, lo, seed=0):
    rng = np.random.default_rng(seed + s + 7 * n + p)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            np.exp(rng.uniform(np.log(lo), 0, size=(b, s, h))).astype(
                np.float32),
            rng.normal(size=(b, s, h, n)).astype(np.float32),
            rng.normal(size=(b, s, h, n)).astype(np.float32))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _excess(got, want, row_dims=1):
    return row_excess(got, torch.from_numpy(np.array(want, np.float32)),
                      row_dims, REL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,lo", CASES)
def test_plain_ssd_matches_reference(b, s, h, p, n, chunk, lo):
    """The port's chunked scan against the reference's chunked scan, its
    Pallas kernel in interpret mode and its time scan; the port's time
    scan against the reference's."""
    arrs = _inputs(b, s, h, p, n, lo)
    j = [jnp.asarray(a) for a in arrs]
    y, hl = ssd_chunked_ref(*_t(arrs), chunk=chunk)
    ty, th = ssd_ref(*_t(arrs))
    assert torch.isfinite(y).all() and torch.isfinite(hl).all()
    for want_y, want_h in (rsops.ssd_chunked_ref(*j, chunk=chunk),
                           rsops.ssd(*j, chunk=chunk, force_interpret=True),
                           r_ssd_ref(*j)):
        assert _excess(y, want_y) <= 1
        assert _excess(hl, want_h, 2) <= 1
    ry, rh = r_ssd_ref(*j)
    assert _excess(ty, ry) <= 1 and _excess(th, rh, 2) <= 1


@pytest.mark.parametrize("b,s,h,p,n,chunk,lo", CASES)
def test_chunk_parallel_forward_matches_reference(b, s, h, p, n, chunk, lo):
    """``ssd_forward_ref`` (the three passes of the forward's wgmma route:
    S_q a chunk, the carry of the states across chunks, y a chunk) against
    the reference's chunked scan and its Pallas kernel in interpret mode;
    its chunk-start states against ``chunk_states``."""
    arrs = _inputs(b, s, h, p, n, lo)
    j = [jnp.asarray(a) for a in arrs]
    y, hl, states = ssd_forward_ref(*_t(arrs), chunk)
    assert y.dtype == torch.float32 and hl.dtype == states.dtype
    assert tuple(states.shape) == (b, h, s // chunk, n, p)
    assert torch.isfinite(y).all() and torch.isfinite(states).all()
    for want_y, want_h in (rsops.ssd_chunked_ref(*j, chunk=chunk),
                           rsops.ssd(*j, chunk=chunk, force_interpret=True)):
        assert _excess(y, want_y) <= 1
        assert _excess(hl, want_h, 2) <= 1
    assert row_excess(states, chunk_states(*_t(arrs), chunk), 2, REL) <= 1


@pytest.mark.parametrize("b,s,h,p,n,chunk,lo", CASES)
def test_plain_ssd_grads_match_jax_grad(b, s, h, p, n, chunk, lo):
    """Gradients of <y, dy> + <h_last, dh> for x, a, b and c: autograd of
    the port's chunked scan against ``jax.grad`` of the reference's, all
    finite where the decays go down to 1e-6."""
    arrs = _inputs(b, s, h, p, n, lo)
    rng = np.random.default_rng(1)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dh = rng.normal(size=(b, h, n, p)).astype(np.float32)

    def f(*xs):
        y, hl = rsops.ssd_chunked_ref(*xs, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(hl * dh)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrs))
    xs = [t.requires_grad_(True) for t in _t(arrs)]
    y, hl = ssd_chunked_ref(*xs, chunk=chunk)
    got = torch.autograd.grad((y, hl), xs, (torch.from_numpy(dy),
                                            torch.from_numpy(dh)))
    assert all(torch.isfinite(g).all() for g in got)
    a = torch.from_numpy(arrs[1])
    assert _excess(got[0], want[0]) <= 1
    assert row_excess(da_rows(got[1] * a, chunk), da_rows(
        torch.from_numpy(np.array(want[1])) * a, chunk), 1, REL) <= 1
    assert _excess(got[2], want[2]) <= 1
    assert _excess(got[3], want[3]) <= 1


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk,lo", CASES)
def test_chunk_parallel_backward_matches_jax_grad(b, s, h, p, n, chunk, lo,
                                                  with_dh):
    """``ssd_backward_ref`` (the three passes of the wgmma route: U a chunk,
    the carry of dH across chunks, the outputs a chunk) from
    ``chunk_states``' float32 chunk-start states against ``jax.grad`` of
    the reference's chunked scan and autograd of the port's, with the
    gradient of h_last zero and nonzero; the states against the
    reference's scan run up to each chunk's start."""
    arrs = _inputs(b, s, h, p, n, lo)
    rng = np.random.default_rng(1)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dh = (rng.normal(size=(b, h, n, p)) if with_dh
          else np.zeros((b, h, n, p))).astype(np.float32)

    def f(*xs):
        y, hl = rsops.ssd_chunked_ref(*xs, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(hl * dh)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrs))
    xs = [t.requires_grad_(True) for t in _t(arrs)]
    y, hl = ssd_chunked_ref(*xs, chunk=chunk)
    mine = torch.autograd.grad((y, hl), xs, (torch.from_numpy(dy),
                                             torch.from_numpy(dh)))
    states = chunk_states(*_t(arrs), chunk)
    for q in range(1, s // chunk):
        _, hq = r_ssd_ref(*(jnp.asarray(a[:, :q * chunk]) for a in arrs))
        assert _excess(states[:, :, q], hq, 2) <= 1
    got = ssd_backward_ref(*_t(arrs), states, torch.from_numpy(dy),
                           torch.from_numpy(dh) if with_dh else None, chunk)
    assert all(torch.isfinite(g).all() for g in got)
    a = torch.from_numpy(arrs[1])
    for oracle in (want, mine):
        assert _excess(got[0], oracle[0]) <= 1
        assert row_excess(da_rows(got[1] * a, chunk), da_rows(
            torch.as_tensor(np.array(oracle[1])) * a, chunk), 1, REL) <= 1
        assert _excess(got[2], oracle[2]) <= 1
        assert _excess(got[3], oracle[3]) <= 1


def test_ssd_on_the_cpu_is_the_plain_version():
    """``ssd`` on CPU tensors runs ``ssd_chunked_ref`` (with a carried-in
    state too, as the reference's fallback) and launches nothing."""
    arrs = _inputs(1, 64, 2, 16, 8, 0.5)
    h0 = np.random.default_rng(2).normal(size=(1, 2, 8, 16)).astype(
        np.float32)
    f0, b0 = tsops.launches, tsops.bwd_launches
    for state in (None, h0):
        got = tsops.ssd(*_t(arrs), None if state is None else
                        torch.from_numpy(state), chunk=32)
        want = rsops.ssd(*(jnp.asarray(a) for a in arrs),
                         None if state is None else jnp.asarray(state),
                         chunk=32)
        assert _excess(got[0], want[0]) <= 1
        assert _excess(got[1], want[1], 2) <= 1
    assert (tsops.launches, tsops.bwd_launches) == (f0, b0)


def test_kernel_refuses_shapes_before_building():
    """What the kernel's tiles cannot take raises before any build (this
    machine may have no nvcc): S not a multiple of the chunk, P not a
    multiple of 8 or above 64, N above 128, mixed dtypes, a missing or
    misshapen state for the backward."""
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    ok = (z(1, 64, 2, 16), z(1, 64, 2), z(1, 64, 2, 8), z(1, 64, 2, 8))
    cases = [
        ((z(1, 48, 2, 16), z(1, 48, 2), z(1, 48, 2, 8), z(1, 48, 2, 8)),
         "divides the sequence"),
        ((z(1, 64, 2, 12), z(1, 64, 2), z(1, 64, 2, 8), z(1, 64, 2, 8)),
         "multiple of 8"),
        ((z(1, 64, 2, 72), z(1, 64, 2), z(1, 64, 2, 8), z(1, 64, 2, 8)),
         "up to 64"),
        ((z(1, 64, 2, 16), z(1, 64, 2), z(1, 64, 2, 130), z(1, 64, 2, 130)),
         "N up to 128"),
        ((z(1, 64, 2, 16, dt=torch.bfloat16), *ok[1:]), "all bfloat16"),
        ((ok[0], ok[1].double(), *ok[2:]), "a must be float32"),
        ((ok[0], ok[1], z(1, 64, 3, 8), ok[3]), r"b = c|differ")]
    for args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tsops.ssd_forward(*args, 32)
    with pytest.raises(ValueError, match="chunk-start states"):
        tsops.ssd_backward(*ok, None, ok[0], None, 32)
    with pytest.raises(ValueError, match="chunk of 1..128"):
        tsops.ssd_forward(*[torch.cat([t] * 4, 1) for t in ok], 256)


@pytest.mark.parametrize("dtype,chunk,n,p,route", [
    (torch.bfloat16, 128, 128, 64, "wgmma"), (torch.bfloat16, 64, 48, 32,
                                               "wgmma"),
    (torch.bfloat16, 64, 16, 16, "wgmma"), (torch.float32, 128, 128, 64,
                                             "simt"),
    (torch.bfloat16, 32, 128, 64, "simt"), (torch.bfloat16, 40, 128, 64,
                                             "simt"),
    (torch.bfloat16, 128, 20, 64, "simt"), (torch.bfloat16, 128, 128, 24,
                                             "simt")])
def test_backward_route_by_dtype_and_shape(dtype, chunk, n, p, route):
    """The backward's route comes from the dtype and shape alone: the
    tensor cores for bf16 at chunk 64 or 128 with N and P multiples of
    16, the float32 SIMT kernel for the rest."""
    assert tsops._bwd_route(dtype, chunk, n, p) == route


@pytest.mark.parametrize("dtype,chunk,n,p,route", [
    (torch.bfloat16, 128, 128, 64, "wgmma"), (torch.bfloat16, 64, 48, 32,
                                               "wgmma"),
    (torch.bfloat16, 64, 16, 16, "wgmma"), (torch.float32, 128, 128, 64,
                                             "simt"),
    (torch.bfloat16, 32, 128, 64, "simt"), (torch.bfloat16, 40, 128, 64,
                                             "simt"),
    (torch.bfloat16, 128, 20, 64, "simt"), (torch.bfloat16, 128, 128, 24,
                                             "simt")])
def test_forward_route_by_dtype_and_shape(dtype, chunk, n, p, route):
    """The forward's route comes from the dtype and shape alone, by the
    backward's rule: the tensor cores for bf16 at chunk 64 or 128 with N
    and P multiples of 16, the float32 SIMT kernel for the rest."""
    assert tsops._fwd_route(dtype, chunk, n, p) == route


def test_row_excess_passes_roundings_and_rejects_planted_faults():
    """One bfloat16 rounding of y passes the per-row tolerance; y with
    the state not carried across one chunk boundary, or with the wrong
    head's decays, fails it."""
    b, s, h, p, n, q = 1, 256, 4, 16, 8, 64
    rng = np.random.default_rng(3)
    x, _, bb, cc = _t(_inputs(b, s, h, p, n, 0.5))
    # heads of weak and of strong decay
    a = torch.from_numpy(np.exp(-np.array([0.05, 1.0, 4.0, 11.0]) * np.log1p(
        np.exp(rng.normal(size=(b, s, h))))).astype(np.float32))
    want, _ = ssd_chunked_ref(x, a, bb, cc, chunk=q)
    assert row_excess(want.bfloat16(), want) <= 0.5
    k = s // 2
    split = torch.cat([ssd_chunked_ref(x[:, :k], a[:, :k], bb[:, :k],
                                       cc[:, :k], chunk=q)[0],
                       ssd_chunked_ref(x[:, k:], a[:, k:], bb[:, k:],
                                       cc[:, k:], chunk=q)[0]], 1)
    rolled, _ = ssd_chunked_ref(x, a.roll(1, dims=2), bb, cc, chunk=q)
    for fault in (split, rolled):
        assert row_excess(fault, want) > 1


# ----------------------------------------------------------------- mixer
def _mixer_setup(seq=64, **kw):
    rcfg = dataclasses.replace(r_smoke("mamba2-1.3b"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"), **kw)
    rp, _ = r_mamba.init_mamba(rcfg, jax.random.PRNGKey(4))
    mixer = t_mamba.Mamba(tcfg, None, "cpu")
    with torch.no_grad():
        for k, prm in mixer.named_parameters():
            prm.copy_(torch.from_numpy(np.array(rp[k], np.float32)))
    x = np.random.default_rng(6).normal(size=(2, seq, rcfg.d_model)).astype(
        np.float32)
    return rcfg, tcfg, rp, mixer, x


@pytest.mark.parametrize("seq,chunk", [(64, 32), (96, 32), (16, 32)])
def test_mamba_mixer_matches_reference(seq, chunk):
    """``Mamba`` against ``mamba_forward`` without a cache on carried-across
    params: output and every parameter's gradient of <out, g>, within
    1e-4 of each one's max |.| (the chunk is min(chunk, S), as the
    reference's)."""
    rcfg, tcfg, rp, mixer, x = _mixer_setup(
        seq, mamba=dataclasses.replace(r_smoke("mamba2-1.3b").mamba,
                                       chunk=chunk))
    g = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def f(p, xx):
        out, cache = r_mamba.mamba_forward(rcfg, p, xx)
        assert cache is None
        return jnp.sum(out * g), out

    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(rp, jnp.asarray(x))
    out = mixer(torch.from_numpy(x))
    names = dict(mixer.named_parameters())
    grads = torch.autograd.grad(out, list(names.values()), torch.from_numpy(g))
    want = np.asarray(want)
    assert np.abs(out.detach().numpy() - want).max() <= 1e-4 * np.abs(
        want).max()
    assert set(names) == set(want_g)
    for (k, prm), gr in zip(names.items(), grads):
        w = np.asarray(want_g[k])
        assert gr.shape == w.shape == prm.shape, k
        assert np.abs(gr.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k


def test_mamba_softplus_is_jax_softplus():
    """``jax.nn.softplus`` is logaddexp(x, 0) at every x; ``F.softplus``
    switches to x above its threshold and differs there."""
    x = np.linspace(-30, 40, 701).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = t_mamba.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


def test_mamba_cache_paths_raise():
    _, tcfg, _, mixer, x = _mixer_setup()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        mixer(torch.from_numpy(x), cache={})
    for fn in (t_mamba.init_mamba_cache, tsops.ssd_decode_step):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn(tcfg, 2)
