"""The port's attention (``repro_torch.kernels.attention``, kernel 7's
plain versions and dispatch, and ``models.layers.chunked_causal_attention``)
against the reference, on the CPU: the same numpy inputs, made from a seed,
through both.

Shapes are ``tests/test_kernels.py``'s flash-attention cases (GQA g = 2,
1, 4, 2; S = 128-384; D = 64, 128) in float32 and bfloat16, with that
file's tolerances (rtol = 100 tol, atol = 10 tol; tol 2e-5 in float32,
3e-2 in bfloat16).  Gradients (float32) must agree within 1e-4 of each
gradient's max |.|: float32 sums in other orders.  The card's kernels are
held against these plain versions in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (caps torch's CPU threads)

from repro.kernels.attention import ops as raops
from repro.kernels.attention.ref import mha_ref as r_mha_ref
from repro.models.layers import chunked_causal_attention as r_chunked
from repro_torch.kernels.attention import ops as taops
from repro_torch.kernels.attention.ref import (bf16_excess, mha_lse_ref,
                                               mha_ref)
from repro_torch.models.layers import chunked_causal_attention

CASES = [(1, 4, 2, 128, 64), (2, 4, 4, 256, 64), (1, 8, 2, 128, 128),
         (1, 2, 1, 384, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(b, h, kvh, sq, d, sk=None, seed=0):
    rng = np.random.default_rng(seed + 1000 * h + sq + d)
    sk = sk or sq
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, kvh, sk, d)).astype(np.float32),
            rng.normal(size=(b, kvh, sk, d)).astype(np.float32))


def _both(arrs, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol * 100, atol=tol * 10)


@pytest.mark.parametrize("b,h,kvh,s,d", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_mha_ref_matches_reference(b, h, kvh, s, d, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, h, kvh, s, d), dtype)
    want = r_mha_ref(jq, jk, jv, causal=causal)
    got = mha_ref(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("sq,sk", [(1, 128), (64, 256), (100, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_ref_kv_len_and_fewer_queries(sq, sk, causal):
    """Queries aligned to the last Sq keys, with and without a ragged
    ``kv_len`` (B,) of valid key prefixes."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(2, 4, 2, sq, 64, sk=sk),
                                       "float32")
    _close(mha_ref(tq, tk, tv, causal=causal),
           r_mha_ref(jq, jk, jv, causal=causal), "float32")
    kv_len = np.array([sk, max(sq, sk // 2 + 3)], np.int32)
    want = r_mha_ref(jq, jk, jv, causal=causal, kv_len=jnp.asarray(kv_len))
    got = mha_ref(tq, tk, tv, causal=causal,
                  kv_len=torch.from_numpy(kv_len))
    _close(got, want, "float32")


@pytest.mark.parametrize("b,h,kvh,s,d", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mha_matches_pallas_kernel_in_interpret_mode(b, h, kvh, s, d, dtype):
    """The port's public ``mha`` on CPU tensors (its plain version) against
    the reference's Pallas kernel, run in interpret mode."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, h, kvh, s, d), dtype)
    want = raops.mha(jq, jk, jv, causal=True, force_interpret=True)
    got = taops.mha(tq, tk, tv, causal=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("b,h,kvh,s,d", CASES)
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_causal_attention_matches_reference(b, h, kvh, s, d, chunk,
                                                    dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, h, kvh, s, d), dtype)
    scale = d ** -0.5
    want = r_chunked(jq, jk, jv, chunk, scale)
    got = chunked_causal_attention(tq, tk, tv, chunk, scale)
    _close(got, want, dtype)


def _grad_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), err


@pytest.mark.parametrize("b,h,kvh,s,d", CASES)
@pytest.mark.parametrize("path", ["mha", "chunked"])
def test_gradients_match_jax_grad(b, h, kvh, s, d, path):
    """dq, dk, dv from autograd of the port's plain versions (the CPU's
    path and the oracle of the backward kernel) against ``jax.grad`` of
    the reference's, float32, for a cotangent drawn from a seed."""
    arrs = _inputs(b, h, kvh, s, d, seed=7)
    dout = np.random.default_rng(11).normal(size=arrs[0].shape).astype(
        np.float32)
    scale = d ** -0.5
    if path == "mha":
        rf = lambda q, k, v: r_mha_ref(q, k, v, causal=True)
        tf = lambda q, k, v: taops.mha(q, k, v, causal=True)
    else:
        rf = lambda q, k, v: r_chunked(q, k, v, 64, scale)
        tf = lambda q, k, v: chunked_causal_attention(q, k, v, 64, scale)
    want = jax.grad(lambda q, k, v: jnp.sum(rf(q, k, v) * dout),
                    argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrs])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    got = torch.autograd.grad(tf(*ts), ts, torch.from_numpy(dout))
    _grad_close(got, want)


def test_lse_ref_is_the_softmax_normaliser():
    """``mha_lse_ref`` (what the forward kernel keeps for its backward):
    exp(scale q k^T - lse) sums to 1 over the live keys of each row."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 96, 32, sk=128))
    lse = mha_lse_ref(q, k, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q * 32 ** -0.5,
                     k.repeat_interleave(2, dim=1))
    live = (torch.arange(96)[:, None] + 32) >= torch.arange(128)[None, :]
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(1, 4, 96))


def test_kernel_refuses_shapes_before_building():
    """The wrapper's shape gate raises ``ValueError`` for what the kernel
    does not take, before any build (these run on any machine)."""
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    with pytest.raises(ValueError, match="multiple of 8"):
        taops.flash_forward(z(1, 2, 8, 12), z(1, 2, 8, 12), z(1, 2, 8, 12),
                            True, 1.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        taops.flash_forward(z(1, 2, 8, 264), z(1, 2, 8, 264),
                            z(1, 2, 8, 264), True, 1.0)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        taops.flash_forward(z(1, 2, 16, 64), z(1, 2, 8, 64), z(1, 2, 8, 64),
                            True, 1.0)
    with pytest.raises(ValueError, match="multiple of KVH"):
        taops.flash_forward(z(1, 3, 8, 64), z(1, 2, 8, 64), z(1, 2, 8, 64),
                            True, 1.0)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        taops.flash_forward(z(1, 2, 8, 64, dt=torch.float16),
                            z(1, 2, 8, 64, dt=torch.float16),
                            z(1, 2, 8, 64, dt=torch.float16), True, 1.0)
    with pytest.raises(ValueError, match="O in float32"):
        bf = z(1, 2, 8, 64, dt=torch.bfloat16)
        taops.flash_backward(bf, bf, bf, bf, z(1, 2, 8), bf, True, 1.0)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 72, "simt"), (torch.bfloat16, 136, "simt"),
    (torch.bfloat16, 256, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
    (torch.bfloat16, 12, None), (torch.float32, 100, None),
    (torch.bfloat16, 264, None), (torch.float32, 512, None),
    (torch.float16, 128, None)])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    """bfloat16 with D a multiple of 16 up to 128 goes to the tensor-core
    kernels, float32 and the other bfloat16 head dims up to 256 to the
    SIMT kernels; no route for D % 8, D > 256 or another dtype."""
    assert taops._route(dtype, d) == want


def test_cpu_calls_do_not_count_as_launches():
    counts = lambda: (taops.launches, taops.bwd_launches,
                      taops.wgmma_launches, taops.simt_launches,
                      taops.wgmma_bwd_launches, taops.simt_bwd_launches)
    before = counts()
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(1, 2, 1, 64, 32))
    taops.mha(q, k, v).sum().backward()
    assert counts() == before


def _bf16_case(s=1024, d=64):
    """Long-sequence bf16 inputs (GQA g = 2) and the float32 oracle's O and
    gradients on them."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(1, 4, 2, s, d, seed=7))
    dout = torch.from_numpy(_inputs(1, 4, 2, s, d, seed=8)[0]).bfloat16()
    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    o = mha_ref(qf, kf, vf)
    grads = torch.autograd.grad(o, (qf, kf, vf), dout.float())
    return (q, k, v), o.detach(), grads


def test_bf16_excess_passes_one_bf16_rounding():
    """The oracle's float32 outputs rounded once to bfloat16 (what a
    correct kernel writes) stay within the tolerance, as do float32 sums in
    another order."""
    (q, k, v), o, grads = _bf16_case()
    for want in (o, *grads):
        assert bf16_excess(want.bfloat16(), want) <= 1
        assert bf16_excess(want * (1 + 1e-6), want) <= 1


@pytest.mark.parametrize("fault", ["o_late_zero", "o_next_head_v",
                                   "dq_late_zero", "dk_late_zero",
                                   "dv_next_head"])
def test_bf16_excess_rejects_planted_faults(fault):
    """Faults a tolerance scaled by the global max would pass at long
    sequences: a late half of the rows zero, or a kv head read from its
    neighbour."""
    (q, k, v), o, (dq, dk, dv) = _bf16_case()
    s = q.shape[2]
    if fault == "o_late_zero":
        got, want = o.clone(), o
        got[:, :, s // 2:] = 0
    elif fault == "o_next_head_v":
        got, want = mha_ref(q, k, v.roll(-1, dims=1)), o
    elif fault == "dq_late_zero":
        got, want = dq.clone(), dq
        got[:, :, s // 2:] = 0
    elif fault == "dk_late_zero":
        got, want = dk.clone(), dk
        got[:, :, s // 2:] = 0
    else:
        got, want = dv.roll(-1, dims=1), dv
    assert bf16_excess(got.bfloat16(), want) > 1
